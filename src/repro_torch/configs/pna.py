"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].

4 layers, d_hidden=75, aggregators mean/max/min/std, scalers id/amp/atten.
"""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="pna",
    n_layers=4,
    d_hidden=75,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"),
)
