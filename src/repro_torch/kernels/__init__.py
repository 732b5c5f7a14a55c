"""MaxSim kernels of the serving path: hand-written CUDA for Hopper
(``csrc/``), each beside its plain PyTorch version."""
from repro_torch.kernels.ops import (fused_reveal_op, gather_maxsim_op,
                                     maxsim_batch_op, maxsim_op)

__all__ = ["maxsim_op", "maxsim_batch_op", "gather_maxsim_op",
           "fused_reveal_op"]
