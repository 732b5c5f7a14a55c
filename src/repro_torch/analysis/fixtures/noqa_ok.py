"""Suppression fixture: the one violation here carries a
``# repro: noqa-<rule>`` marker, so the lint reports it as suppressed
(not active), the mechanism the tests pin."""
import torch


def suppressed_seed(seed: int):
    return torch.Generator().manual_seed(seed + 1)  # repro: noqa-prng-aliasing
