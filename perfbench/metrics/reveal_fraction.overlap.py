"""reveal_fraction.overlap (frac, program_counter; layer: pooled bandit):
mean ``Completion.reveal_fraction``, the share of candidate MaxSim cells
the bandit computed, over the window's answers. The bandit's stopping rule
trades these reveals against fidelity, so it moves overlap_at_5."""
from perfbench.harness.readers import reveal_fraction


def read(run):
    return reveal_fraction(run)
