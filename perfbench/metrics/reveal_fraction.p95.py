"""reveal_fraction (frac, program_counter; layer: pooled bandit): mean
``Completion.reveal_fraction``, the share of candidate MaxSim cells the
bandit computed, over the window's answers."""
from perfbench.harness.readers import reveal_fraction


def read(run):
    return reveal_fraction(run)
