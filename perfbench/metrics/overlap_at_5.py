"""overlap_at_5 (frac, host_clock): mean overlap@5 of the checked answers
with the exhaustive-MaxSim top-5 over the same candidates (the reference
check's sample, drawn from the seed)."""


def read(run):
    return None if run.check is None else run.check.get("overlap")
