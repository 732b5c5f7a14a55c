"""stage1_ms_per_query.p95 (ms, program_span; layer: stage 1): wall time
of the engine's stage-1 calls (host spans the benchmark opens around
``_stage1``, which returns the candidates on the host) over the queries
they served, in the window."""


def read(run):
    spans = [sp for sp in run.spans if sp[0] == "stage1"]
    queries = sum(sp[4] for sp in spans)
    if not queries:
        return None
    return sum(sp[3] - sp[2] for sp in spans) / 1e6 / queries
