"""idle_in_engine_pct.qps (%, device_trace; layer: engine): 100 x the
device-idle time of the traced sub-window during which some batch had its
``admit``, ``step``, ``harvest`` or ``deliver`` span open (the program's
own spans, ``BatchRecord.span``, on the trace's clock), over the
sub-window. The rest of ``idle_share.qps`` falls where no batch was in the
engine's hands: the client, the collector, the interpreter. Moves qps."""
from perfbench.harness import program_spans as ps

ENGINE = ("admit", "step", "harvest", "deliver")


def read(run):
    tr = run.trace
    recs = ps.recorded(run)
    if tr is None or tr.t1 <= tr.t0 or not recs:
        return None
    held = ps.merged((sp[1], sp[2]) for b in recs for name in ENGINE
                     if (sp := b.span(name)) is not None)
    idle = ps.gaps(tr.busy(), tr.t0, tr.t1)
    return 100.0 * ps.overlap_ns(idle, held) / (tr.t1 - tr.t0)
