"""What is read from a device trace, on a hand-made one: busy time, idle
gaps named by the host spans open at their middle, device time by kernel;
and the readers that take spans and the profiler's on-period."""
import pytest

from perfbench.harness import spec
from perfbench.harness.client import Record
from perfbench.harness.context import Run
from perfbench.harness.trace import DeviceOp, Trace

MS = 1_000_000


def _trace():
    ops = [DeviceOp("reveal_kernel<DenseRows>", 0 * MS, 2 * MS),
           DeviceOp("reveal_kernel<DenseRows>", 1 * MS, 3 * MS),
           DeviceOp("gemm", 5 * MS, 9 * MS),
           DeviceOp("topk", 9 * MS, 10 * MS),
           DeviceOp("late", 12 * MS, 30 * MS)]
    spans = [("step", 7, 0, 4 * MS, 0, ()),
             ("stage1", 8, 4 * MS, 11 * MS, 16, ()),
             ("stage1", 7, 4 * MS, 11 * MS, 99, ()),      # another thread
             ("harvest", 7, 11 * MS, 12 * MS, 0, ())]
    return Trace(t0=0, t1=20 * MS, ops=ops, spans=spans)


def test_busy_and_idle():
    tr = _trace()
    assert tr.busy() == [(0, 3 * MS), (5 * MS, 10 * MS), (12 * MS, 20 * MS)]
    assert tr.busy_s == pytest.approx(0.016)
    assert tr.window_s == pytest.approx(0.020)
    gaps = tr.idle_gaps()
    assert gaps == [["stage1", pytest.approx(0.002)],
                    ["harvest", pytest.approx(0.002)]]


def test_top_ops():
    tr = _trace()
    top = tr.top_ops()
    assert top[0] == ["late", pytest.approx(0.008)]   # clipped at t1
    assert ["gemm", pytest.approx(0.004)] in top


def _run(records, spans=(), profiled=None):
    return Run(cell=None, seed=0, seconds=1.0, setup_s=0.0, t0=0.0,
               t_end=1.0, records=list(records), batches=[], n_served=0,
               launches={}, trace=None, memory_peak_bytes=0, inputs=None,
               spans=list(spans), profiled=profiled)


def test_stage1_wall_per_query():
    read = spec.reader("stage1_ms_per_query.p95").read
    assert read(_run([], _trace().spans)) == pytest.approx(7.0 * 2 / 115)
    assert read(_run([])) is None


def test_latency_leaves_out_the_profiled_requests():
    recs = []
    for i in range(100):
        r = Record(i=i, intended=i * 0.01, done=i * 0.01 + 0.001,
                   completion=object())
        if 40 <= i < 60:
            r.done += 5.0                       # stalled by the profiler
        recs.append(r)
    read = spec.reader("latency_p95_ms.qps").read
    assert read(_run(recs, profiled=(0.395, 0.595))) == pytest.approx(1.0)
    assert read(_run(recs)) > 1000


def _steps_trace(lost):
    """Three steps of two requests each; the profile opens at 10 ms and
    closes at 400 ms. Each step launches one reveal kernel and one other
    kernel; step 2's reveal kernel runs after the step has returned."""
    spans = [("step", 7, 0, 50 * MS, 0, (0, 1)),           # before the profile
             ("step", 7, 60 * MS, 120 * MS, 0, (2, 3)),
             ("harvest", 7, 120 * MS, 125 * MS, 0, ()),
             ("step", 7, 130 * MS, 200 * MS, 0, (4, 5)),
             ("step", 7, 300 * MS, 380 * MS, 0, (6, 7))]   # closes too late
    ops = [DeviceOp("reveal_kernel<A>", 70 * MS, 74 * MS, 65 * MS),
           DeviceOp("topk", 75 * MS, 80 * MS, 66 * MS),
           DeviceOp("reveal_kernel<A>", 201 * MS, 203 * MS, 199 * MS),
           DeviceOp("reveal_kernel<A>", 310 * MS, 311 * MS, 305 * MS),
           DeviceOp("reveal_kernel<A>", 0, 1 * MS, None)]   # untied record
    return Trace(t0=20 * MS, t1=400 * MS, ops=ops, spans=spans, on=10 * MS,
                 launches=6, lost=lost)


def test_whole_steps_and_their_kernels():
    tr = _steps_trace(lost=[])
    steps = tr.whole_steps()
    assert [sp[5] for sp in steps] == [(2, 3), (4, 5)]
    assert tr.step_kernel_s(steps[0], "reveal_kernel") == \
        pytest.approx(0.004)
    assert tr.step_kernel_s(steps[1], "reveal_kernel") == \
        pytest.approx(0.002)
    # A step with a lost launch is left out; a trace that cannot tie
    # records to launches has no whole step.
    assert [sp[5] for sp in _steps_trace([150 * MS]).whole_steps()] == \
        [(2, 3)]
    assert _steps_trace(None).whole_steps() == []


def test_roofline_takes_the_work_of_the_traced_steps(monkeypatch):
    from perfbench.harness import readers
    from perfbench.reference import roofline

    class C:
        def __init__(self, rid):
            self.rid = rid

    recs = [Record(i=i, intended=0.0, done=0.1, completion=C(i))
            for i in range(8)]
    run = _run(recs)
    run.trace = _steps_trace(lost=[])
    # Each request needs 1 ms of the bound, whatever it is.
    monkeypatch.setattr(readers, "_request_work",
                        lambda run, r, kind: (roofline.PEAK_BYTES_S * 1e-3,
                                              0.0))
    # Steps (2, 3) and (4, 5): 4 ms of bound over 6 ms of their kernels.
    assert readers.kernel_roofline_pct(run, "reveal", "reveal_kernel") == \
        pytest.approx(100 * 4 / 6)
    # A step with a request from before the window is left out.
    run.records = recs[3:]
    assert readers.kernel_roofline_pct(run, "reveal", "reveal_kernel") == \
        pytest.approx(100 * 2 / 2)
