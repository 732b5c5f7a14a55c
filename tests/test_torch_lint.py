"""The port's lint (``repro_torch.analysis.lint``), lockset pass
(``analysis.locks``) and thread-access recorder (``analysis.recorder``),
on the CPU.

Pins: each committed fixture fires its rules at the expected lines;
``# repro: noqa-<rule>`` suppresses without hiding (the gate counts it);
the CLI's exit codes, ``--report-only``, ``--baseline``, ``--json`` and
the suppression budget; the committed baseline is empty and the port's
tree passes the gate (``--max-suppressions 0``); the port's lockset pass
returns the JAX package's violations, line for line, on the same sources
(the fixtures, the port's engine, the engine with a declaration removed,
with a guard swapped and with a write taken out of its lock); the
recorder flags only undeclared shared writes and restores the class; and
a trip function given a ``.item()`` is caught statically, the read the
audit fails at run time (``tests/test_torch_audit.py``).
"""
import json
import os
import subprocess
import sys
import threading

import pytest

from repro.analysis import locks as jlocks
from repro_torch.analysis import audit, lint, locks
from repro_torch.analysis.recorder import ThreadAccessRecorder
from test_torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.timeout(300)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
FIX = os.path.join(PKG, "analysis", "fixtures")
JFIX = os.path.join(ROOT, "src", "repro", "analysis", "fixtures")
ENGINE = os.path.join(PKG, "serve", "engine.py")
FRONTIER = os.path.join(PKG, "core", "frontier.py")
TRACE_UNSAFE = os.path.join(FIX, "trace_unsafe.py")
NOQA = os.path.join(FIX, "noqa_ok.py")


def _pairs(viols):
    return sorted((v.rule, v.line) for v in viols)


def _read(path):
    with open(path) as f:
        return f.read()


# ---------------------------------------------------------------------------
# fixtures fire their rules
# ---------------------------------------------------------------------------

def test_trace_unsafe_fixture_fires_every_trip_rule():
    v = lint.lint_file(TRACE_UNSAFE)
    assert not any(x.suppressed for x in v)
    assert _pairs(v) == sorted([
        ("prng-aliasing", 14),
        ("mutable-default", 17),
        ("traced-truthiness", 23),
        ("traced-cast", 25),
        ("traced-cast", 26),
        ("host-sync-in-trace", 27),
        ("time-in-trace", 28),
        ("traced-truthiness", 35),            # fused_trip: a trip by name
        ("host-sync-in-trace", 37),
        ("host-sync-in-trace", 38),
        ("host-sync-in-trace", 43),           # @torch.compile
        ("traced-cast", 49),                  # with torch.cuda.graph(...)
    ])
    assert set(RULE for RULE, _ in _pairs(v)) == set(lint.RULES) - {
        "kernel-assert", "lockset"}


def test_kernel_assert_fixture():
    v = lint.lint_file(os.path.join(FIX, "kernels", "bad_assert.py"))
    assert _pairs(v) == [("kernel-assert", 7)]


def test_locks_bad_fixture_flags_shared_attr_and_guard_escape():
    path = os.path.join(FIX, "locks_bad.py")
    v = locks.check_file(path)
    assert all(x.rule == "lockset" for x in v)
    shared = [x for x in v if "no GUARDED_BY entry" in x.msg]
    assert shared and all("_count" in x.msg for x in shared)
    escape = [x for x in v if "outside its declared guard" in x.msg]
    assert [x.line for x in escape] == [28]
    assert "self._lock" in escape[0].msg
    assert _pairs(lint.lint_file(path)) == _pairs(v)   # folded into lint


def test_noqa_suppression_counts_but_is_not_active():
    v = lint.lint_file(NOQA)
    assert [x.rule for x in v if x.suppressed] == ["prng-aliasing"]
    assert not [x for x in v if not x.suppressed]


def test_constant_seed_arithmetic_is_not_aliasing():
    src = ("import torch\n"
           "def f(seed):\n"
           "    a = torch.manual_seed(3 + 4)\n"
           "    b = torch.Generator().manual_seed(seed)\n"
           "    return torch.cuda.manual_seed(seed * 2), a, b\n")
    assert _pairs(lint.lint_source(src, "x.py")) == [("prng-aliasing", 5)]


# ---------------------------------------------------------------------------
# CLI gate semantics
# ---------------------------------------------------------------------------

def test_cli_fails_on_fixture_violations(capsys):
    assert lint.main([TRACE_UNSAFE]) == 1
    out = capsys.readouterr().out
    assert "[prng-aliasing]" in out and "12 violation(s)" in out


def test_cli_report_only_exits_zero(capsys):
    assert lint.main([TRACE_UNSAFE, "--report-only"]) == 0
    assert "[prng-aliasing]" in capsys.readouterr().out


def test_cli_suppression_budget(capsys):
    assert lint.main([NOQA]) == 0                       # suppressed: passes
    assert lint.main([NOQA, "--max-suppressions", "1"]) == 0
    assert lint.main([NOQA, "--max-suppressions", "0"]) == 1
    assert "suppression budget exceeded" in capsys.readouterr().out


def test_cli_baseline_and_json(tmp_path, capsys):
    base = tmp_path / "baseline.txt"
    base.write_text("# reviewed\nanalysis/fixtures/kernels/bad_assert.py:"
                    "kernel-assert\n")
    bad = os.path.join(FIX, "kernels", "bad_assert.py")
    assert lint.main([bad]) == 1
    capsys.readouterr()
    assert lint.main([bad, "--baseline", str(base), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["files"] == 1 and rep["violations"] == []
    assert [v["rule"] for v in rep["baselined"]] == ["kernel-assert"]


def test_port_tree_passes_the_gate(capsys):
    assert lint.main([PKG, "--max-suppressions", "0"]) == 0
    assert " 0 violation(s), 0 suppressed, 0 baselined" in \
        capsys.readouterr().out


def test_the_gate_command_exits_zero():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint",
         os.path.join("src", "repro_torch"), "--max-suppressions", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    assert " 0 violation(s), 0 suppressed" in out.stdout


def test_committed_baseline_is_empty():
    assert lint.DEFAULT_BASELINE == os.path.join(PKG, "analysis",
                                                 "lint_baseline.txt")
    assert lint.load_baseline(lint.DEFAULT_BASELINE) == set()


def test_fixture_tree_excluded_unless_opted_in():
    files = lint.iter_py_files([PKG])
    assert not any(os.sep + "fixtures" + os.sep in f for f in files)
    with_fix = lint.iter_py_files([PKG], include_fixtures=True)
    assert any(f.endswith("trace_unsafe.py") for f in with_fix)
    assert lint.main([PKG, "--include-fixtures", "--report-only"]) == 0


# ---------------------------------------------------------------------------
# traced functions: the static twin of the audit's rule
# ---------------------------------------------------------------------------

def test_trip_functions_are_the_audits():
    assert lint.TRIP_FUNCTIONS is audit.TRIP_FUNCTIONS
    assert set(audit.TRIP_FUNCTIONS) == {"fused_trip", "chain_trip"}


@pytest.mark.parametrize("trip,first_line", [
    ("fused_trip", "            revealed = st.cellvals < _REV_THRESH"),
    ("chain_trip", "        iv = get_intervals(st.n.reshape(Q, N), "
                   "st.total.reshape(Q, N),"),
])
def test_an_item_in_a_trip_is_caught(trip, first_line):
    src = _read(FRONTIER)
    assert not lint.lint_source(src, FRONTIER)
    assert first_line in src
    indent = first_line[:len(first_line) - len(first_line.lstrip())]
    bad = src.replace(first_line,
                      f"{indent}_ = st.rounds.sum().item()\n{first_line}", 1)
    line = bad.splitlines().index(f"{indent}_ = st.rounds.sum().item()") + 1
    v = lint.lint_source(bad, FRONTIER)
    assert _pairs(v) == [("traced-cast", line)]
    assert trip in v[0].msg


def test_a_host_read_outside_a_trip_is_not_flagged():
    src = _read(FRONTIER).replace(
        "        trips = 0\n",
        "        trips = 0\n        _ = state.rounds.sum().item()\n", 1)
    assert "state.rounds.sum().item()" in src
    assert lint.lint_source(src, FRONTIER) == []


# ---------------------------------------------------------------------------
# the lockset pass: the port's against the JAX package's
# ---------------------------------------------------------------------------

def _engine(edit):
    src = _read(ENGINE)
    if edit is None:
        return src
    old, new = edit
    assert old in src
    return src.replace(old, new)


LOCK_SOURCES = {
    "port fixture": lambda: _read(os.path.join(FIX, "locks_bad.py")),
    "jax fixture": lambda: _read(os.path.join(JFIX, "locks_bad.py")),
    "engine": lambda: _engine(None),
    "engine, declaration removed": lambda: _engine(
        ('"_thread_exc": "_done_cv",', "")),
    "engine, guard swapped": lambda: _engine(
        ('"_inflight": "_inflight_lock",', '"_inflight": "_completed_lock",')),
    "engine, write out of its lock": lambda: _engine(
        ("        with self._state_lock:\n"
         "            self._service_ema = (",
         "        if True:\n"
         "            self._service_ema = (")),
}


@pytest.mark.parametrize("name", list(LOCK_SOURCES))
def test_lockset_pass_matches_jax(name):
    src = LOCK_SOURCES[name]()
    got = [(v.line, v.rule, v.msg) for v in locks.check_source(src, "x.py")]
    want = [(v.line, v.rule, v.msg)
            for v in jlocks.check_source(src, "x.py")]
    assert got == want
    if name == "engine":
        assert got == []
    else:
        assert got


def test_engine_lockset_catches_each_edit():
    v = locks.check_source(LOCK_SOURCES["engine, declaration removed"](),
                           ENGINE)
    assert any("_thread_exc" in x.msg and "no GUARDED_BY entry" in x.msg
               for x in v), v
    v = locks.check_source(LOCK_SOURCES["engine, guard swapped"](), ENGINE)
    assert any("self._inflight written in" in x.msg
               and "self._completed_lock" in x.msg for x in v), v
    v = locks.check_source(LOCK_SOURCES["engine, write out of its lock"](),
                           ENGINE)
    assert any("self._service_ema written in" in x.msg
               and "self._state_lock" in x.msg for x in v), v


# ---------------------------------------------------------------------------
# the run-time recorder
# ---------------------------------------------------------------------------

class _Plain:
    def __init__(self):
        self.shared_undeclared = 0
        self.shared_declared = 0
        self.private = 0


def _hammer(obj, n_threads=4, n_iter=50):
    def work():
        for _ in range(n_iter):
            obj.shared_undeclared += 1
            obj.shared_declared += 1
    ts = [threading.Thread(target=work, name=f"w{i}")
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)


def test_recorder_flags_undeclared_shared_writes_only():
    obj = _Plain()
    with ThreadAccessRecorder(obj, declared={"shared_declared"}) as rec:
        _hammer(obj)
        obj.private += 1                       # the main thread only
    v = rec.violations()
    assert len(v) == 1 and v[0].startswith("shared_undeclared:")
    assert "no declared guard" in v[0]
    shared = rec.shared()
    assert "shared_declared" in shared         # observed, and declared
    assert "private" not in shared             # one thread: not shared


def test_recorder_uninstall_restores_class():
    obj = _Plain()
    cls = type(obj)
    rec = ThreadAccessRecorder(obj).install()
    assert type(obj) is not cls and isinstance(obj, cls)
    obj.private = 5
    rec.uninstall()
    assert type(obj) is cls and obj.private == 5
    before = dict(rec.writes)
    obj.private = 6                            # uninstrumented: unrecorded
    assert rec.writes == before
