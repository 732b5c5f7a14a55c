"""The port's checkpoints, trainer and crash-safe resume, on the CPU.

``ckpt/checkpoint.py``: f32 and bf16 round trips bit for bit (bf16 kept as
its int16 bits, the dtype in ``meta.json``), ``latest_checkpoint`` and the
async writer's garbage collection, the missing-leaf and shape errors, an
async snapshot unchanged by an in-place update made after ``save``, and a
checkpoint the JAX package wrote restored through
``convert.tree_from_keystr`` / ``train_state_from_jax``.
``train/trainer.py`` with ``dist/fault.py::simulate_failure``: a run
crashed at step 7 and resumed from the step-5 checkpoint ends on the
uninterrupted run's parameters and moments bit for bit (JAX's own test,
``tests/test_train_ckpt_fault.py``, on the port).
"""
import importlib.util
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs.base import LMConfig as JLMConfig
from repro.models.transformer import init_lm as jinit_lm
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch.ckpt import checkpoint as C
from repro_torch.ckpt.checkpoint import (AsyncCheckpointer,
                                         latest_checkpoint, load_arrays,
                                         restore_checkpoint, save_checkpoint,
                                         state_leaves)
from repro_torch.configs.base import LMConfig
from repro_torch.dist.fault import SimulatedFailure, simulate_failure
from repro_torch.models.convert import train_state_from_jax, \
    tree_from_keystr
from repro_torch.models.transformer import init_lm
from repro_torch.train.optimizer import adamw, cosine_schedule
from repro_torch.train.train_step import init_train_state, \
    make_lm_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_threads import cap_torch_threads

cap_torch_threads()

SPEC = dict(name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
            d_head=16, d_ff=64, vocab=128)
CFG = LMConfig(**SPEC)


def _batch_fn(step: int):
    rng = np.random.default_rng([123, step])
    toks = rng.integers(0, CFG.vocab, (4, 16)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _state(seed=0, dtype=torch.float32, cfg=CFG):
    opt = adamw(cosine_schedule(1e-3, 2, 12))
    return init_train_state(init_lm(cfg, seed=seed, dtype=dtype,
                                    device="cpu"), opt), opt


def _leaves(state):
    return {k: t.detach().clone() for k, t in state_leaves(state)}


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def _stepped(dtype):
    """A state after one step, so the moments and step are not zeros."""
    state, opt = _state(dtype=dtype)
    state, _ = make_lm_train_step(CFG, opt)(state, _batch_fn(0))
    return state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roundtrip_is_bitwise(tmp_path, dtype):
    state = _stepped(dtype)
    d = save_checkpoint(str(tmp_path), 7, state, extra={"note": "x"})
    assert os.path.basename(d) == "step_00000007"
    assert not os.path.exists(d + ".tmp")
    names = [k for k, _ in state_leaves(state)]
    assert "opt.step" in names and "opt.m.embed" in names \
        and "opt.v.blocks.1.mlp.w_down" in names and "embed" in names
    fresh, _ = _state(seed=5, dtype=dtype)
    restored, meta = restore_checkpoint(d, fresh)
    assert restored is fresh and meta["step"] == 7
    assert meta["extra"] == {"note": "x"}
    assert meta["n_leaves"] == len(names)
    with open(os.path.join(d, "meta.json")) as f:
        dtypes = json.load(f)["dtypes"]
    if dtype == torch.bfloat16:
        assert dtypes["embed"] == "bfloat16" and "opt.m.embed" not in dtypes
    else:
        assert dtypes == {}
    _assert_bitwise(_leaves(state), _leaves(restored))
    assert int(restored.opt.step) == 1


def test_latest_checkpoint_and_gc(tmp_path):
    state, _ = _state()
    assert latest_checkpoint(str(tmp_path / "none")) is None
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        ck.save(s, state)
        ck.wait()
    assert latest_checkpoint(str(tmp_path)) == (
        30, os.path.join(str(tmp_path), "step_00000030"))
    assert sorted(os.listdir(tmp_path)) == ["step_00000020",
                                            "step_00000030"]


def test_missing_leaf_and_shape_mismatch_raise(tmp_path):
    state, _ = _state()
    d = save_checkpoint(str(tmp_path), 1, state)
    wider, _ = _state(cfg=LMConfig(**dict(SPEC, d_ff=96)))
    before = _leaves(wider)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, wider)
    _assert_bitwise(before, _leaves(wider))           # nothing written
    biased, _ = _state(cfg=LMConfig(**dict(SPEC, qkv_bias=True)))
    with pytest.raises(KeyError, match="blocks.0.attn.bq"):
        restore_checkpoint(d, biased)


def test_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """The writer thread writes what the state held at ``save``, though
    the state is updated in place before the thread gets to write."""
    state, opt = _state()
    want = _leaves(state)
    go = threading.Event()
    write = C._write

    def held_write(*a, **kw):
        go.wait(10)
        return write(*a, **kw)
    monkeypatch.setattr(C, "_write", held_write)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, state)
    make_lm_train_step(CFG, opt)(state, _batch_fn(0))   # in place
    with torch.no_grad():
        state.params.embed.add_(1.0)
    go.set()
    ck.wait()
    fresh, _ = _state(seed=9)
    restore_checkpoint(os.path.join(str(tmp_path), "step_00000001"), fresh)
    _assert_bitwise(want, _leaves(fresh))


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_restart_is_bitwise_identical(tmp_path, async_ckpt):
    """Crash at step 7, restart from the step-5 checkpoint, land on the
    uninterrupted run's parameters and moments bit for bit."""
    def build(ckpt_dir):
        state, opt = _state()
        return Trainer(make_lm_train_step(CFG, opt), _batch_fn, state,
                       TrainerConfig(total_steps=12, ckpt_every=5,
                                     ckpt_dir=ckpt_dir, log_every=100,
                                     async_ckpt=async_ckpt))

    ref = build(None).run()
    d = str(tmp_path / "ck")
    tr = build(d)
    assert simulate_failure(lambda guard: tr.run(guard), fail_at_step=7)
    if tr.ckpt:
        tr.ckpt.wait()
    tr2 = build(d)
    tr2.maybe_restore()
    assert tr2.start_step == 5
    out = tr2.run()
    _assert_bitwise(_leaves(ref), _leaves(out))
    assert int(out.opt.step) == 12
    assert latest_checkpoint(d)[0] == 10


def test_simulate_failure_guard():
    """The guard fires once, at the step; another error passes through."""
    seen = []

    def run(guard):
        for s in range(5):
            guard(s)
            seen.append(s)
    assert simulate_failure(run, 3) and seen == [0, 1, 2]
    assert not simulate_failure(run, 9)

    def broken(guard):
        raise RuntimeError("not a simulated failure")
    with pytest.raises(RuntimeError, match="not a simulated"):
        simulate_failure(broken, 0)
    assert issubclass(SimulatedFailure, RuntimeError)


def test_jax_checkpoint_restores_through_the_conversion(tmp_path):
    """A TrainState the JAX package trained 2 steps and saved with its own
    ``save_checkpoint`` loads by JAX key path and converts to the port's
    state: every leaf equal to JAX's, then saved and restored by the port
    bit for bit."""
    jcfg = JLMConfig(**SPEC)
    jopt = JO.adamw(1e-3)
    params = jinit_lm(jax.random.key(0), jcfg)
    jstate = JT.TrainState(params, jopt.init(params))
    step = jax.jit(JT.make_lm_train_step(jcfg, jopt))
    for i in range(2):
        b = _batch_fn(i)
        jstate, _ = step(jstate, {k: jnp.asarray(v, jnp.int32)
                                  for k, v in b.items()})
    d = jsave_checkpoint(str(tmp_path / "jax"), 2,
                         jax.tree.map(np.asarray, jstate))
    arrays, meta = load_arrays(d)
    assert meta["step"] == 2 and ".opt.step" in arrays
    state = train_state_from_jax(tree_from_keystr(arrays), CFG, device="cpu")
    assert int(state.opt.step) == 2
    direct = train_state_from_jax(jax.tree.map(np.asarray, jstate), CFG,
                                  device="cpu")
    _assert_bitwise(_leaves(direct), _leaves(state))
    d2 = save_checkpoint(str(tmp_path / "port"), 2, state)
    fresh, _ = _state(seed=3)
    restore_checkpoint(d2, fresh)
    _assert_bitwise(_leaves(state), _leaves(fresh))


def test_train_example_resumes_on_a_second_run(tmp_path, capsys):
    """``examples/torch_train_lm_small.py`` at ``--device cpu``: 3 steps
    with a checkpoint every 2, then a second run to 4 steps resumes from
    step 2 and replays step 3 with the first run's loss exactly."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_train_lm_small.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm_small",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = ["--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    first = mod.main(args + ["--steps", "3"])
    assert first.start_step == 0 and latest_checkpoint(str(tmp_path))[0] == 2
    second = mod.main(args + ["--steps", "4"])
    assert second.start_step == 2
    assert "resumed from" in capsys.readouterr().out
    assert int(second.state.opt.step) == 4
    assert latest_checkpoint(str(tmp_path))[0] == 4
    assert [m["step"] for m in first.metrics_log] == [1, 2, 3]
    assert [m["step"] for m in second.metrics_log] == [3, 4]
    assert first.metrics_log[2]["loss"] == second.metrics_log[0]["loss"]
    losses = [m["loss"] for m in first.metrics_log + second.metrics_log]
    assert np.isfinite(losses).all()
