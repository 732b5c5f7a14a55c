"""Checkpointing: save / restore of a training state and an async writer
(port of ``repro.ckpt.checkpoint``, the same on-disk format).

A checkpoint is a directory ``step_%08d/`` holding ``shard0.npz`` (leaf
name -> array) and ``meta.json``; it is written under ``.tmp`` and
published with ``os.replace``. Leaf names are the port's own: a module's
parameter names, and for a ``NamedTuple`` state each other field under its
name (``TrainState``: the parameter names, ``opt.step``, ``opt.m.<name>``,
``opt.v.<name>``; a ``CompressedTrainState`` adds ``error.<name>``).
numpy has no bfloat16, so a bf16 leaf is stored as its int16 bits and
``meta.json`` records its dtype under ``dtypes``; it restores bit for bit.

``restore_checkpoint`` writes the arrays into the tensors of an example
state of the same structure (in place, on the example's devices, in its
dtypes) and returns it: a missing leaf raises ``KeyError``, a shape that
differs ``ValueError``, before anything is written. ``load_arrays`` reads
a checkpoint's arrays as they are (a JAX package checkpoint too, whose
names are JAX key paths; ``models.convert.tree_from_keystr`` nests them).

``AsyncCheckpointer.save`` copies the state to host memory on the
caller's thread (a copy even on the CPU, where ``Tensor.numpy()`` would
share the memory an in-place optimizer step overwrites next) and writes
it on a background thread, keeping the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_CKPT_RE = re.compile(r"^step_(\d+)$")
# dtypes numpy lacks: stored as the bits of a same-width integer
_BITS = {torch.bfloat16: (torch.int16, "bfloat16")}
_FROM_BITS = {name: dt for dt, (_, name) in _BITS.items()}


def state_leaves(state: Any, prefix: str = "") -> Iterator[Tuple[str,
                                                                  torch.Tensor]]:
    """(name, tensor) of every leaf of a state, in a fixed order."""
    if isinstance(state, torch.Tensor):
        yield prefix[:-1], state
    elif isinstance(state, nn.Module):
        for name, p in state.named_parameters():
            yield prefix + name, p
    elif hasattr(state, "_fields"):                 # NamedTuple
        for f in state._fields:
            sub = prefix if f == "params" else f"{prefix}{f}."
            yield from state_leaves(getattr(state, f), sub)
    elif isinstance(state, Mapping):
        for k, v in state.items():
            yield from state_leaves(v, f"{prefix}{k}.")
    else:
        raise TypeError(f"{prefix or 'state'}: cannot checkpoint a "
                        f"{type(state).__name__}")


def snapshot(state: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host copies of the state's leaves (never views of its memory) and
    the dtypes stored as integer bits."""
    arrays, dtypes = {}, {}
    with torch.no_grad():
        for name, t in state_leaves(state):
            t = t.detach()
            if t.dtype in _BITS:
                bits, dtypes[name] = _BITS[t.dtype]
                t = t.view(bits)
            arrays[name] = t.to("cpu", copy=True).numpy()
    return arrays, dtypes


def _write(root: str, step: int, arrays: Dict[str, np.ndarray],
           dtypes: Dict[str, str], extra: Optional[dict]) -> str:
    d = os.path.join(root, f"step_{step:08d}")
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard0.npz"), **arrays)
    meta = {"step": step, "time": time.time(), "extra": extra or {},
            "n_leaves": len(arrays), "dtypes": dtypes}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    os.replace(tmp, d)            # atomic publish
    return d


def save_checkpoint(root: str, step: int, state: Any,
                    extra: Optional[dict] = None) -> str:
    """Synchronous save. Returns the checkpoint directory."""
    arrays, dtypes = snapshot(state)
    return _write(root, step, arrays, dtypes, extra)


def latest_checkpoint(root: str) -> Optional[Tuple[int, str]]:
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        m = _CKPT_RE.match(name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[0]:
                best = (step, os.path.join(root, name))
    return best


def load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """A checkpoint's arrays by leaf name and its meta."""
    with np.load(os.path.join(path, "shard0.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return arrays, meta


def restore_checkpoint(path: str, example: Any) -> Tuple[Any, dict]:
    """Restore into ``example`` (same structure and shapes), in place."""
    arrays, meta = load_arrays(path)
    dtypes = meta.get("dtypes", {})
    leaves = list(state_leaves(example))
    for name, t in leaves:
        if name not in arrays:
            raise KeyError(f"checkpoint missing leaf {name}")
        if tuple(arrays[name].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {name}: "
                             f"{arrays[name].shape} vs {tuple(t.shape)}")
    with torch.no_grad():
        for name, t in leaves:
            src = torch.from_numpy(arrays[name])
            if name in dtypes:
                src = src.view(_FROM_BITS[dtypes[name]])
            t.copy_(src.to(device=t.device, dtype=t.dtype))
    return example, meta


class AsyncCheckpointer:
    """Snapshot-on-call, write-on-thread checkpointer."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        self.wait()
        # the device -> host copy happens here, on the caller's thread
        arrays, dtypes = snapshot(state)

        def work():
            try:
                _write(self.root, step, arrays, dtypes, extra)
                self._gc()
            except BaseException as e:      # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        if not os.path.isdir(self.root):
            return
        steps = sorted(int(m.group(1)) for n in os.listdir(self.root)
                       if (m := _CKPT_RE.match(n)))
        for s in steps[:-self.keep]:
            d = os.path.join(self.root, f"step_{s:08d}")
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
            os.rmdir(d)
