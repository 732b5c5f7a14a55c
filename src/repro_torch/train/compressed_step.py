"""Data-parallel LM train step with an int8-compressed gradient
all-reduce (port of ``repro.train.compressed_step``).

Pure data parallelism over every axis of a ``dist.mesh.Mesh``: the
parameters are replicated (one copy, on the model's device, serves every
shard of a one-card mesh), the batch is split in contiguous row blocks,
shard d taking rows [d B / S, (d + 1) B / S) (JAX's ``P(every, None)``).
Each shard computes its own loss and gradients; the loss is their mean
(``pmean``), the gradients go through ``int8_rs_ag`` with error feedback
(or a mean when ``compress=False``), and one AdamW update follows.

The quantization scale is shared over a leaf, and JAX's leaves are its
parameter tree's: a layer weight is one leaf stacked over the layers of
its scan (``all``, or gemma2's ``local`` / ``global``). So the step
compresses each such group of the port's per-layer parameters as one
stacked leaf (``jax_leaf_groups``), and the error buffer follows.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.train.compression import init_error_buffer, int8_rs_ag
from repro_torch.train.optimizer import AdamW, AdamWState
from repro_torch.train.train_step import (Batch, Metrics, lm_loss,
                                          named_params, value_and_grad)

Params = Dict[str, torch.Tensor]


class CompressedTrainState(NamedTuple):
    params: nn.Module
    opt: AdamWState
    error: Params          # error-feedback buffers (float32, param-shaped)


def init_compressed_state(params: nn.Module,
                          opt: AdamW) -> CompressedTrainState:
    p = named_params(params)
    return CompressedTrainState(params=params, opt=opt.init(p),
                                error=init_error_buffer(p))


def jax_leaf_groups(cfg: LMConfig, names: Sequence[str]
                    ) -> Dict[str, List[str]]:
    """JAX leaf -> the port's parameter names it stacks, in layer order:
    ``blocks.<i>.<rest>`` goes to ``all.<rest>`` (gemma2: ``local.<rest>``
    for even i, ``global.<rest>`` for odd i); any other name is a leaf of
    its own."""
    groups: Dict[str, List[str]] = {}
    for name in names:
        m = re.fullmatch(r"blocks\.(\d+)\.(.+)", name)
        if m is None:
            groups[name] = [name]
            continue
        i, rest = int(m.group(1)), m.group(2)
        stack = "all"
        if cfg.local_global_alternating:
            stack = "local" if i % 2 == 0 else "global"
        groups.setdefault(f"{stack}.{rest}", []).append(name)
    return groups


def _stack(tree: Params, groups: Dict[str, List[str]]) -> Params:
    return {k: torch.stack([tree[n] for n in ns]) if k not in ns
            else tree[k] for k, ns in groups.items()}


def _unstack(tree: Params, groups: Dict[str, List[str]]) -> Params:
    out = {}
    for k, ns in groups.items():
        if k in ns:
            out[k] = tree[k]
        else:
            out.update(zip(ns, tree[k].unbind(0)))
    return out


def make_compressed_lm_train_step(cfg: LMConfig, opt: AdamW, mesh, *,
                                  chunk_tokens: int = 8192,
                                  compress: bool = True) -> Callable:
    """step(state, {"tokens", "targets"}) -> (state, metrics)."""
    n = mesh.size

    def step(state: CompressedTrainState, batch: Batch
             ) -> Tuple[CompressedTrainState, Metrics]:
        model = state.params
        if any(d != model.device for d in mesh.devices):
            raise ValueError("the replicated parameters live on "
                             f"{model.device}; every shard of the mesh must "
                             "sit there")
        tokens = torch.as_tensor(batch["tokens"], device=model.device)
        targets = torch.as_tensor(batch["targets"], device=model.device)
        B = tokens.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split over {n} shards")
        rows = B // n
        losses, grads = [], []
        for d in range(n):
            sl = slice(d * rows, (d + 1) * rows)
            loss, g = value_and_grad(
                lambda: lm_loss(model, cfg, tokens[sl], targets[sl],
                                chunk_tokens=chunk_tokens, remat=True),
                model)
            losses.append(loss)
            grads.append(g)
        loss = torch.stack(losses).sum() / n                  # pmean
        if compress:
            # Every shard starts from the state's one error buffer, as in
            # JAX (replicated in_specs). Each shard's residual differs;
            # JAX's out_specs=P() returns the first device's, so the port
            # keeps shard 0's.
            groups = jax_leaf_groups(cfg, list(grads[0]))
            outs, errs = int8_rs_ag([_stack(g, groups) for g in grads],
                                    [_stack(state.error, groups)] * n, mesh)
            g0 = _unstack(outs[0], groups)
            new_error = _unstack(errs[0], groups)
        else:
            g0 = {k: torch.stack([g[k] for g in grads]).sum(0) / n
                  for k in grads[0]}                           # pmean
            new_error = state.error
        del grads
        _, new_opt, gnorm = opt.update(g0, state.opt, named_params(model))
        return (CompressedTrainState(model, new_opt, new_error),
                {"loss": loss, "grad_norm": gnorm})

    return step
