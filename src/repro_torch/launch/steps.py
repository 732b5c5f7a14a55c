"""Per-(arch x shape) cell programs for the launcher's account (port of
``repro.launch.steps``).

``build_cell(arch, shape_name, mesh)`` returns a :class:`CellProgram`:

  * the step callable (train step / prefill / decode / scoring), the
    port's own entry points, bound to ``mesh``;
  * the abstract arguments: modules and tensors on the ``meta`` device, at
    the cell's global shapes (nothing allocated, no card touched);
  * the per-leaf specs of the arguments and of the declared outputs
    (``dist/sharding.py`` rules; a module's specs are a name -> spec dict);
  * JAX's analytic ``model_flops`` (6·N·D train / 2·N·D forward, attention
    added, MoE at active parameters), kept verbatim even where it differs
    from what the port runs;
  * what the account counts: ``count`` (run once on ``meta`` under
    ``analysis/accounting.py::count_step``) with the number of devices its
    work spreads over; or, where the step cannot run on ``meta`` (the
    retrieval cells: their kernel dispatch takes CPU or CUDA operands
    only), ``reckoned_work``: the kernel's work per device from a formula,
    which the record files under ``reckoned``, not ``counted``;
  * ``collectives``: the reckoned traffic (the formulas are in
    ``analysis/accounting.py``'s docstring).

A step that loops over the shards itself (``pna_loss_sharded``) is counted
through one shard's program instead (:func:`pna_shard_step`), the program
one device runs; 256 shards of Python on ``meta`` would be slow. The cells
keep JAX's paddings: PNA's nodes and edges to a multiple of the devices
(edges with JAX's 1.25 slack for the range skew of the dst partition), the
recsys candidates and the retrieval corpus.

Recsys lookups reckoned per device (B_loc = B / the FSDP group, N_loc =
N / every device, S the history length, F the fields): FM B_loc·F rows of
the table and of ``linear``, AutoInt B_loc·F, DIN and SASRec B_loc·(S + 1)
item rows (SASRec also S position rows); ``retrieval_cand``: the context
(F - 1 rows, or the S history rows) and N_loc candidate rows (FM also
N_loc ``linear`` rows).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.analysis import accounting as A
from repro_torch.analysis.audit import scorecard_budget_bytes
from repro_torch.configs import get_config
from repro_torch.configs.base import (GNNConfig, LMConfig, RecsysConfig,
                                      RetrievalConfig, ShapeSpec)
from repro_torch.dist import flash_decode as FD
from repro_torch.dist import sharding as SH
from repro_torch.dist.act_sharding import fitted_spec
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models.kv_cache import CacheStack
from repro_torch.models.transformer import (DecoderLM, forward_prefill,
                                            init_cache)
from repro_torch.serve.lm import serve_step
from repro_torch.train.optimizer import AdamWState, adamw, cosine_schedule
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_lm_train_step,
                                          make_recsys_train_step,
                                          named_params,
                                          recsys_score_candidates,
                                          recsys_serve, value_and_grad)

META = torch.device("meta")
TOPK = 10


class CellProgram(NamedTuple):
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]            # modules and tensors on meta
    in_specs: Tuple[Any, ...]        # the args' structure, a spec per leaf
    outs: Any                        # the declared outputs, on meta
    out_specs: Any
    model_flops: float
    note: str = ""
    donate_argnums: Tuple[int, ...] = ()
    count: Optional[Callable[[], Any]] = None
    count_devices: int = 1           # devices the counted work spreads over
    count_how: str = ""
    reckoned_work: Optional[Dict[str, Any]] = None
    collectives: Tuple[A.Collective, ...] = ()


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _pad_mult(n: int, m: int) -> int:
    return -(-n // m) * m


def _n_devices(mesh) -> int:
    return math.prod(int(v) for v in mesh.shape.values())


def _group(mesh, axes) -> int:
    return math.prod(int(mesh.shape[a]) for a in axes)


def _dp_total(mesh) -> int:
    return _group(mesh, SH.fsdp_axes(mesh))


def _entry(axes: Tuple[str, ...]):
    """A spec entry for an axis group (JAX's canonical form)."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def _leaves(model, specs):
    return [(p.shape, p.dtype, specs[n]) for n, p in model.named_parameters()]


def _metrics():
    return ({"loss": _empty((), torch.float32),
             "grad_norm": _empty((), torch.float32)},
            {"loss": (), "grad_norm": ()})


def _train_state(params, specs, opt_specs, opt):
    state = init_train_state(params, opt)
    return state, TrainState(params=specs, opt=AdamWState(
        step=(), m=opt_specs, v=opt_specs))


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (the JAX package's, verbatim)
# ---------------------------------------------------------------------------

def lm_model_flops(cfg: LMConfig, shape: ShapeSpec) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        # + attention quadratic term (per layer 2*2*S^2*q_dim, window-capped)
        attn = 0.0
        for _, (n_l, s_att) in _stack_windows(cfg, shape.seq_len).items():
            attn += (shape.global_batch * n_l
                     * 2 * 2 * shape.seq_len * min(s_att, shape.seq_len)
                     * cfg.q_dim * 0.5)
        return 2.0 * n_active * tokens + attn
    # decode: one token per sequence + attention over the cache
    attn = 0.0
    for _, (n_l, s_att) in _stack_windows(cfg, shape.seq_len).items():
        attn += (shape.global_batch * n_l * 2 * 2
                 * min(s_att, shape.seq_len) * cfg.q_dim)
    return 2.0 * n_active * shape.global_batch + attn


def _stack_windows(cfg: LMConfig, max_seq: int) -> Dict[str, Tuple[int, int]]:
    w = cfg.sliding_window or 0
    if cfg.local_global_alternating:
        n_pairs = cfg.n_layers // 2
        return {"local": (n_pairs, w or max_seq), "global": (n_pairs, max_seq)}
    return {"all": (cfg.n_layers, w if w else max_seq)}


def gnn_model_flops(cfg: GNNConfig, n_nodes: int, n_edges: int,
                    d_feat: int, train: bool = True) -> float:
    d = cfg.d_hidden
    n_agg = len(cfg.aggregators) * len(cfg.scalers)
    per_layer = (n_edges * 2 * d * d * 2               # two msg matmuls
                 + n_nodes * 2 * (1 + n_agg) * d * d)  # update matmul
    fwd = (n_nodes * 2 * d_feat * d                    # encode
           + cfg.n_layers * per_layer
           + n_nodes * 2 * d * cfg.n_classes)
    return (3.0 if train else 1.0) * fwd


def recsys_model_flops(cfg: RecsysConfig, shape: ShapeSpec) -> float:
    B = shape.batch if shape.n_candidates == 0 else shape.n_candidates
    D = cfg.embed_dim
    if cfg.interaction == "fm-2way":
        # retrieval_cand uses the FM algebraic shortcut: O(N*D), F-free
        fwd = (B * D * 4 if shape.n_candidates > 0
               else B * cfg.n_sparse * D * 4)
    elif cfg.interaction == "self-attn":
        F, H, A = cfg.n_sparse, cfg.n_heads, cfg.d_attn
        per = 2 * F * (D * H * A * 4 + F * H * A * 2)
        fwd = B * cfg.n_attn_layers * per + B * 2 * F * H * A
    elif cfg.interaction == "target-attn":
        S = cfg.seq_len
        attn = S * (4 * D * cfg.attn_mlp[0] + cfg.attn_mlp[0] * cfg.attn_mlp[1]
                    + cfg.attn_mlp[1]) * 2
        mlp = (3 * D * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1] + cfg.mlp[1]) * 2
        fwd = B * (attn + mlp)
    else:  # sasrec
        S = cfg.seq_len
        per_block = 2 * S * (4 * D * D) + 2 * S * S * D * 2
        n_seq = shape.batch if shape.n_candidates == 0 else 1
        fwd = n_seq * cfg.n_blocks * per_block + B * 2 * D
    return (3.0 if shape.kind == "train" else 1.0) * fwd


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(cfg: LMConfig, shape: ShapeSpec, mesh, micro: int = 0,
             param_mode: str = "zero3",
             flash_decode: bool = False) -> CellProgram:
    dtype = torch.bfloat16
    ms = dict(mesh.shape)
    n_dev = _n_devices(mesh)
    dp_total = _dp_total(mesh)
    params = DecoderLM(cfg, dtype, META)
    p_specs = SH.specs_from_rules(params, SH.lm_param_rules(mesh, param_mode))
    leaves = _leaves(params, p_specs)
    tp = param_mode != "dp_all"
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        opt = adamw(cosine_schedule(3e-4, 100, 10_000))
        opt_specs = SH.specs_from_rules(params, SH.lm_opt_rules(mesh))
        state, state_specs = _train_state(params, p_specs, opt_specs, opt)
        if param_mode == "dp_all":
            dp_total = n_dev
        n_micro = micro if micro else max(1, B // dp_total)
        # chunked attention keeps per-layer logits ~(q_chunk x S) in remat;
        # MoE archs get tighter chunks (dispatch buffers add pressure)
        qc = (1024 if cfg.moe else 2048) if S > 2048 else 0
        cfg_t = dataclasses.replace(cfg, attn_q_chunk=qc)
        step = make_lm_train_step(cfg_t, opt, num_microbatches=n_micro,
                                  chunk_tokens=4096 if cfg.moe else 8192)
        batch = {"tokens": _empty((B, S), torch.int32),
                 "targets": _empty((B, S), torch.int32)}
        bs = ((_entry(tuple(mesh.axis_names)), None)
              if param_mode == "dp_all" else SH.lm_batch_spec(mesh))
        rows = B // _group(mesh, SH._axes(bs[0]))
        metrics, m_specs = _metrics()
        coll = (A.param_collectives(leaves, ms, uses=2 * n_micro,
                                    grads=n_micro)
                + (A.tp_collectives(cfg.n_layers, rows, S, cfg.d_model,
                                    dtype, ms, train=True) if tp else []))
        args = (state, batch)
        return CellProgram(
            arch=cfg.name, shape=shape.name, kind="train", fn=step,
            args=args, in_specs=(state_specs, {"tokens": bs, "targets": bs}),
            outs=(state, metrics), out_specs=(state_specs, m_specs),
            model_flops=lm_model_flops(cfg, shape),
            note=f"microbatches={n_micro}", donate_argnums=(0,),
            count=lambda: step(*args), count_devices=n_dev,
            count_how="the train step on meta at global shapes",
            collectives=tuple(coll))

    fsdp = _entry(SH.fsdp_axes(mesh))
    if shape.kind == "prefill":
        cfg_p = dataclasses.replace(cfg,
                                    attn_q_chunk=2048 if S >= 16384 else 0)

        def prefill_step(params, tokens):
            return forward_prefill(params, cfg_p, tokens, max_seq=S,
                                   cache_dtype=torch.bfloat16)

        cache = init_cache(cfg, B, S, torch.bfloat16, META)
        c_specs = {name: CacheStack(**SH.lm_cache_specs(mesh, B))
                   for name in cache}
        tok_spec = SH.lm_batch_spec(mesh)
        rows = B // _group(mesh, SH._axes(tok_spec[0]))
        coll = (A.param_collectives(leaves, ms, uses=1, grads=0)
                + (A.tp_collectives(cfg.n_layers, rows, S, cfg.d_model,
                                    dtype, ms, train=False) if tp else []))
        args = (params, _empty((B, S), torch.int32))
        return CellProgram(
            arch=cfg.name, shape=shape.name, kind="prefill",
            fn=prefill_step, args=args, in_specs=(p_specs, tok_spec),
            outs=(_empty((B, cfg.vocab), dtype), cache),
            out_specs=((fsdp, None), c_specs),
            model_flops=lm_model_flops(cfg, shape),
            note=f"q_chunk={cfg_p.attn_q_chunk}",
            count=lambda: prefill_step(*args), count_devices=n_dev,
            count_how="the prefill on meta at global shapes",
            collectives=tuple(coll))

    # decode
    cache = init_cache(cfg, B, S, torch.bfloat16, META)
    cspec = SH.lm_cache_specs(mesh, B)
    c_specs = {name: CacheStack(**cspec) for name in cache}
    # JAX pins the per-layer cache slices inside its scan to these specs;
    # the account reads their fitted form for the split-K combine
    if flash_decode:
        FD.configure(mesh, cspec["k"][1], cspec["k"][2])
    else:
        FD.configure(None, None, None)
    tok_spec = (fsdp,) if B > 1 else ()

    def decode_step(params, token, position, cache):
        return serve_step(params, cfg, token, position, cache)

    coll = A.param_collectives(leaves, ms, uses=1, grads=0)
    rows = B
    for name, stack in cache.items():
        n_l, _, s_c, hkv, dh = stack.k.shape
        kv = fitted_spec((B, s_c, hkv, dh), cspec["k"][1:], mesh)
        pos = fitted_spec((B, s_c), cspec["pos"], mesh)
        kv = kv or (None,) * 4
        if (pos or (None, None)) != kv[:2]:
            raise ValueError(f"{cfg.name}: cache_pos {pos} and cache_kv "
                             f"{kv} split the {name} cache differently")
        rows = B // _group(mesh, SH._axes(kv[0]))
        seq = SH._axes(kv[1])
        if _group(mesh, seq) > 1:          # the split-K combine
            coll += [A.Collective("all-reduce",
                                  rows * cfg.n_heads * (dh + 2) * 4,
                                  seq)] * n_l
    if tp:
        coll += A.tp_collectives(cfg.n_layers, rows, 1, cfg.d_model, dtype,
                                 ms, train=False)
    args = (params, _empty((B,), torch.int32), _empty((), torch.int32),
            cache)
    logits_spec = (fsdp, SH.MODEL_AXIS) if B > 1 else (None, SH.MODEL_AXIS)
    return CellProgram(
        arch=cfg.name, shape=shape.name, kind="decode", fn=decode_step,
        args=args, in_specs=(p_specs, tok_spec, (), c_specs),
        outs=(_empty((B, cfg.vocab), dtype), cache),
        out_specs=(logits_spec, c_specs),
        model_flops=lm_model_flops(cfg, shape), donate_argnums=(3,),
        note=f"kv_cache={ {k: tuple(v.k.shape) for k, v in cache.items()} }",
        count=lambda: decode_step(*args), count_devices=n_dev,
        count_how="the decode step on meta at global shapes"
        + (" (split-K over the mesh's shards)" if flash_decode else ""),
        collectives=tuple(coll))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def pna_shard_loss(params: G.PNA, cfg: GNNConfig, batch: G.GraphBatch,
                   n_dev: int, *, mean_log_deg: float = 2.0
                   ) -> torch.Tensor:
    """The program one device runs in ``pna_loss_sharded`` over ``n_dev``
    shards, for shard 0: ``batch`` holds the whole node arrays and this
    shard's edge block. The node features are encoded whole, each layer
    aggregates into the shard's node range, and the rebuilt (all-gathered)
    features are the shard's block repeated: the values differ from the
    sharded loss's for ``n_dev > 1``, the operations and shapes do not.
    At ``n_dev == 1`` it is ``pna_loss_sharded``."""
    n_loc = batch.feats.shape[0] // n_dev
    b = batch.to(params.device)
    h = b.feats @ params.encode
    for lp in params.layers:
        part = G._layer(lp, cfg, h, h[:n_loc], b.senders, b.receivers,
                        b.receivers, b.edge_mask, mean_log_deg)
        h = part.repeat(n_dev, 1)                          # all_gather
    logits = h[:n_loc] @ params.decode
    nll = G._nll(logits, b.labels[:n_loc], b.node_mask[:n_loc])
    return torch.sum(nll) / torch.clamp(
        torch.sum(b.node_mask[:n_loc].to(torch.float32)), min=1.0)


def _grad_step(loss_of, opt):
    """JAX's cell step: value_and_grad of ``loss_of(params, batch)``, then
    the optimizer update."""
    def step(state: TrainState, batch):
        loss, grads = value_and_grad(lambda: loss_of(state.params, batch),
                                     state.params)
        _, new_opt, gnorm = opt.update(grads, state.opt,
                                       named_params(state.params))
        return TrainState(state.params, new_opt), {"loss": loss,
                                                   "grad_norm": gnorm}
    return step


def pna_shard_step(cfg: GNNConfig, opt, n_dev: int) -> Callable:
    """One device's train step of the sharded PNA cell (the account's
    count): :func:`pna_shard_loss`'s gradients and the update."""
    return _grad_step(lambda p, b: pna_shard_loss(p, cfg, b, n_dev), opt)


def _graph(n_nodes: int, n_edges: int, d_feat: int) -> G.GraphBatch:
    return G.GraphBatch(
        feats=_empty((n_nodes, d_feat), torch.float32),
        senders=_empty((n_edges,), torch.int32),
        receivers=_empty((n_edges,), torch.int32),
        edge_mask=_empty((n_edges,), torch.bool),
        node_mask=_empty((n_nodes,), torch.bool),
        labels=_empty((n_nodes,), torch.int32))


def _gnn_cell(cfg: GNNConfig, shape: ShapeSpec, mesh) -> CellProgram:
    n_dev = _n_devices(mesh)
    ms = dict(mesh.shape)

    if shape.name == "minibatch_lg":
        f1, f2 = shape.fanout
        n_nodes = shape.batch_nodes * (1 + f1 + f1 * f2)
        n_edges = shape.batch_nodes * (f1 + f1 * f2)
        d_feat = shape.d_feat
        note = f"sampled subgraph {n_nodes} nodes / {n_edges} edges"
    elif shape.name == "molecule":
        n_nodes = shape.graph_batch * shape.n_nodes
        n_edges = shape.graph_batch * shape.n_edges
        d_feat = shape.d_feat
        note = f"block-diag batch of {shape.graph_batch} molecules"
    else:
        n_nodes, n_edges, d_feat = shape.n_nodes, shape.n_edges, shape.d_feat
        note = "full graph"
    # dst-partition contract (models/gnn.py): +25% slack for range skew
    n_edges_p = _pad_mult(int(n_edges * 1.25), n_dev)
    n_nodes_p = _pad_mult(n_nodes, n_dev)

    params = G.PNA(cfg, d_feat, torch.float32, META)
    p_specs = SH.specs_from_rules(params, SH.gnn_param_rules(mesh))
    opt = adamw(cosine_schedule(1e-3, 100, 10_000))
    state, state_specs = _train_state(params, p_specs, p_specs, opt)

    every = _entry(tuple(mesh.axis_names))
    batch = _graph(n_nodes_p, n_edges_p, d_feat)
    b_specs = G.GraphBatch(feats=(), senders=(every,), receivers=(every,),
                           edge_mask=(every,), node_mask=(), labels=())
    step = _grad_step(lambda p, b: G.pna_loss_sharded(p, cfg, b, mesh), opt)
    local = _graph(n_nodes_p, n_edges_p // n_dev, d_feat)
    shard_step = pna_shard_step(cfg, opt, n_dev)
    metrics, m_specs = _metrics()
    h_bytes = n_nodes_p * cfg.d_hidden * 4
    axes = tuple(mesh.axis_names)
    coll = (A.param_collectives(_leaves(params, p_specs), ms, uses=2,
                                grads=1)
            + [A.Collective("all-gather", h_bytes, axes),
               A.Collective("reduce-scatter", h_bytes // n_dev, axes)]
            * cfg.n_layers)
    return CellProgram(
        arch=cfg.name, shape=shape.name, kind="train", fn=step,
        args=(state, batch), in_specs=(state_specs, b_specs),
        outs=(state, metrics), out_specs=(state_specs, m_specs),
        model_flops=gnn_model_flops(cfg, n_nodes, n_edges, d_feat),
        note=note, donate_argnums=(0,),
        count=lambda: shard_step(state, local), count_devices=1,
        count_how="one shard's program (pna_shard_step) on meta",
        collectives=tuple(coll))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

_RECSYS = {"fm-2way": R.FM, "self-attn": R.AutoInt, "target-attn": R.DIN,
           "self-attn-seq": R.SASRec}
_TABLES = ("table", "linear", "item_table", "pos_table")


def _recsys_batch(cfg: RecsysConfig, shape: ShapeSpec, mesh):
    """(abstract batch, batch specs) for forward/train shapes."""
    B = shape.batch
    dp = _entry(SH.fsdp_axes(mesh))
    if cfg.interaction in ("fm-2way", "self-attn"):
        batch = {"ids": _empty((B, cfg.n_sparse), torch.int32)}
        specs = {"ids": (dp, None)}
    else:
        batch = {"hist_ids": _empty((B, cfg.seq_len), torch.int32),
                 "hist_mask": _empty((B, cfg.seq_len), torch.bool),
                 "target_ids": _empty((B,), torch.int32)}
        specs = {"hist_ids": (dp, None), "hist_mask": (dp, None),
                 "target_ids": (dp,)}
    if shape.kind == "train":
        batch["labels"] = _empty((B,), torch.float32)
        specs["labels"] = (dp,)
    return batch, specs


def _lookup_rows(cfg: RecsysConfig, rows: int, cands: int,
                 context: bool) -> Dict[str, int]:
    """Rows a device looks up per table: ``rows`` examples (or, with
    ``context``, one shared context) and ``cands`` candidates."""
    if cfg.interaction in ("fm-2way", "self-attn"):
        n = (cfg.n_sparse - 1 if context else rows * cfg.n_sparse) + cands
        out = {"table": n}
        if cfg.interaction == "fm-2way":
            out["linear"] = cands if context else n
        return out
    S = cfg.seq_len
    out = {"item_table": (S if context else rows * (S + 1)) + cands}
    if cfg.interaction == "self-attn-seq":
        out["pos_table"] = S
    return out


def _recsys_collectives(cfg, params, p_specs, mesh, rows: int, cands: int,
                        context: bool, train: bool):
    ms = dict(mesh.shape)
    coll = A.param_collectives(_leaves(params, p_specs), ms,
                               uses=0, grads=1 if train else 0, gather=False)
    named = dict(params.named_parameters())
    for name, n in _lookup_rows(cfg, rows, cands, context).items():
        t = named[name]
        coll += A.lookup_collective(n, t.shape[1], t.dtype,
                                    SH._axes(p_specs[name][0]), ms)
    return coll


def _recsys_cell(cfg: RecsysConfig, shape: ShapeSpec, mesh) -> CellProgram:
    params = _RECSYS[cfg.interaction](cfg, torch.float32, META)
    p_specs = SH.specs_from_rules(params, SH.recsys_param_rules(mesh))
    every = _entry(tuple(mesh.axis_names))
    n_dev = _n_devices(mesh)
    dp = SH.fsdp_axes(mesh)

    if shape.kind == "train":
        opt = adamw(cosine_schedule(1e-3, 100, 10_000))
        state, state_specs = _train_state(params, p_specs, p_specs, opt)
        batch, b_specs = _recsys_batch(cfg, shape, mesh)
        step = make_recsys_train_step(cfg, opt)
        metrics, m_specs = _metrics()
        args = (state, batch)
        return CellProgram(
            arch=cfg.name, shape=shape.name, kind="train", fn=step,
            args=args, in_specs=(state_specs, b_specs),
            outs=(state, metrics), out_specs=(state_specs, m_specs),
            model_flops=recsys_model_flops(cfg, shape), donate_argnums=(0,),
            count=lambda: step(*args), count_devices=n_dev,
            count_how="the train step on meta at global shapes",
            collectives=tuple(_recsys_collectives(
                cfg, params, p_specs, mesh, shape.batch // _group(mesh, dp),
                0, False, True)))

    if shape.n_candidates > 0:
        # retrieval_cand: 1 query vs ~1M candidates
        N = _pad_mult(shape.n_candidates, n_dev)
        if cfg.interaction in ("fm-2way", "self-attn"):
            batch = {"context_ids": _empty((cfg.n_sparse - 1,), torch.int32),
                     "cand_ids": _empty((N,), torch.int32)}
            b_specs = {"context_ids": (), "cand_ids": (every,)}
        else:
            batch = {"hist_ids": _empty((cfg.seq_len,), torch.int32),
                     "hist_mask": _empty((cfg.seq_len,), torch.bool),
                     "cand_ids": _empty((N,), torch.int32)}
            b_specs = {"hist_ids": (), "hist_mask": (), "cand_ids": (every,)}

        def score_step(params, batch):
            if cfg.interaction == "self-attn":
                return R.autoint_score_candidates(
                    params, cfg, batch["context_ids"], batch["cand_ids"],
                    chunk=N)
            if cfg.interaction == "target-attn":
                return R.din_score_candidates(
                    params, cfg, batch["hist_ids"], batch["hist_mask"],
                    batch["cand_ids"], chunk=N)
            return recsys_score_candidates(params, cfg, batch)

        args = (params, batch)
        return CellProgram(
            arch=cfg.name, shape=shape.name, kind="serve", fn=score_step,
            args=args, in_specs=(p_specs, b_specs),
            outs=_empty((N,), torch.float32), out_specs=(every,),
            model_flops=recsys_model_flops(cfg, shape),
            note=f"candidates padded {shape.n_candidates} -> {N}",
            count=lambda: score_step(*args), count_devices=n_dev,
            count_how="the candidate scoring on meta at global shapes",
            collectives=tuple(_recsys_collectives(
                cfg, params, p_specs, mesh, 0, N // n_dev, True, False)))

    # plain serving (serve_p99 / serve_bulk)
    batch, b_specs = _recsys_batch(cfg, shape, mesh)

    def serve(params, batch):
        return recsys_serve(params, cfg, batch)

    args = (params, batch)
    return CellProgram(
        arch=cfg.name, shape=shape.name, kind="serve", fn=serve, args=args,
        in_specs=(p_specs, b_specs),
        outs=_empty((shape.batch,), torch.float32),
        out_specs=(_entry(dp),),
        model_flops=recsys_model_flops(cfg, shape),
        count=lambda: serve(*args), count_devices=n_dev,
        count_how="the forward on meta at global shapes",
        collectives=tuple(_recsys_collectives(
            cfg, params, p_specs, mesh, shape.batch // _group(mesh, dp), 0,
            False, False)))


# ---------------------------------------------------------------------------
# Retrieval (paper) cells
# ---------------------------------------------------------------------------

def _query_chunks(B: int, chunk: int = 512) -> int:
    """Launches ``retrieval/service.py::_chunked_over_queries`` makes over
    a batch of ``B`` queries."""
    c = min(B, chunk)
    return B // c if (B % c == 0 and B > c) else 1


def _retrieval_cell(cfg: RetrievalConfig, shape: ShapeSpec, mesh,
                    corpus_docs: int = 0) -> CellProgram:
    from repro_torch.retrieval.service import (make_rerank_bandit_step,
                                               make_rerank_dense_step)
    n_dev = _n_devices(mesh)
    every = _entry(tuple(mesh.axis_names))
    axes = tuple(mesh.axis_names)
    B, N = shape.batch, shape.n_candidates
    L, M, T = cfg.doc_tokens, cfg.dim, cfg.query_tokens
    C = _pad_mult(corpus_docs or cfg.corpus_docs, n_dev)
    bf = torch.bfloat16

    if shape.name.startswith("rerank_bandit"):
        rounds = max(4, (N * T) // (16 * 8) // 2)
        step, in_pl, out_pl = make_rerank_bandit_step(mesh, topk=TOPK,
                                                      max_rounds=rounds)
        args = (_empty((B, N, L, M), bf),       # gathered candidate docs
                _empty((B, N, L), torch.bool),
                _empty((B, T, M), bf),
                _empty((B, N), torch.int32),
                _empty((B, N, T), torch.float32),
                _empty((B, N, T), torch.float32))
        outs = (_empty((B, TOPK), torch.int64), _empty((B,), torch.float32))

        def spec(x, dim):
            return tuple(every if i == dim else None for i in range(x.dim()))

        bq = B // n_dev
        # the cap: every round reveals 16 docs x 8 tokens per query
        cells = bq * rounds * 16 * 8
        work = dict(flops_by_dtype={"float32": 2 * cells * L * M},
                    unfused_bytes=cells // 8 * (L * M * 2 + L)
                    + cells * (M * 2 + 4 * 4),
                    launches={"fused_reveal": rounds + 1},
                    how="fused_reveal kernel work at the max_rounds cap "
                        f"({rounds} rounds of 16 docs x 8 tokens a query): "
                        "an upper bound")
        return CellProgram(
            arch=cfg.name, shape=shape.name, kind="serve", fn=step,
            args=args,
            in_specs=tuple(spec(a, d) for a, d in zip(args, in_pl)),
            outs=outs, out_specs=tuple(spec(o, d)
                                       for o, d in zip(outs, out_pl)),
            model_flops=B * N * T * L * M * 2 * 0.3,  # at ~30% coverage
            note="block-synchronous Col-Bandit, adaptive rounds",
            reckoned_work=work,
            collectives=(A.Collective("all-gather", B * TOPK * 8 + B * 4,
                                      axes),))

    step = make_rerank_dense_step(mesh, topk=TOPK)
    n_loc = max(1, -(-N * 4 // n_dev))   # 4x headroom for routing skew
    args = (_empty((C, L, M), bf), _empty((C, L), torch.bool),
            _empty((B, T, M), bf), _empty((B, n_dev, n_loc), torch.int32))
    in_specs = ((every, None, None), (every, None), (None, None, None),
                (None, every, None))
    slots = B * n_loc                    # a shard's candidate slots
    filled = B * N / n_dev               # the mean it fills, even routing
    row = L * M * 2 + L                  # a bf16 doc and its mask
    work = dict(
        flops_by_dtype={"float32": 2 * filled * T * L * M},
        # the gather (every slot's id read, its row read and written: a pad
        # gathers row 0), the kernel (every slot's mask, the filled slots'
        # rows and the queries read, H written), the masked sum (H read,
        # scores written)
        unfused_bytes=(slots * (8 + 2 * row + L + T * 4 * 2 + 4)
                       + filled * L * M * 2 + B * T * M * 2),
        launches={"maxsim": _query_chunks(B)},
        filled_slots=filled, pad_slots=slots - filled,
        how="the dense maxsim kernel's work a shard over the N / devices "
            "candidate slots it fills on average, at the full doc length "
            "(an upper bound: the kernel skips masked tokens and the "
            "all-masked pad slots of the 4x routing headroom), with the "
            "candidate gather and the masked sum over every slot")
    return CellProgram(
        arch=cfg.name, shape=shape.name, kind="serve", fn=step, args=args,
        in_specs=in_specs,
        # the port's merge returns int64 ids (JAX's are int32)
        outs=(_empty((B, TOPK), torch.float32),
              _empty((B, TOPK), torch.int64)),
        out_specs=((None, None), (None, None)),
        model_flops=B * N * T * L * M * 2,
        note=f"corpus {C} docs sharded {n_dev}-way, {n_loc} cand "
             "slots/shard",
        reckoned_work=work,
        collectives=(A.Collective(
            "all-gather", scorecard_budget_bytes(B, n_dev, TOPK) - 2 * B * 4,
            axes),))


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh, *, depth: int = 0,
               batch: int = 0, micro: int = 0, param_mode: str = "zero3",
               flash_decode: bool = False,
               corpus_docs: int = 0) -> CellProgram:
    """The cell's program on ``mesh``. ``depth`` / ``batch`` / ``micro`` /
    ``param_mode`` / ``flash_decode`` are JAX's overrides (a reduced depth
    counts linearly less); ``corpus_docs`` cuts a retrieval cell's corpus
    (the port's own, for a corpus that fits one card)."""
    cfg = get_config(arch)
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    if depth and cfg.family == "lm":
        cfg = dataclasses.replace(cfg, n_layers=depth)
    if batch and cfg.family == "lm":
        shape = dataclasses.replace(shape, global_batch=batch)
    if batch and cfg.family == "retrieval":
        shape = dataclasses.replace(shape, batch=batch)
    if cfg.family == "lm":
        return _lm_cell(cfg, shape, mesh, micro=micro, param_mode=param_mode,
                        flash_decode=flash_decode)
    if cfg.family == "gnn":
        return _gnn_cell(cfg, shape, mesh)
    if cfg.family == "recsys":
        return _recsys_cell(cfg, shape, mesh)
    if cfg.family == "retrieval":
        return _retrieval_cell(cfg, shape, mesh, corpus_docs)
    raise ValueError(cfg.family)
