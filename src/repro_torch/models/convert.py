"""Weights across: the JAX package's parameter pytrees -> the port's
modules.

``lm_from_jax`` takes ``repro.models.transformer.init_lm``'s tree as numpy
arrays (``jax.tree.map(np.asarray, params)``): "embed", "final_norm",
"head" and the stacked layers, "all" or "local" / "global" (axis 0 = layer
of the stack, or pair of gemma2's layers). Pair i's local and global layers
become blocks 2i and 2i + 1, JAX's execution order. A MoE layer's
"moe" leaves (router, w_gate, w_up, w_down) go to ``Block.moe``.
``li_head_from_jax`` takes ``repro.models.colbert.init_li_head``'s tree,
``recsys_from_jax`` the trees of ``repro.models.recsys.init_fm`` /
``init_autoint`` / ``init_din`` / ``init_sasrec`` (the model by
``cfg.interaction``), ``gnn_from_jax`` ``repro.models.gnn.init_pna``'s
(stacked layers -> ``PNA.layers``). Each builds on ``device="cuda"``
unless the caller passes "cpu", in the arrays' own dtype unless ``dtype``
is given; a shape that does not match the config, or a leaf present in
only one of the tree and the model, raises ValueError.

``train_state_from_jax`` carries a JAX ``TrainState`` (parameters and the
AdamW ``step``, ``m``, ``v``, as numpy arrays) into a port ``TrainState``
for an LM / MoE, recsys or GNN config, the moments through the same name
maps (float32). ``tree_from_keystr`` nests a JAX checkpoint's flat
key-path names (``.opt.m['all']['attn']['wq']``) back into dicts and
lists, so a checkpoint the JAX package wrote converts too.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.models import recsys as R
from repro_torch.models.colbert import LIHead
from repro_torch.models.gnn import PNA
from repro_torch.models.transformer import DecoderLM
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_step import TrainState

_BLOCK_LEAVES = (("ln1",), ("ln2",), ("attn", "wq"), ("attn", "wk"),
                 ("attn", "wv"), ("attn", "wo"), ("attn", "bq"),
                 ("attn", "bk"), ("attn", "bv"), ("mlp", "w_gate"),
                 ("mlp", "w_up"), ("mlp", "w_down"), ("moe", "router"),
                 ("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down"))


def to_tensor(a: Any) -> torch.Tensor:
    """A numpy (or array-like) leaf as a CPU tensor of the same dtype, a
    copy; bfloat16 arrays (ml_dtypes) keep their bits."""
    a = np.array(a)   # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _dtype_of(a: Any) -> torch.dtype:
    return to_tensor(np.asarray(a).reshape(-1)[:1]).dtype


def _load(dst: torch.Tensor, src: Any, where: str) -> None:
    t = to_tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)} does not match "
                         f"the config's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t.to(device=dst.device, dtype=dst.dtype))


def lm_from_jax(params_np: Mapping[str, Any], cfg: LMConfig, *,
                dtype: Optional[torch.dtype] = None,
                device="cuda") -> DecoderLM:
    model = DecoderLM(cfg, dtype or _dtype_of(params_np["embed"]), device)
    for name in ("embed", "final_norm", "head"):
        _load(getattr(model, name), params_np[name], name)
    if cfg.local_global_alternating:
        stacks = [("local", 0), ("global", 1)]
        stride = 2
    else:
        stacks, stride = [("all", 0)], 1
    for stack, offset in stacks:
        tree = params_np[stack]
        n = np.asarray(tree["ln1"]).shape[0]
        if n * stride != cfg.n_layers:
            raise ValueError(f"{stack}: {n} stacked layers, the config has "
                             f"{cfg.n_layers}")
        for i in range(n):
            blk = model.blocks[i * stride + offset]
            for path in _BLOCK_LEAVES:
                dst = blk
                for part in path:
                    dst = getattr(dst, part) if dst is not None else None
                src = tree
                for part in path:
                    src = src.get(part) if isinstance(src, Mapping) else None
                if (dst is None) != (src is None):
                    raise ValueError(f"{stack}/{'/'.join(path)}: present in "
                                     "only one of the tree and the config")
                if dst is not None:
                    _load(dst, np.asarray(src)[i],
                          f"{stack}[{i}]/{'/'.join(path)}")
    return model


def li_head_from_jax(head_np: Mapping[str, Any], cfg: LMConfig, *,
                     dtype: Optional[torch.dtype] = None,
                     device="cuda") -> LIHead:
    head = LIHead(cfg, dtype or _dtype_of(head_np["proj"]), device)
    _load(head.proj, head_np["proj"], "proj")
    return head


_RECSYS = {"fm-2way": (R.FM, "table"), "self-attn": (R.AutoInt, "table"),
           "target-attn": (R.DIN, "item_table"),
           "self-attn-seq": (R.SASRec, "item_table")}


def _leaves(tree: Any, prefix: str = ""):
    """'a.0.b'-style names of a nested dict / list tree's leaves."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))


def recsys_from_jax(params_np: Mapping[str, Any], cfg: RecsysConfig, *,
                    dtype: Optional[torch.dtype] = None,
                    device="cuda") -> torch.nn.Module:
    if cfg.interaction not in _RECSYS:
        raise ValueError(f"{cfg.name}: unknown interaction "
                         f"{cfg.interaction!r}")
    cls, first = _RECSYS[cfg.interaction]
    model = cls(cfg, dtype or _dtype_of(params_np[first]), device)
    src = dict(_leaves(params_np))
    dst = dict(model.named_parameters())
    if set(src) != set(dst):
        raise ValueError(f"{cfg.name}: leaves present in only one of the "
                         f"tree and the model: {sorted(set(src) ^ set(dst))}")
    for name, param in dst.items():
        _load(param, src[name], name)
    return model


def gnn_from_jax(params_np: Mapping[str, Any], cfg: GNNConfig, *,
                 dtype: Optional[torch.dtype] = None,
                 device="cuda") -> PNA:
    d_feat = np.asarray(params_np["encode"]).shape[0]
    model = PNA(cfg, d_feat, dtype or _dtype_of(params_np["encode"]), device)
    for name in ("encode", "decode"):
        _load(getattr(model, name), params_np[name], name)
    layers = params_np["layers"]
    n = np.asarray(layers["w_update"]).shape[0]
    if n != cfg.n_layers or set(layers) != {"w_msg_src", "w_msg_dst",
                                            "w_update"}:
        raise ValueError(f"layers: {n} stacked layers with leaves "
                         f"{sorted(layers)}, the config has {cfg.n_layers}")
    for i, lp in enumerate(model.layers):
        for name in layers:
            _load(getattr(lp, name), np.asarray(layers[name])[i],
                  f"layers[{i}]/{name}")
    return model


def model_from_jax(params_np: Mapping[str, Any], cfg, *,
                   dtype: Optional[torch.dtype] = None,
                   device="cuda") -> torch.nn.Module:
    """The port's model of ``cfg``'s family from a JAX parameter tree."""
    if isinstance(cfg, LMConfig):
        return lm_from_jax(params_np, cfg, dtype=dtype, device=device)
    if isinstance(cfg, RecsysConfig):
        return recsys_from_jax(params_np, cfg, dtype=dtype, device=device)
    if isinstance(cfg, GNNConfig):
        return gnn_from_jax(params_np, cfg, dtype=dtype, device=device)
    raise ValueError(f"no model for a {type(cfg).__name__}")


def _field(x: Any, name: str) -> Any:
    return x[name] if isinstance(x, Mapping) else getattr(x, name)


def train_state_from_jax(state_np: Any, cfg, *,
                         dtype: Optional[torch.dtype] = None,
                         device="cuda") -> TrainState:
    """A JAX ``TrainState`` (a NamedTuple of numpy trees, or the same as
    nested dicts) as the port's: parameters in their dtype (or
    ``dtype``), moments float32 keyed by the port's parameter names."""
    model = model_from_jax(_field(state_np, "params"), cfg, dtype=dtype,
                           device=device)
    opt = _field(state_np, "opt")

    def moments(tree) -> Dict[str, torch.Tensor]:
        mod = model_from_jax(tree, cfg, dtype=torch.float32, device=device)
        return {k: p.detach() for k, p in mod.named_parameters()}

    m, v = moments(_field(opt, "m")), moments(_field(opt, "v"))
    if set(m) != set(dict(model.named_parameters())):
        raise ValueError("the moments' leaves differ from the parameters'")
    step = torch.tensor(int(np.asarray(_field(opt, "step"))),
                        dtype=torch.int32, device=device)
    return TrainState(params=model, opt=AdamWState(step=step, m=m, v=v))


_KEY = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def tree_from_keystr(arrays: Mapping[str, Any]) -> Dict[str, Any]:
    """Nest flat ``jax.tree_util.keystr`` names: ``.field`` and
    ``['key']`` become dict keys, ``[i]`` list indices."""
    root: Dict[Any, Any] = {}
    for name, leaf in arrays.items():
        parts = []
        pos = 0
        for m in _KEY.finditer(name):
            if m.start() != pos:
                raise ValueError(f"cannot parse the key path {name!r}")
            parts.append(m.group(1) or m.group(2) if m.group(3) is None
                         else int(m.group(3)))
            pos = m.end()
        if pos != len(name) or not parts:
            raise ValueError(f"cannot parse the key path {name!r}")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out
    return lists(root)
