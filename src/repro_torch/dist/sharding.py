"""Parameter, batch and KV-cache placement rules for the production meshes
(port of ``repro.dist.sharding``).

The JAX package's two production meshes are::

    single-pod  {"data": 16, "model": 16}            256 chips
    multi-pod   {"pod": 2, "data": 16, "model": 16}  512 chips

Conventions, as in JAX:

  * the FSDP ("dp") group is every mesh axis except ``model``: ZeRO-style
    parameter / optimizer sharding and batch sharding both ride on it, so
    a second pod widens the group to ("pod", "data");
  * the ``model`` axis is tensor parallelism ("tp"): attention heads and
    FFN hidden dims split over it.

A :data:`Spec` is a tuple with one entry per dim: ``None`` (the dim is
whole on every shard), an axis name, or a tuple of axis names (the dim
splits over their product, row-major). It is JAX's ``PartitionSpec``
without JAX. Only a mesh's ``shape`` dict and ``axis_names`` are read, so
the port's :class:`~repro_torch.dist.mesh.Mesh` and any object with those
two attributes describe a mesh of any size without devices.

Rules are written for the *trailing* dims of a leaf and matched against its
name. JAX matches ``keystr`` paths of stacked leaves (``['all']['attn']
['wq']`` is (L, D, H * Dh), a MoE expert weight (L, E, D, F)); the port
holds one module per layer, so its names are ``blocks.<i>.attn.wq`` (D,
H * Dh) and ``blocks.<i>.moe.w_gate`` (E, D, F). :func:`_fit_spec`
left-pads a rule with ``None`` and drops any split whose axis group does
not divide its dim, so a port leaf gets the spec JAX gives the matching
stacked leaf on the trailing dims. The corpus table lives in
:mod:`repro_torch.dist.mesh` and is re-exported here.
"""
from __future__ import annotations

import re
from typing import (Any, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

from repro_torch.dist.mesh import (_axes, _group_size, corpus_axes,
                                   corpus_specs)

MODEL_AXIS = "model"

Part = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Part, ...]

__all__ = ["MODEL_AXIS", "Part", "Spec", "ShardingRules", "corpus_axes",
           "corpus_specs", "fsdp_axes", "gnn_param_rules", "lm_batch_spec",
           "lm_cache_specs", "lm_opt_rules", "lm_param_rules",
           "recsys_param_rules", "shard_shape", "specs_from_rules",
           "tp_axis"]


# ---------------------------------------------------------------------------
# mesh helpers (anything with a .shape mapping and .axis_names)
# ---------------------------------------------------------------------------

def fsdp_axes(mesh) -> Tuple[str, ...]:
    """The ZeRO / data-parallel axis group: every axis except ``model``; on
    a mesh with only a model axis, every axis (so a batch spec always has
    an axis to split over)."""
    names = tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
    return names or tuple(mesh.axis_names)


def tp_axis(mesh) -> Optional[str]:
    """The tensor-parallel axis, or None when the mesh has no ``model``."""
    return MODEL_AXIS if MODEL_AXIS in tuple(mesh.axis_names) else None


def _norm(part: Part) -> Part:
    """One entry in canonical form, as JAX's ``PartitionSpec`` stores it: a
    one-axis group is its name, an empty one ``None``."""
    axes = _axes(part)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def shard_shape(shape: Sequence[int], spec: Spec,
                mesh_shape: Mapping[str, int]) -> Tuple[int, ...]:
    """One shard's block of a value of ``shape`` placed by ``spec`` (dims
    past the spec's length are whole). A split that does not divide its
    dim raises ValueError, as a JAX ``NamedSharding`` does."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for i, dim in enumerate(shape):
        n = _group_size(mesh_shape, _axes(spec[i] if i < len(spec)
                                          else None))
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {n} shards ({spec})")
        out.append(dim // n)
    return tuple(out)


# ---------------------------------------------------------------------------
# rule engine
# ---------------------------------------------------------------------------

class ShardingRules(NamedTuple):
    """An ordered (name pattern -> trailing-dims spec) table bound to a
    mesh shape (only the shape dict is kept, so a described mesh works)."""
    mesh_shape: Dict[str, int]
    rules: Tuple[Tuple[Any, Spec], ...]


def _compile(mesh, rules) -> ShardingRules:
    return ShardingRules(
        mesh_shape=dict(mesh.shape),
        rules=tuple((re.compile(pat), tuple(spec)) for pat, spec in rules))


def _leaf(*names: str) -> str:
    """A pattern matching a dotted parameter name that ends in one of
    ``names`` (the port's counterpart of JAX's ``\\['name'\\]$``)."""
    return r"(?:^|\.)(?:" + "|".join(names) + r")$"


def _fit_spec(spec: Spec, shape: Tuple[int, ...],
              mesh_shape: Mapping[str, int]) -> Spec:
    """Adapt a trailing-dims spec to a leaf's shape: left-pad with None for
    extra leading dims and drop a split whose axis group does not divide
    its dim (or names an axis the mesh lacks)."""
    parts = list(spec)
    if len(parts) > len(shape):
        parts = parts[len(parts) - len(shape):]
    parts = [None] * (len(shape) - len(parts)) + parts
    fitted = []
    for dim, part in zip(shape, parts):
        axes = _axes(part)
        if not axes or any(a not in mesh_shape for a in axes):
            fitted.append(None)
            continue
        divides = dim % _group_size(mesh_shape, axes) == 0
        fitted.append(_norm(part) if divides else None)
    return tuple(fitted)


def _named_shapes(tree) -> Dict[str, Tuple[int, ...]]:
    if hasattr(tree, "named_parameters"):
        tree = dict(tree.named_parameters())
    return {name: tuple(getattr(leaf, "shape", leaf))
            for name, leaf in tree.items()}


def specs_from_rules(tree, rules: ShardingRules) -> Dict[str, Spec]:
    """Parameter name -> spec, for an ``nn.Module`` (its
    ``named_parameters``) or a mapping of name -> tensor or shape. The
    first rule whose pattern matches a name wins; an unmatched leaf is
    whole on every shard."""
    out = {}
    for name, shape in _named_shapes(tree).items():
        spec: Spec = ()
        for pat, s in rules.rules:
            if pat.search(name):
                spec = s
                break
        out[name] = _fit_spec(spec, shape, rules.mesh_shape)
    return out


# ---------------------------------------------------------------------------
# LM rules
# ---------------------------------------------------------------------------

def lm_param_rules(mesh, mode: str = "zero3") -> ShardingRules:
    """Parameter layout of the decoder LM family.

    mode
      * ``zero3``: contraction dim over the FSDP group, heads / hidden over
        ``model``;
      * ``zero1``: parameters whole over the FSDP group, tensor parallelism
        kept (pair with :func:`lm_opt_rules` for the optimizer state);
      * ``dp_all``: no tensor parallelism: the leading dim of each matrix
        over every mesh axis.
    """
    dp = fsdp_axes(mesh)
    tp = tp_axis(mesh)
    every = tuple(mesh.axis_names)
    if mode == "zero3":
        row, col = dp, tp
    elif mode == "zero1":
        row, col = None, tp
    elif mode == "dp_all":
        row, col = every, None
    else:
        raise ValueError(f"unknown param mode {mode!r}")
    vec = row
    rules = [
        (r"^embed$", (row, col)),
        (r"^head$", (row, col)),
        (r"^final_norm$", (vec,)),
        (_leaf("ln1", "ln2"), (vec,)),
        (_leaf("wq", "wk", "wv"), (row, col)),
        (_leaf("wo"), (col, row)),
        (_leaf("bq", "bk", "bv"), (col,)),
        (_leaf("router"), (row, None)),
        # dense MLP (D, F) and MoE experts (E, D, F) alike: the trailing
        # two dims are (contraction, hidden)
        (_leaf("w_gate", "w_up"), (row, col)),
        (_leaf("w_down"), (col, row)),
    ]
    return _compile(mesh, rules)


def lm_opt_rules(mesh) -> ShardingRules:
    """AdamW moments: always fully sharded (two float32 copies of every
    parameter never need to be whole on a shard)."""
    return lm_param_rules(mesh, mode="zero3")


def lm_batch_spec(mesh) -> Spec:
    """(B, S) token batches split their rows over the FSDP group."""
    return (_norm(fsdp_axes(mesh)), None)


def lm_cache_specs(mesh, batch: int) -> Dict[str, Spec]:
    """KV-cache layout per ``models.kv_cache.CacheStack`` field: k / v are
    (n_layers, B, S_cache, Hkv, Dh), pos (B, S_cache). The batch splits
    over the FSDP group where it divides (decode_32k); the cache's sequence
    dim splits over ``model`` (long_500k's B = 1 cache), the layout the
    split-K decode of :mod:`repro_torch.dist.flash_decode` reads."""
    dp = fsdp_axes(mesh)
    bp = dp if (batch > 1 and batch % _group_size(dict(mesh.shape), dp) == 0
                ) else None
    bp, sp = _norm(bp), tp_axis(mesh)
    return {"k": (None, bp, sp, None, None),
            "v": (None, bp, sp, None, None),
            "pos": (bp, sp)}


# ---------------------------------------------------------------------------
# GNN / recsys rules
# ---------------------------------------------------------------------------

def gnn_param_rules(mesh) -> ShardingRules:
    """PNA weights: (d_in, d_out) matrices over (fsdp, model) where they
    divide (d_hidden 75 does not on the production meshes, so those stay
    whole, the contract of the sharded PNA loss)."""
    dp = fsdp_axes(mesh)
    tp = tp_axis(mesh)
    rules = [
        (_leaf("encode", "decode"), (dp, tp)),
        (_leaf("w_msg_src", "w_msg_dst", "w_update"), (dp, tp)),
    ]
    return _compile(mesh, rules)


def recsys_param_rules(mesh) -> ShardingRules:
    """Recsys layout: the embedding tables are the model; their rows split
    over ("pod" +) "model" (rows padded to 4,096 so they divide); the small
    dense interaction weights stay whole."""
    names = tuple(mesh.axis_names)
    rows = tuple(a for a in ("pod", MODEL_AXIS) if a in names) or None
    rules = [
        (_leaf("table", "linear"), (rows, None)),
        (_leaf("item_table", "pos_table"), (rows, None)),
    ]
    return _compile(mesh, rules)
