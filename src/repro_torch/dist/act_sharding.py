"""The activation-sharding fit of ``repro.dist.act_sharding``, as a pure
function.

In JAX, model code annotates activations with LOGICAL axes (``"dp"``,
``"tp"``) through ``constrain``, the launch layer binds those names to
mesh axes once per cell, and each annotation becomes a GSPMD
``with_sharding_constraint``: a hint to the partitioner about where an
intermediate lives. Eager PyTorch has no partitioner to hint (a value
lives where the code that made it put it), so the port has no constraint
context and no ``constrain``. What it keeps is the fit: :func:`fitted_spec`
maps a shape and its parts to the spec JAX would constrain it to. The
launcher reads the fitted cache-slice specs in the decode cell's account
(``launch/steps.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.dist.sharding import Part, _norm, fsdp_axes, tp_axis


def fitted_spec(shape: Sequence[int], parts: Sequence[Part], mesh, *,
                dp_all: bool = False) -> Optional[Tuple[Part, ...]]:
    """The spec JAX's ``_apply`` constrains a value of ``shape`` to under
    ``parts`` (one per dim) on ``mesh``: ``"dp"`` resolved to the FSDP
    group and ``"tp"`` to the ``model`` axis (under ``dp_all``, to every
    mesh axis and to None, as JAX's ``set_axes`` binds them for that
    layout); a part kept where every axis of its group is in the mesh and
    the group's size divides the dim, else None; each entry in JAX's
    canonical form (a one-axis group is its name). Returns None when the
    rank differs or no dim splits (JAX then returns ``x`` unconstrained)."""
    if len(shape) != len(parts):
        return None
    dp = tuple(mesh.axis_names) if dp_all else fsdp_axes(mesh)
    tp = None if dp_all else tp_axis(mesh)
    mesh_shape = dict(mesh.shape)
    fitted = []
    for dim, part in zip(shape, parts):
        part = {"dp": dp, "tp": tp}.get(part, part) if isinstance(
            part, str) else part
        if part is None:
            fitted.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        ok = all(a in mesh_shape for a in axes)
        size = 1
        for a in axes:
            size *= int(mesh_shape.get(a, 1))
        fitted.append(_norm(part) if ok and dim % size == 0 else None)
    if all(p is None for p in fitted):
        return None
    return tuple(fitted)
