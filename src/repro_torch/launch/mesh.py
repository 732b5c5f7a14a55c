"""Production meshes for the launcher (port of ``repro.launch.mesh``).

A function, not a module constant, as in JAX. The production meshes are
described on the ``meta`` device: the launcher's account reads only their
axes and sizes, so building one touches no card. ``make_host_mesh`` (a
small mesh over the cards there are) is ``dist/mesh.py``'s.
"""
from __future__ import annotations

from repro_torch.dist.mesh import Mesh, make_host_mesh, make_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> Mesh:
    """(16, 16) ("data", "model"), 256 devices; ``multi_pod`` stacks two on
    a leading "pod" axis: (2, 16, 16), 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)
