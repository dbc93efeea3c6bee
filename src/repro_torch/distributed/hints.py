"""Sharding hints: the ambient mesh that model code reads without having
it passed through every layer (the port of ``repro/distributed/hints.py``).

``use_mesh(mesh)`` makes a ``launch.mesh.Mesh`` ambient, as
``jax.set_mesh`` does; outside it every helper sees no mesh and the model
runs unsharded.  The ambient mesh is process-wide, not per thread: the
autograd engine runs a backward, and the forward a checkpointed layer
recomputes there, on a thread of its own, which must see the same mesh.

``constrain`` is called where the reference calls it, but in eager
PyTorch it returns ``x`` unchanged: the port's layouts are explicit, not
left to a partitioner.  Activations are whole within the model group and
split over the data axes; each layer takes its own blocks of the weights
and issues its collectives itself (``models.layers``, ``models.lm``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

__all__ = ["use_mesh", "current_mesh", "axis", "dp_axes", "constrain"]

_STACK = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` ambient inside the block (None: no mesh)."""
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()


def current_mesh():
    """The ambient mesh, or None."""
    return _STACK[-1] if _STACK else None


def _mesh_axes() -> Tuple[str, ...]:
    m = current_mesh()
    return tuple(m.axis_names) if m is not None else ()


def axis(name: str) -> Optional[str]:
    """``name`` if the ambient mesh has that axis (of any size, 1
    included), else None."""
    return name if name in _mesh_axes() else None


def dp_axes() -> Optional[Tuple[str, ...]]:
    """The data-parallel axes of the ambient mesh ('pod' and 'data'), or
    None."""
    axes = tuple(a for a in ("pod", "data") if a in _mesh_axes())
    return axes or None


def constrain(x, *spec):
    """The identity: the reference's ``with_sharding_constraint`` hint has
    nothing to constrain in eager PyTorch, where each rank already holds
    its block."""
    return x
