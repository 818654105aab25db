"""Sharding-hint context: explicit activation layouts on a tensor-parallel
mesh (port of ``repro/sharding_hints.py``).

The step builders set the context (``hints=True``), so model code keeps
its signatures; :func:`constrain` reads it. Patterns are tuples over
dims: ``"dp"`` (batch/data axes), ``"tp"`` (the ``model`` axis), ``None``
(unsharded); a dim that the axis does not divide stays unsharded.

The reference's ``constrain`` is a layout constraint for XLA: the values
stay. Here it is the same: outside the context, for a rank that does not
match, or on a plain tensor (a whole tensor lives on one device, which
is already a layout), it returns ``x`` itself. A sharded activation (a
:class:`~repro_torch.launch.tensor_parallel.Sharded`) is laid out to the
pattern's spec: its blocks are split over the cells or gathered, with
the same values.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional, Sequence, Tuple

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_hints",
                                                      default=None)


@contextlib.contextmanager
def sharding_hints(mesh: Optional[Any], dp_axes: Sequence[str] = ("data",)):
    if mesh is None:
        yield
        return
    token = _CTX.set((mesh, tuple(a for a in dp_axes
                                  if a in mesh.axis_names)))
    try:
        yield
    finally:
        _CTX.reset(token)


def active() -> bool:
    return _CTX.get() is not None


def constrain(x: Any, pattern: Tuple[Optional[str], ...]) -> Any:
    ctx = _CTX.get()
    if ctx is None or len(x.shape) != len(pattern):
        return x
    from repro_torch.launch.sharding import PartitionSpec
    from repro_torch.launch.tensor_parallel import Sharded
    if not isinstance(x, Sharded):
        return x
    mesh, dp = ctx
    tp = "model" if "model" in mesh.axis_names else None
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    spec = []
    for dim, p in zip(x.shape, pattern):
        if p == "dp" and dp and dim % dp_size == 0 and dim >= dp_size:
            spec.append(dp)
        elif p == "tp" and tp and dim % mesh.shape[tp] == 0 \
                and dim >= mesh.shape[tp]:
            spec.append(tp)
        else:
            spec.append(None)
    return x.relayout(PartitionSpec(*spec))
