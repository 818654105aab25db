"""Placement of the stacked banks on the launch mesh (port of the bank
half of ``repro/launch/sharding.py:160-237``).

The reference describes placement with ``NamedSharding``s
(``bank_shardings``, ``data_bank_shardings``) and lets XLA place the
blocks. The port places them itself: model shard ``sm``'s block of bank
rows lives on its owner cell ``(sm, 0)``, data shard ``sd``'s block of
device rows on ``(0, sd)``, and a cell on another device reads a copy
(:class:`Replicas`) that is refreshed when the owner's block changes.
Where the cells share a device the owner's tensors serve them all and no
copy is ever made.

The LM half of the reference module (``param_spec``,
``param_shardings``, ``auto_shardings``, ``lm_bank_shardings``,
``batch_spec``) belongs to the mode-B LM path and is not ported here.
"""
from __future__ import annotations

from typing import Any, Dict, Hashable, List, Tuple

import torch

from repro_torch.launch.mesh import (LaunchMesh, data_axis_size,
                                     model_axis_size)


def bank_rows_per_shard(m_cap: int, mesh: LaunchMesh) -> int:
    """Rows each model-axis shard owns; row ``m`` lives on shard
    ``m // rows_per_shard`` (a contiguous block)."""
    n = model_axis_size(mesh)
    if m_cap % n != 0:
        raise ValueError(
            f"max_models={m_cap} must divide evenly over the mesh's "
            f"model axis ({n} shards)")
    return m_cap // n


def data_rows_per_shard(n_cap: int, mesh: LaunchMesh) -> int:
    """Data-bank rows each ``data``-axis shard owns; row ``r`` lives on
    shard ``r // rows_per_shard``. ``DeviceDataBank`` rounds its capacity
    up to a multiple of the data axis before calling this, so the
    divisibility error only fires on hand-built layouts."""
    n = data_axis_size(mesh)
    if n_cap % n != 0:
        raise ValueError(
            f"data bank capacity={n_cap} must divide evenly over the "
            f"mesh's data axis ({n} shards)")
    return n_cap // n


def bank_devices(mesh: LaunchMesh) -> List[torch.device]:
    """The owner device of each model shard's bank block (the stand-in
    for ``bank_shardings``): cell ``(sm, 0)``."""
    return [mesh.device(sm, 0) for sm in range(model_axis_size(mesh))]


def data_bank_devices(mesh: LaunchMesh) -> List[torch.device]:
    """The owner device of each data shard's block of device rows (the
    stand-in for ``data_bank_shardings``): cell ``(0, sd)``."""
    return [mesh.device(0, sd) for sd in range(data_axis_size(mesh))]


class Replicas:
    """Copies of owner blocks on other devices. ``get(key, stamp,
    tensors, device)`` returns ``tensors`` themselves when they already
    live on ``device``; otherwise a copy on ``device``, made anew
    whenever the owner's ``stamp`` for ``key`` moved since the last copy.
    Each copy is a non-blocking device-to-device transfer ordered after
    the owner's writes on its stream."""

    def __init__(self):
        self._copies: Dict[Tuple[Hashable, torch.device],
                           Tuple[Any, Dict[str, torch.Tensor]]] = {}

    def get(self, key: Hashable, stamp: Any,
            tensors: Dict[str, torch.Tensor],
            device: torch.device) -> Dict[str, torch.Tensor]:
        if next(iter(tensors.values())).device == device:
            return tensors
        hit = self._copies.get((key, device))
        if hit is None or hit[0] != stamp:
            hit = (stamp, {k: v.to(device, non_blocking=True)
                           for k, v in tensors.items()})
            self._copies[(key, device)] = hit
        return hit[1]

    def clear(self) -> None:
        self._copies.clear()
