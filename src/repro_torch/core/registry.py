"""Server-side model registry: genealogy and liveness of global models
(port of ``repro/core/registry.py``, single shard).

Model ids are stable for the lifetime of a run (the paper counts deleted
models in M). Two parameter storage modes:

* **dict** (the bare constructor's default): ``params`` is a plain
  ``{model_id: param dict}``; params of dead models are dropped.
* **stacked** (``ModelRegistry.create(..., stacked=True)`` — the mode-A
  simulation server): params live in ONE ``StackedParamBank`` of
  ``(m_cap, ...)`` tensors on the server's device. With one shard a
  model's bank row is its id (the reference's ``row_of`` is the
  identity), liveness is a mask over rows, and dead rows stay allocated.

The dict-style element access (``reg.params[m]``, ``m in reg.params``)
works identically in both modes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.models.common import Params


class StackedParamBank:
    """Device-resident parameter bank: ``tree`` maps each param name to a
    ``(m_cap, ...)`` tensor whose row ``m`` is model ``m``. Unlike the
    reference, which replaces its immutable arrays, rows are written IN
    PLACE: clones and the fused round (``index_copy_``) update the
    tensors of ``tree`` themselves.

    ``version`` counts host-side row writes (``__setitem__``: the initial
    model and clones), not the round's own scatter: a pipelined
    executor's speculative training is stale once it changed."""

    def __init__(self, m_cap: int, template: Params):
        self.m_cap = m_cap
        self.version = 0
        self.tree: Params = {
            k: torch.zeros((m_cap,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device)
            for k, v in template.items()}
        self._present: set = set()

    def __contains__(self, m: int) -> bool:
        return m in self._present

    def __getitem__(self, m: int) -> Params:
        """Model ``m``'s params as VIEWS of its bank row: a later in-place
        round update shows through them."""
        if m not in self._present:
            raise KeyError(m)
        return {k: v[m] for k, v in self.tree.items()}

    def __setitem__(self, m: int, row: Params) -> None:
        if not 0 <= m < self.m_cap:
            raise IndexError(m)
        for k, v in self.tree.items():
            v[m].copy_(torch.as_tensor(row[k]))
        self._present.add(m)
        self.version += 1

    def pop(self, m: int, default: Any = None) -> Any:
        """Mark row ``m`` absent. Its storage stays (masked, not freed)."""
        self._present.discard(m)
        return default


@dataclass
class ModelEntry:
    model_id: int
    parent: Optional[int]
    birth_round: int
    alive: bool = True
    death_round: Optional[int] = None


@dataclass
class ModelRegistry:
    m_cap: int
    entries: Dict[int, ModelEntry] = field(default_factory=dict)
    params: Any = field(default_factory=dict)

    @classmethod
    def create(cls, initial_params: Params, m_cap: int = 16,
               stacked: bool = False) -> "ModelRegistry":
        reg = cls(m_cap=m_cap)
        if stacked:
            reg.params = StackedParamBank(m_cap, initial_params)
        reg.entries[0] = ModelEntry(0, None, 0)
        reg.params[0] = initial_params
        return reg

    def live_ids(self) -> List[int]:
        return sorted(m for m, e in self.entries.items() if e.alive)

    def allocate(self, parent: int, birth_round: int) -> Optional[int]:
        """Next free slot id, or None when at capacity."""
        mid = len(self.entries)
        if mid >= self.m_cap:
            return None
        self.entries[mid] = ModelEntry(mid, parent, birth_round)
        return mid

    def clone(self, parent: int, birth_round: int, clone_params: Params
              ) -> Optional[int]:
        mid = self.allocate(parent, birth_round)
        if mid is not None:
            self.params[mid] = clone_params
        return mid

    def kill(self, model_id: int, round_: int) -> None:
        e = self.entries[model_id]
        if e.alive:
            e.alive = False
            e.death_round = round_
            self.params.pop(model_id, None)

    def genealogy(self) -> Dict[int, Optional[int]]:
        return {m: e.parent for m, e in self.entries.items()}
