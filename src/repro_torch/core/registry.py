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

The genealogy serialises to the reference's JSON (``to_json`` /
``load_json``), which checkpoints carry.

The dict-style element access (``reg.params[m]``, ``m in reg.params``)
works identically in both modes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.federated.simulation import to_device
from repro_torch.models.common import Params


class StackedParamBank:
    """Device-resident parameter bank: ``tree`` maps each param name to a
    ``(m_cap, ...)`` tensor whose row ``m`` is model ``m``. Unlike the
    reference, which replaces its immutable arrays, rows are written IN
    PLACE: clones and the fused round (``index_copy_``) update the
    tensors of ``tree`` themselves.

    ``version`` counts host-side row writes (``__setitem__``: the initial
    model and clones; :meth:`restore`), not the round's own scatter: a
    pipelined executor's speculative training is stale once it changed.

    The reference's placement state, as its checkpoints record it, has a
    fixed form here: one shard of ``m_cap`` rows, ``row_of`` the identity
    over every id ever written (``_used_rows``: rows of dead models stay
    used, as there)."""

    n_shards = 1

    def __init__(self, m_cap: int, template: Params):
        self.m_cap = m_cap
        self.rows_per_shard = m_cap
        self.version = 0
        self.tree: Params = {
            k: torch.zeros((m_cap,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device)
            for k, v in template.items()}
        self._present: set = set()
        self._used_rows: set = set()

    @property
    def row_of(self) -> Dict[int, int]:
        return {m: m for m in sorted(self._used_rows)}

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
        self._used_rows.add(m)
        self.version += 1

    def pop(self, m: int, default: Any = None) -> Any:
        """Mark row ``m`` absent. Its storage stays (masked, not freed)."""
        self._present.discard(m)
        return default

    def restore(self, rows: Dict[int, Dict[str, np.ndarray]],
                row_of: Optional[Dict[int, int]] = None,
                used_rows: Optional[set] = None,
                load_ewma: Any = None) -> None:
        """Adopt a checkpoint's id-keyed host rows: each id's row is
        written IN PLACE into the existing ``tree`` tensors (through
        pinned memory, so the host does not wait for the stream), the
        present set becomes exactly ``rows``' ids and ``version`` moves
        on. Rows not named keep their content. ``row_of`` (a checkpoint
        of the same one-shard layout) must be the identity, the only
        placement this bank has; without it, as after a checkpoint of
        another shard layout, every id takes its own row all the same.
        ``used_rows`` restores the ids ever written; ``load_ewma`` (the
        reference's per-shard placement load) has nothing to choose
        between with one shard and is not kept."""
        moved = {m: r for m, r in (row_of or {}).items() if m != r}
        if moved:
            raise ValueError(f"bank rows are model ids: row_of {moved}")
        if any(not 0 <= m < self.m_cap for m in rows):
            raise IndexError(f"ids {sorted(rows)} beyond m_cap={self.m_cap}")
        for m in sorted(rows):
            for k, v in self.tree.items():
                src = np.asarray(rows[m][k])
                v[m].copy_(to_device(src, src.dtype, v.device))
        self._present = set(rows)
        self._used_rows = (set(used_rows) if used_rows is not None
                           else set(row_of or ())) | set(rows)
        self.version += 1


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

    @property
    def stacked(self) -> Optional[Params]:
        """The device-resident (m_cap, ...) param dict, or None in dict
        mode."""
        return self.params.tree if isinstance(self.params,
                                              StackedParamBank) else None

    @property
    def total_created(self) -> int:
        """M in the paper: all models ever created (deleted included)."""
        return len(self.entries)

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

    def to_json(self) -> Dict[str, Any]:
        return {
            "m_cap": self.m_cap,
            "entries": [
                {"id": e.model_id, "parent": e.parent, "birth": e.birth_round,
                 "alive": e.alive, "death": e.death_round}
                for e in self.entries.values()
            ],
        }

    def load_json(self, state: Dict[str, Any]) -> None:
        """Rebuild the genealogy from :meth:`to_json` output (params are
        restored separately — deleted ids keep their entry, never their
        params). ``m_cap`` must match: id allocation counts entries."""
        if state["m_cap"] != self.m_cap:
            raise ValueError(
                f"registry m_cap mismatch: checkpoint {state['m_cap']} "
                f"!= server {self.m_cap}")
        self.entries = {
            e["id"]: ModelEntry(e["id"], e["parent"], e["birth"],
                                alive=e["alive"], death_round=e["death"])
            for e in state["entries"]}

    @classmethod
    def from_json(cls, state: Dict[str, Any]) -> "ModelRegistry":
        reg = cls(m_cap=state["m_cap"])
        reg.load_json(state)
        return reg
