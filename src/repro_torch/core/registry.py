"""Server-side model registry: genealogy and liveness of global models
(port of ``repro/core/registry.py``).

Model ids are stable for the lifetime of a run (the paper counts deleted
models in M). Two parameter storage modes:

* **dict** (the bare constructor's default): ``params`` is a plain
  ``{model_id: param dict}``; params of dead models are dropped.
* **stacked** (``ModelRegistry.create(..., stacked=True)`` — the mode-A
  simulation server): params live in ONE ``StackedParamBank`` of
  ``(m_cap, ...)`` rows, split into contiguous blocks over the model
  shards of the launch mesh (one block without a mesh). ``row_of``
  places each model id on a row; liveness is a mask over rows, and dead
  rows stay allocated. With ``shardings`` (the LM trainer on a
  tensor-parallel mesh, ``launch.sharding.lm_bank_shardings``) each
  leaf's ``(m_cap, ...)`` tensor is a
  :class:`~repro_torch.launch.tensor_parallel.Sharded` leaf instead: the
  row axis replicated, the inner dims split by the LM specs, so every
  cell keeps all ``m_cap`` rows of its piece.

The genealogy serialises to the reference's JSON (``to_json`` /
``load_json``), which checkpoints carry.

The dict-style element access (``reg.params[m]``, ``m in reg.params``)
works identically in both modes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.federated.simulation import to_device
from repro_torch.launch.sharding import Replicas
from repro_torch.launch.tensor_parallel import Sharded
from repro_torch.models.common import Params


class StackedParamBank:
    """Device-resident parameter bank: ``tree`` maps each param name to a
    ``(m_cap, ...)`` tensor of model rows. Unlike the reference, which
    replaces its immutable arrays, rows are written IN PLACE: clones, the
    round's scatter (``index_copy_``) and restores update the tensors of
    the bank themselves.

    **Shards.** With ``n_shards`` > 1 the rows split into contiguous
    blocks of ``rows_per_shard``, one per model shard of the launch mesh;
    block ``s`` lives on ``devices[s]`` (:meth:`block`), and a cell on
    another device reads a copy refreshed after every write to the block
    (:meth:`resident`). Where every block shares one device the blocks
    are views of the ``(m_cap, ...)`` tensors of ``tree``.

    **Row placement** (the reference's, ``repro/core/registry.py:38-290``):
    model id (control plane) and bank row (layout) are decoupled by
    ``row_of``. A model's first write allocates its row on the shard with
    the lowest observed WORK — an EWMA of per-shard pair load fed back by
    the executors (:meth:`note_pair_load`), compared in units of the mean
    load (:meth:`_hotness`) and falling back to the present-row count
    while loads tie. Rows are never recycled except by :meth:`migrate`,
    which moves a row to another shard; :meth:`rebalance` migrates one
    row off a hot shard. With one shard the policy is the identity map
    over ids as they are created (ids are sequential and never reused).

    ``version`` counts host-side row writes (``__setitem__``: the initial
    model and clones; :meth:`migrate`; :meth:`restore`), not the round's
    own scatter, the LM engine's in-place training or :meth:`swap`: a
    pipelined executor's speculative training is stale once it changed,
    and the serving gateway re-routes when it moves."""

    #: EWMA decay for the observed per-shard pair load (one round's
    #: observation carries half the weight; ~4 rounds of history).
    LOAD_DECAY = 0.5

    def __init__(self, m_cap: int, template: Params, n_shards: int = 1,
                 devices: Optional[Sequence[torch.device]] = None,
                 shardings: Optional[Dict[str, Any]] = None):
        self.m_cap = m_cap
        self.n_shards = n_shards
        self.rows_per_shard = m_cap // max(n_shards, 1)
        first = next(iter(template.values()))
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None
                        else [first.device] * n_shards)
        if len(self.devices) != n_shards:
            raise ValueError(f"{len(self.devices)} devices for "
                             f"{n_shards} shards")
        rps = self.rows_per_shard

        def zeros(v: torch.Tensor, rows: int, device) -> torch.Tensor:
            return torch.zeros((rows,) + tuple(v.shape), dtype=v.dtype,
                               device=device)

        self._colocated = len(set(self.devices)) == 1
        if shardings is not None:
            # the tensor-parallel LM bank (module docstring): one block
            if n_shards != 1:
                raise ValueError("a sharded LM bank has one row block")
            self._tree = {
                k: Sharded.zeros(shardings[k].mesh, shardings[k].spec,
                                 (m_cap,) + tuple(v.shape), v.dtype)
                for k, v in template.items()}
            self._blocks = [self._tree]
            self.devices = [shardings[next(iter(template))].mesh.device(0)]
        elif self._colocated:
            self._tree: Optional[Params] = {
                k: zeros(v, m_cap, self.devices[0])
                for k, v in template.items()}
            self._blocks = [{k: v[s * rps:(s + 1) * rps]
                             for k, v in self._tree.items()}
                            for s in range(n_shards)]
        else:
            self._tree = None
            self._blocks = [{k: zeros(v, rps, self.devices[s])
                             for k, v in template.items()}
                            for s in range(n_shards)]
        self._stamps = [0] * n_shards
        self._replicas = Replicas()
        self._present: set = set()
        self.row_of: Dict[int, int] = {}
        self._used_rows: set = set()
        self.load_ewma = np.zeros(max(n_shards, 1))
        self.version = 0

    # -- storage ------------------------------------------------------------
    @property
    def tree(self) -> Params:
        """The ``(m_cap, ...)`` tensors (shard blocks in row order). With
        blocks on several devices, a copy gathered on the first one."""
        if self._tree is not None:
            return self._tree
        dev = self.devices[0]
        return {k: torch.cat([b[k].to(dev) for b in self._blocks])
                for k in self._blocks[0]}

    def block(self, s: int) -> Params:
        """Shard ``s``'s ``(rows_per_shard, ...)`` tensors on its owner
        device; the sharded round scatters into them in place and then
        calls :meth:`mark_written`."""
        return self._blocks[s]

    def resident(self, s: int, device: torch.device) -> Params:
        """Shard ``s``'s block as a cell on ``device`` reads it: the
        block itself on its owner's device, else an up-to-date copy."""
        return self._replicas.get(s, self._stamps[s], self._blocks[s],
                                  torch.device(device))

    def mark_written(self, s: int) -> None:
        """Shard ``s``'s block changed: copies of it are stale."""
        self._stamps[s] += 1

    def _locate(self, r: int) -> Tuple[int, int]:
        return divmod(r, self.rows_per_shard)

    def _row_views(self, r: int) -> Params:
        s, j = self._locate(r)
        return {k: v[j] for k, v in self._blocks[s].items()}

    # -- placement ----------------------------------------------------------
    def note_pair_load(self, per_shard_pairs: Any) -> None:
        """Fold one round's observed per-shard work-pair counts into the
        placement EWMA (executors call this once per dispatched round).
        Fully-decayed residue snaps to zero so long-idle shards tie and
        the population-count fallback decides again."""
        self.load_ewma = (self.LOAD_DECAY * self.load_ewma
                          + (1.0 - self.LOAD_DECAY)
                          * np.asarray(per_shard_pairs, float))
        self.load_ewma[self.load_ewma < 1e-6] = 0.0

    def shard_of(self, m: int) -> int:
        return self.row_of[m] // self.rows_per_shard

    def _hotness(self, s: int) -> int:
        """Shard load in units of the MEAN load, rounded: balanced
        traffic ties at 1 and falls through to the population count, so
        participation noise cannot reshuffle placement; only genuinely
        hot (>=~1.5x mean) or idle shards separate."""
        mean = float(self.load_ewma.mean())
        if mean <= 1e-9:
            return 0
        return round(float(self.load_ewma[s]) / mean)

    def _alloc_row(self, m: int) -> int:
        """Work-aware least-loaded-shard placement (class docstring)."""
        rps = self.rows_per_shard
        best = None
        for s in range(self.n_shards):
            block = range(s * rps, (s + 1) * rps)
            used = sum(1 for r in block if r in self._used_rows)
            if used == rps:
                continue                       # shard full
            present = sum(1 for mm in self._present
                          if self.row_of[mm] // rps == s)
            key = (self._hotness(s), present, used, s)
            if best is None or key < best[0]:
                best = (key, s)
        if best is None:
            raise IndexError(f"bank is full (m_cap={self.m_cap}): {m}")
        s = best[1]
        return min(r for r in range(s * rps, (s + 1) * rps)
                   if r not in self._used_rows)

    # -- row access -----------------------------------------------------------
    def __contains__(self, m: int) -> bool:
        return m in self._present

    def __getitem__(self, m: int) -> Params:
        """Model ``m``'s params as VIEWS of its bank row: a later in-place
        round update shows through them."""
        if m not in self._present:
            raise KeyError(m)
        return self._row_views(self.row_of[m])

    def __setitem__(self, m: int, row: Params) -> None:
        if not 0 <= m < self.m_cap:
            raise IndexError(m)
        r = self.row_of.get(m)
        if r is None:
            r = self._alloc_row(m)
            self.row_of[m] = r
            self._used_rows.add(r)
        for k, v in self._row_views(r).items():
            src = row[k]
            v.copy_(src if isinstance(src, Sharded) else torch.as_tensor(src))
        self._present.add(m)
        self.mark_written(r // self.rows_per_shard)
        self.version += 1

    def pop(self, m: int, default: Any = None) -> Any:
        """Mark row ``m`` absent. Its storage stays (masked, not freed)."""
        self._present.discard(m)
        return default

    # -- row migration (work rebalancing) -----------------------------------
    def migrate(self, m: int, dest_shard: int) -> int:
        """Move a present model's row to ``dest_shard``: one row copy
        between the blocks plus a ``row_of`` update, pure layout. The
        vacated row is freed for later placements; the version bump
        invalidates any speculative train batch built on the old
        placement."""
        if m not in self._present:
            raise KeyError(m)
        rps = self.rows_per_shard
        r_old = self.row_of[m]
        free = [r for r in range(dest_shard * rps, (dest_shard + 1) * rps)
                if r not in self._used_rows]
        if not free:
            raise IndexError(f"shard {dest_shard} has no free row")
        r_new = free[0]
        src = self._row_views(r_old)
        for k, v in self._row_views(r_new).items():
            v.copy_(src[k])
        self.mark_written(dest_shard)
        self._used_rows.discard(r_old)
        self._used_rows.add(r_new)
        self.row_of[m] = r_new
        self.version += 1
        return r_new

    def rebalance(self, threshold: float) -> "list[tuple[int, int, int]]":
        """Migrate at most ONE row per call off the hottest shard when its
        pair-load EWMA exceeds ``threshold ×`` the mean load. The moved
        model is the hot shard's highest id, the destination the coldest
        shard with a free row. The whole EWMA then resets (the observed
        loads described the old placement), which rules out a migration
        cascade. Returns ``[(model, from_shard, to_shard)]`` (empty when
        balanced)."""
        mean = float(self.load_ewma.mean())
        if mean <= 1e-9 or self.n_shards < 2:
            return []
        hot = int(np.argmax(self.load_ewma))
        if float(self.load_ewma[hot]) <= threshold * mean:
            return []
        rps = self.rows_per_shard
        residents = [m for m in self._present
                     if self.row_of[m] // rps == hot]
        if len(residents) < 2:
            return []                    # nothing to drain
        dest = None
        for s in range(self.n_shards):
            if s == hot:
                continue
            block = range(s * rps, (s + 1) * rps)
            if all(r in self._used_rows for r in block):
                continue
            key = (self._hotness(s), float(self.load_ewma[s]), s)
            if dest is None or key < dest[0]:
                dest = (key, s)
        if dest is None:
            return []
        m = max(residents)
        self.migrate(m, dest[1])
        self.load_ewma[:] = 0.0
        return [(m, hot, dest[1])]

    # -- elastic restore ----------------------------------------------------
    def restore(self, rows: Dict[int, Dict[str, np.ndarray]],
                row_of: Optional[Dict[int, int]] = None,
                used_rows: Optional[set] = None,
                load_ewma: Any = None) -> None:
        """Adopt a checkpoint's id-keyed host rows, re-placing them on
        THIS bank's shard layout. With ``row_of``/``used_rows`` (a
        checkpoint of the same ``n_shards`` and ``rows_per_shard``)
        placement and the load EWMA restore verbatim; without them (a
        checkpoint of another layout) each id re-places in sorted order
        through :meth:`_alloc_row`, from a cold EWMA. Each row is written
        IN PLACE into the existing block tensors through pinned memory,
        so the host does not wait for the stream; rows not named keep
        their content, and ``version`` moves on once."""
        self._present = set()
        self.row_of = dict(row_of) if row_of is not None else {}
        self._used_rows = (set(used_rows) if used_rows is not None
                           else set(self.row_of.values()))
        self.load_ewma = (np.asarray(load_ewma, float).copy()
                          if load_ewma is not None
                          else np.zeros(max(self.n_shards, 1)))
        for m in sorted(rows):
            r = self.row_of.get(m)
            if r is None:
                r = self._alloc_row(m)
                self.row_of[m] = r
                self._used_rows.add(r)
            if not 0 <= r < self.m_cap:
                raise IndexError(f"row {r} of model {m} beyond "
                                 f"m_cap={self.m_cap}")
            self._present.add(m)
            for k, v in self._row_views(r).items():
                src = np.asarray(rows[m][k])
                v.copy_(to_device(src, src.dtype, v.device))
            self.mark_written(r // self.rows_per_shard)
        self.version += 1

    def gathered(self, device: Any = None) -> "StackedParamBank":
        """A one-block bank on ``device`` (default the first device) with
        this bank's rows gathered whole, the same row placement, presence
        and ``version``: a tensor-parallel bank served on one device."""
        dev = torch.device(device) if device is not None else self.devices[0]
        tree = {k: v.full(dev) if isinstance(v, Sharded) else v.to(dev)
                for k, v in self.tree.items()}
        out = StackedParamBank(self.m_cap, {k: v[0] for k, v in tree.items()})
        out.swap(tree)
        out._present, out._used_rows = set(self._present), set(self._used_rows)
        out.row_of, out.version = dict(self.row_of), self.version
        return out

    def swap(self, new_tree: Params) -> None:
        """Adopt ``new_tree`` (``(m_cap, ...)`` tensors, every leaf of the
        bank) as the bank's content, as the reference's ``swap`` adopts a
        fused step's output. Row presence and placement are unchanged and
        ``version`` does NOT move: a training write re-routes nothing
        (the serving gateway's routing cache keys on ``version``). The
        tensors are copied IN PLACE, so row views and the executors'
        references stay valid; copies on other devices go stale."""
        rps = self.rows_per_shard
        for s, block in enumerate(self._blocks):
            for k, v in block.items():
                v.copy_(new_tree[k][s * rps:(s + 1) * rps])
            self.mark_written(s)


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
               stacked: bool = False, n_shards: int = 1,
               devices: Optional[Sequence[torch.device]] = None,
               shardings: Optional[Dict[str, Any]] = None
               ) -> "ModelRegistry":
        """``devices``: the owner device of each of the ``n_shards``
        shards of a stacked bank (default: the params' device);
        ``shardings``: a tensor-parallel LM bank's leaf shardings."""
        reg = cls(m_cap=m_cap)
        if stacked:
            reg.params = StackedParamBank(m_cap, initial_params, n_shards,
                                          devices, shardings)
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
