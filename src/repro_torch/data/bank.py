"""Device-resident data bank (port of ``repro/data/bank.py``: the static
population, device churn and the placement over data shards).

Holds every device's train/val/test splits as one stacked ``(n_cap, n,
...)`` tensor pair per split. With a launch ``mesh`` whose ``data`` axis
has several shards, the row axis splits into contiguous blocks of
``rows_per_shard``, block ``sd`` on the mesh's cell ``(0, sd)``
(:meth:`block`); a cell of another model shard on another device reads a
copy refreshed after every row write (:meth:`resident`). Where the
blocks share a device they are views of one tensor per split.

**Row placement.** Device id (control plane — stable for a device's
lifetime, what plans and score state index) and data row (layout) are
decoupled by ``row_of``. A joining device's row lands on the data shard
with the lowest observed pair-load EWMA (in units of the mean load, so
balanced traffic ties), then the fewest present devices, ties low; then
on that shard's lowest free row. Unlike model rows, device rows are
REUSED: a leaving device frees its row and a later join may write over it
(``n_cap`` bounds *concurrent* devices, ``id_cap`` the ids ever claimed).
With one data shard and no churn the map is the identity, the layout of
``partition.stack_devices``.

``version`` counts row WRITES (joins, label-drift rewrites, a
checkpoint's :meth:`restore`): the pipelined executors record it when
they speculate a next-round training and invalidate the speculation when
the data under it was rewritten (leaves need no bump — a departed
device's pairs drop out of the true plan and repair zero-weights them).
Row writes reach the card through pinned memory
(``simulation.to_device``), so they never wait for work already on the
stream.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.partition import DeviceData
from repro_torch.federated.simulation import to_device
from repro_torch.launch.mesh import LaunchMesh, data_axis_size
from repro_torch.launch.sharding import (Replicas, data_bank_devices,
                                         data_rows_per_shard)

SPLITS = ("train", "val", "test")

Split = Tuple[torch.Tensor, torch.Tensor]


def _stack(a: np.ndarray, dtype: type, cap: int,
           device: torch.device) -> torch.Tensor:
    """``a`` as ``dtype``, padded with zero rows to ``cap`` rows, on
    ``device``."""
    a = np.asarray(a, dtype)
    if cap > a.shape[0]:
        pad = np.zeros((cap - a.shape[0],) + a.shape[1:], dtype)
        a = np.concatenate([a, pad], axis=0)
    return torch.as_tensor(a, device=device)


class DeviceDataBank:
    #: EWMA decay for observed per-data-shard pair load (mirrors
    #: ``StackedParamBank.LOAD_DECAY`` — one round carries half weight).
    LOAD_DECAY = 0.5

    def __init__(self, data: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 device: torch.device, n_cap: Optional[int] = None,
                 id_cap: Optional[int] = None,
                 mesh: Optional[LaunchMesh] = None):
        """``data``: stacked device splits from ``partition.
        stack_devices`` — the initial population, placed on rows 0..N-1
        (identity map). Images stay float32 NHWC; labels become int64
        (the index type PyTorch's gathers take). ``n_cap``: total data
        rows (≥ N; rounded up to a multiple of the mesh's data axis).
        ``id_cap``: device-id space size (≥ N; ids above the initial
        population are claimed by :meth:`add`). ``mesh``: the launch
        mesh; its data axis sets the shards and its cells ``(0, sd)``
        their devices (``device`` then goes unused)."""
        n0 = int(np.asarray(data["train"][0]).shape[0])
        self.n_shards = data_axis_size(mesh) if mesh is not None else 1
        cap = n_cap if n_cap is not None else n0
        # round capacity up so rows divide evenly over the data shards
        cap = -(-cap // self.n_shards) * self.n_shards
        if cap < n0:
            raise ValueError(f"n_cap={n_cap} < {n0} initial devices")
        self.n_cap = cap
        self.rows_per_shard = (data_rows_per_shard(cap, mesh)
                               if mesh is not None else cap)
        self.id_cap = id_cap if id_cap is not None else cap
        if self.id_cap < n0:
            raise ValueError(f"id_cap={id_cap} < {n0} initial devices")
        self.devices = (data_bank_devices(mesh) if mesh is not None
                        else [torch.device(device)])
        self.device = self.devices[0]
        rps = self.rows_per_shard
        full: Dict[str, Split] = {}
        for k in SPLITS:
            xs, ys = (np.asarray(a) for a in data[k])
            if xs.shape[0] != n0:
                raise ValueError(f"{k} split has {xs.shape[0]} devices, "
                                 f"train has {n0}")
            full[k] = (_stack(xs, np.float32, cap, torch.device("cpu")),
                       _stack(ys, np.int64, cap, torch.device("cpu")))
        self._splits: Optional[Dict[str, Split]] = None
        if len(set(self.devices)) == 1:
            self._splits = {k: (x.to(self.device), y.to(self.device))
                            for k, (x, y) in full.items()}
            self._blocks = [{k: (x[s * rps:(s + 1) * rps],
                                 y[s * rps:(s + 1) * rps])
                             for k, (x, y) in self._splits.items()}
                            for s in range(self.n_shards)]
        else:
            self._blocks = [{k: (x[s * rps:(s + 1) * rps].to(dev),
                                 y[s * rps:(s + 1) * rps].to(dev))
                             for k, (x, y) in full.items()}
                            for s, dev in enumerate(self.devices)]
        self._stamps = [0] * self.n_shards
        self._replicas = Replicas()
        self.row_of: Dict[int, int] = {d: d for d in range(n0)}
        self._row_owner: Dict[int, int] = {d: d for d in range(n0)}
        self._present: set = set(range(n0))
        self._next_id = n0
        self.version = 0
        self.load_ewma = np.zeros(max(self.n_shards, 1))

    # -- storage ------------------------------------------------------------
    @property
    def splits(self) -> Dict[str, Split]:
        """Every split's ``(n_cap, ...)`` tensor pair (the data shards'
        blocks in row order). With blocks on several devices, a copy
        gathered on the first one."""
        if self._splits is not None:
            return self._splits
        return {k: tuple(torch.cat([b[k][i].to(self.device)
                                    for b in self._blocks])
                         for i in (0, 1))
                for k in SPLITS}

    def block(self, sd: int, split: str) -> Split:
        """Data shard ``sd``'s ``(rows_per_shard, ...)`` pair of ``split``
        on its owner device."""
        return self._blocks[sd][split]

    def resident(self, sd: int, split: str, device: torch.device) -> Split:
        """Data shard ``sd``'s block of ``split`` as a cell on ``device``
        reads it: the block itself on its owner's device, else an
        up-to-date copy."""
        x, y = self._blocks[sd][split]
        got = self._replicas.get((sd, split), self._stamps[sd],
                                 {"x": x, "y": y}, torch.device(device))
        return got["x"], got["y"]

    def note_pair_load(self, per_shard_pairs: Any) -> None:
        """Fold one round's observed per-data-shard work-pair counts into
        the placement EWMA (the 2-D executor calls this once per
        dispatched round). Fully-decayed residue snaps to zero so
        long-idle shards tie and the present-count fallback decides
        again."""
        self.load_ewma = (self.LOAD_DECAY * self.load_ewma
                          + (1.0 - self.LOAD_DECAY)
                          * np.asarray(per_shard_pairs, float))
        self.load_ewma[self.load_ewma < 1e-6] = 0.0

    def _hotness(self, s: int) -> int:
        """Shard pair load in units of the MEAN load, rounded — the
        quantization of ``StackedParamBank._hotness``."""
        mean = float(self.load_ewma.mean())
        if mean <= 1e-9:
            return 0
        return round(float(self.load_ewma[s]) / mean)

    # -- introspection ------------------------------------------------------
    def __contains__(self, device_id: int) -> bool:
        return device_id in self._present

    def present_ids(self) -> List[int]:
        return sorted(self._present)

    @property
    def n_present(self) -> int:
        return len(self._present)

    @property
    def next_id(self) -> int:
        """The id the next :meth:`add` will claim (ids are sequential,
        which is what makes future presence masks computable)."""
        return self._next_id

    def shard_of(self, device_id: int) -> int:
        return self.row_of[device_id] // self.rows_per_shard

    def identity_map(self) -> bool:
        """True while device id == data row for every present device."""
        return all(self.row_of[d] == d for d in self._present)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for b in self._blocks for pair in b.values()
                   for t in pair)

    def bytes_per_shard(self) -> int:
        """Split bytes resident per data shard — what the 2-D mesh shrinks
        S_data-fold against the replicated layout."""
        return self.nbytes() // self.n_shards

    # -- placement ----------------------------------------------------------
    def _alloc_row(self) -> int:
        """Churn-aware least-loaded data shard: observed pair-load EWMA
        first (in mean-load units, so balanced traffic ties), present-row
        count as the tiebreak (ties low), then the lowest free row inside
        the winning shard — freed slots are REUSED (module docstring)."""
        used = {self.row_of[d] for d in self._present}
        rps = self.rows_per_shard
        best = None
        for s in range(self.n_shards):
            block = range(s * rps, (s + 1) * rps)
            free = [r for r in block if r not in used]
            if not free:
                continue
            key = (self._hotness(s), len(block) - len(free), s)
            if best is None or key < best[0]:
                best = (key, free[0])
        if best is None:
            raise IndexError(f"data bank is full (n_cap={self.n_cap})")
        return best[1]

    # -- row writes ---------------------------------------------------------
    def _check_shapes(self, device: DeviceData) -> None:
        for k in SPLITS:
            xs = self._blocks[0][k][0]
            x = np.asarray(getattr(device, k)[0])
            if x.shape != tuple(xs.shape[1:]):
                raise ValueError(f"{k} split shape {x.shape} != bank row "
                                 f"{tuple(xs.shape[1:])}")

    def _copy_row(self, r: int,
                  splits: Mapping[str, Tuple[np.ndarray, np.ndarray]]
                  ) -> None:
        """Overwrite row ``r`` of every split in place, each array staged
        through pinned memory and copied without blocking the host."""
        sd, j = divmod(r, self.rows_per_shard)
        for k in SPLITS:
            xs, ys = self._blocks[sd][k]
            x, y = splits[k]
            xs[j].copy_(to_device(x, np.float32, xs.device))
            ys[j].copy_(to_device(y, np.int64, ys.device))
        self._stamps[sd] += 1

    def _write_row(self, r: int, device: DeviceData) -> None:
        self._copy_row(r, {k: getattr(device, k) for k in SPLITS})
        self.version += 1

    def add(self, device: DeviceData) -> int:
        """A device joins: claim the next device id, place its splits on
        the least-loaded shard (reusing a freed slot when one exists),
        and return the id."""
        if self._next_id >= self.id_cap:
            raise IndexError(f"device id space full (id_cap={self.id_cap})")
        self._check_shapes(device)
        d = self._next_id
        r = self._alloc_row()
        self._next_id += 1
        stale = self._row_owner.get(r)
        if stale is not None and stale != d:
            self.row_of.pop(stale, None)      # slot reuse: drop the old map
        self.row_of[d] = r
        self._row_owner[r] = d
        self._present.add(d)
        self._write_row(r, device)
        return d

    def update(self, device_id: int, device: DeviceData) -> None:
        """Label drift: rewrite a present device's splits in place."""
        if device_id not in self._present:
            raise KeyError(device_id)
        self._check_shapes(device)
        self._write_row(self.row_of[device_id], device)

    def remove(self, device_id: int) -> None:
        """A device leaves: free its slot for reuse. Its rows keep their
        (now unreachable) data — an in-flight speculative batch may still
        read them, and repair zero-weights those pairs. ``row_of`` keeps
        the stale mapping until the slot is reused, so a reader resolving
        a just-departed device still finds its row."""
        if device_id not in self._present:
            raise KeyError(device_id)
        self._present.discard(device_id)

    # -- elastic restore ----------------------------------------------------
    def restore(self, devices: Dict[int, Dict[str, Tuple[np.ndarray,
                                                         np.ndarray]]],
                next_id: int, row_of: Optional[Dict[int, int]] = None
                ) -> None:
        """Adopt a checkpoint's id-keyed device splits, re-placing them on
        THIS bank's data-shard layout. With ``row_of`` (a checkpoint of
        the same ``n_shards`` and ``rows_per_shard``) placement restores
        verbatim; otherwise each id, in sorted order, places through
        :meth:`_alloc_row` as a join does. The observed loads described
        the pre-restore placement and restart cold. Each named row is
        written in place into the existing split tensors through pinned
        memory; rows not named keep their (unreachable) content.
        ``version`` moves on once."""
        self._present = set()
        self.row_of = dict(row_of) if row_of is not None else {}
        self._next_id = next_id
        self.load_ewma = np.zeros(max(self.n_shards, 1))
        for d in sorted(devices):
            r = self.row_of.get(d)
            if r is None:
                r = self._alloc_row()      # counts already-placed rows
                self.row_of[d] = r
            if not 0 <= r < self.n_cap:
                raise IndexError(f"row {r} of device {d} beyond "
                                 f"n_cap={self.n_cap}")
            self._present.add(d)
            self._copy_row(r, devices[d])
        self._row_owner = {r: d for d, r in self.row_of.items()
                           if d in self._present}
        self.version += 1
