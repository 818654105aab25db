"""Device-resident data bank (port of ``repro/data/bank.py`` for one data
shard: the static population and device churn).

Holds every device's train/val/test splits as one stacked ``(n_cap, n,
...)`` tensor pair per split on the server's device.

**Row placement.** Device id (control plane — stable for a device's
lifetime, what plans and score state index) and data row (layout) are
decoupled by ``row_of``. A joining device takes the lowest free row.
Unlike model rows, device rows are REUSED: a leaving device frees its
row and a later join may write over it (``n_cap`` bounds *concurrent*
devices, ``id_cap`` the ids ever claimed). Without churn the map is the
identity, the layout of ``partition.stack_devices``.

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

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.partition import DeviceData
from repro_torch.federated.simulation import to_device

SPLITS = ("train", "val", "test")


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
    #: one data shard (the reference's layout fields, which checkpoints
    #: record: a checkpoint of another layout restores by re-placement)
    n_shards = 1

    def __init__(self, data: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 device: torch.device, n_cap: Optional[int] = None,
                 id_cap: Optional[int] = None):
        """``data``: stacked device splits from ``partition.
        stack_devices`` — the initial population, placed on rows 0..N-1
        (identity map). Images stay float32 NHWC; labels become int64
        (the index type PyTorch's gathers take). ``n_cap``: total data
        rows (≥ N). ``id_cap``: device-id space size (≥ N; ids above the
        initial population are claimed by :meth:`add`)."""
        n0 = int(np.asarray(data["train"][0]).shape[0])
        cap = n_cap if n_cap is not None else n0
        if cap < n0:
            raise ValueError(f"n_cap={n_cap} < {n0} initial devices")
        self.n_cap = cap
        self.rows_per_shard = cap
        self.id_cap = id_cap if id_cap is not None else cap
        if self.id_cap < n0:
            raise ValueError(f"id_cap={id_cap} < {n0} initial devices")
        self.device = torch.device(device)
        self.splits: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        for k in SPLITS:
            xs, ys = (np.asarray(a) for a in data[k])
            if xs.shape[0] != n0:
                raise ValueError(f"{k} split has {xs.shape[0]} devices, "
                                 f"train has {n0}")
            self.splits[k] = (_stack(xs, np.float32, cap, self.device),
                              _stack(ys, np.int64, cap, self.device))
        self.row_of: Dict[int, int] = {d: d for d in range(n0)}
        self._row_owner: Dict[int, int] = {d: d for d in range(n0)}
        self._present: set = set(range(n0))
        self._next_id = n0
        self.version = 0

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

    def identity_map(self) -> bool:
        """True while device id == data row for every present device."""
        return all(self.row_of[d] == d for d in self._present)

    # -- placement ----------------------------------------------------------
    def _alloc_row(self) -> int:
        """The lowest free row: freed slots are REUSED (module
        docstring)."""
        used = {self.row_of[d] for d in self._present}
        for r in range(self.n_cap):
            if r not in used:
                return r
        raise IndexError(f"data bank is full (n_cap={self.n_cap})")

    # -- row writes ---------------------------------------------------------
    def _check_shapes(self, device: DeviceData) -> None:
        for k in SPLITS:
            xs = self.splits[k][0]
            x = np.asarray(getattr(device, k)[0])
            if x.shape != tuple(xs.shape[1:]):
                raise ValueError(f"{k} split shape {x.shape} != bank row "
                                 f"{tuple(xs.shape[1:])}")

    def _copy_row(self, r: int,
                  splits: Mapping[str, Tuple[np.ndarray, np.ndarray]]
                  ) -> None:
        """Overwrite row ``r`` of every split in place, each array staged
        through pinned memory and copied without blocking the host."""
        for k in SPLITS:
            xs, ys = self.splits[k]
            x, y = splits[k]
            xs[r].copy_(to_device(x, np.float32, self.device))
            ys[r].copy_(to_device(y, np.int64, self.device))

    def _write_row(self, r: int, device: DeviceData) -> None:
        self._copy_row(r, {k: getattr(device, k) for k in SPLITS})
        self.version += 1

    def add(self, device: DeviceData) -> int:
        """A device joins: claim the next device id, place its splits on
        the lowest free row (reusing a freed slot when one exists), and
        return the id."""
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
        """Adopt a checkpoint's id-keyed device splits. With ``row_of`` (a
        checkpoint of this one-shard layout) placement restores verbatim;
        otherwise each id, in sorted order, takes the lowest free row as a
        join does. Each named row is written in place into the existing
        split tensors through pinned memory; rows not named keep their
        (unreachable) content. ``version`` moves on once."""
        self._present = set()
        self.row_of = dict(row_of) if row_of is not None else {}
        self._next_id = next_id
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
