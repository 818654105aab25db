"""Per-model KV/state cache pools for the serving gateway (port of
``repro/serve/kv_pool.py``; DESIGN.md §15, paged int8 storage §16).

Each live model is backed by ONE pool of ``lanes`` single-request decode
caches (each the ``batch=1`` layout of ``models.transformer.
init_lm_caches``), so a model group's whole decode batch is one
device-resident dict of tensors with a leading lane axis and a request's
admission/retirement is a single lane index. Two storage backends share
the interface:

* :class:`KVPool` — dense: the stacked caches are resident at compute
  dtype; ``read``/``write`` are passthroughs.
* :class:`PagedKVPool` — paged int8: ring-slot leaves (attention K/V,
  MLA latents) are stored as fixed-size pages of int8 rows + one f16
  scale per slot, allocated from a :class:`PageArena` shared across
  every pool of the same model family (target AND draft pools draw from
  the same arenas), quantized on write and dequantized on read.
  Recurrent states / positions / ring indices are the dense residue —
  they are O(1) per lane, not O(max_len).

Leaves are found by the last component of their flat cache key (``0.k``,
``shared.v``, ``0.c_kv``), the reference's dict key; the slot axis is
counted from the end of the shape.

The quantization contract is the KV one (ROADMAP, "the two int8
contracts"), not the transport's: symmetric, ``s = max|x_row| / 127``
over one flattened slot row, clamped at ``1e-6`` and stored as f16,
rounding half to even; the division is by a tensor, so the card computes
it as IEEE division. A written row's max-magnitude element lands on
±127, so re-quantizing a dequantized pool is bit-stable after the first
write. This is plain torch in both packages: no kernel lies on the path.

Unmapped page-table entries hold ``FREE``. Torch has neither JAX's
``mode="fill"`` gather nor its ``mode="drop"`` scatter, so an arena keeps
one SPARE page past its capacity, never allocated: a read gathers with
the table clamped to the spare and zeroes the unmapped rows; a write
sends unmapped rows to the spare. No index is ever negative.

Pools follow the registry's genealogy through :class:`KVPoolManager.
sync`: a deleted model's pool is released (pages returned to the arena;
its in-flight requests are the gateway's to re-route), and a clone whose
PARENT held a pool is pre-warmed.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.federated.simulation import to_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import Params

QMAX = 127
# Sentinel page id for unmapped page-table entries: a large POSITIVE
# constant, far above any reachable arena capacity (reads and writes
# clamp it to the arena's spare page).
FREE = np.int32(1 << 30)
GROW = 64  # arena growth granularity, in pages

# Key names of pageable (ring-slot) cache leaves -> slot-axis position
# from the END of the leaf shape. Everything else (pos/index, conv
# windows, SSM/xLSTM states) is dense residue.
_PAGED_KEYS = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}


def _key_name(name: str) -> str:
    """The reference's dict key of a flat cache key: its last component."""
    return name.rsplit(".", 1)[-1]


def _nbytes(tree: Params) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values())


class _LeafSpec:
    """Paging geometry of one pageable leaf of the (unstacked) template:
    shape = lead + (C,) + tail; per lane there are R = prod(lead)
    independent slot sequences, each covering P pages of ps slots."""

    def __init__(self, shape: Tuple[int, ...], ax: int, page_slots: int,
                 dtype: torch.dtype):
        self.lead = tuple(shape[:ax])
        self.C = shape[ax]
        self.tail = tuple(shape[ax + 1:])
        self.T = int(np.prod(self.tail, dtype=np.int64)) if self.tail else 1
        self.ps = min(page_slots, self.C)
        self.P = math.ceil(self.C / self.ps)
        self.R = int(np.prod(self.lead, dtype=np.int64)) if self.lead else 1
        self.dtype = dtype

    @property
    def arena_key(self) -> Tuple[int, int]:
        return (self.T, self.ps)


class PageArena:
    """Shared int8 page heap for ONE (row_width, page_slots) class.

    ``pages`` (N, ps, T) int8 + ``scales`` (N, ps) f16 on ``device``
    (default the card); the free list is host-side. The storage holds one spare page after the
    N (module docstring). Growth appends pages before the spare (ids are
    stable — never remapped), so page tables survive arbitrary
    interleavings of pool lifecycles."""

    def __init__(self, width: int, page_slots: int,
                 device: Optional[torch.device] = None):
        self.width = width
        self.ps = page_slots
        self.device = resolve_device(device)
        self.storage = torch.zeros((GROW + 1, page_slots, width),
                                   dtype=torch.int8, device=self.device)
        self.scale_storage = torch.zeros((GROW + 1, page_slots),
                                         dtype=torch.float16,
                                         device=self.device)
        self._free: List[int] = list(range(GROW))

    @property
    def pages(self) -> torch.Tensor:
        return self.storage[:-1]

    @property
    def scales(self) -> torch.Tensor:
        return self.scale_storage[:-1]

    @property
    def capacity(self) -> int:
        return self.storage.shape[0] - 1

    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def page_nbytes(self) -> int:
        return self.ps * self.width + self.ps * 2  # int8 rows + f16 scales

    def alloc(self, n: int) -> np.ndarray:
        if len(self._free) < n:
            grow = max(GROW, n - len(self._free))
            base = self.capacity
            self.storage = torch.cat([
                self.pages, self.storage.new_zeros(
                    (grow, self.ps, self.width)), self.storage[-1:]])
            self.scale_storage = torch.cat([
                self.scales, self.scale_storage.new_zeros((grow, self.ps)),
                self.scale_storage[-1:]])
            self._free.extend(range(base, base + grow))
        out = np.asarray(self._free[:n], np.int32)
        del self._free[:n]
        return out

    def free(self, ids: Any) -> None:
        self._free.extend(int(i) for i in np.asarray(ids).ravel())
        self._free.sort()

    def nbytes(self) -> int:
        return self.capacity * self.page_nbytes


def _page_index(pt: np.ndarray, storage: torch.Tensor) -> torch.Tensor:
    """A host page table as a device index into ``storage``: ``FREE``
    entries clamped to the spare page (the last one)."""
    return to_device(np.minimum(pt, storage.shape[0] - 1), np.int64,
                     storage.device)


def _dequantize_leaf(pages: torch.Tensor, scales: torch.Tensor,
                     pt: np.ndarray, spec: _LeafSpec, lanes: int
                     ) -> torch.Tensor:
    """The dense ``(lanes,) + lead + (C,) + tail`` leaf of the pages that
    ``pt`` maps; unmapped slots read zeros. ``pages`` / ``scales`` are an
    arena's storage, spare page included."""
    idx = _page_index(pt, pages)
    mapped = idx < pages.shape[0] - 1
    x = pages[idx].float() * scales[idx].float()[..., None]
    x = torch.where(mapped[..., None, None], x,
                    torch.zeros((), device=x.device))
    x = x.reshape(lanes, spec.R, spec.P * spec.ps, spec.T)[:, :, :spec.C]
    return x.reshape((lanes,) + spec.lead + (spec.C,)
                     + spec.tail).to(spec.dtype)


def _quantize_leaf(pages: torch.Tensor, scales: torch.Tensor,
                   pt: np.ndarray, x: torch.Tensor, spec: _LeafSpec,
                   lanes: int) -> None:
    """Quantize the dense leaf ``x`` into the pages ``pt`` maps, IN PLACE
    in an arena's storage (rows of unmapped entries land on the spare
    page)."""
    xr = x.float().reshape(lanes * spec.R, spec.C, spec.T)
    pad = spec.P * spec.ps - spec.C
    if pad:
        xr = torch.nn.functional.pad(xr, (0, 0, 0, pad))
    xr = xr.reshape(lanes * spec.R * spec.P, spec.ps, spec.T)
    # the KV contract, block = one slot row; the clamp keeps the scale a
    # normal f16 so all-zero rows stay exact zeros
    qmax = torch.tensor(float(QMAX), device=xr.device)
    s = torch.clamp(torch.amax(xr.abs(), dim=-1) / qmax, min=1e-6)
    s16 = s.to(torch.float16)
    q = torch.clamp(torch.round(xr / s16.float()[..., None]),
                    -QMAX, QMAX).to(torch.int8)
    flat = _page_index(pt, pages).reshape(-1)
    pages.index_copy_(0, flat, q)
    scales.index_copy_(0, flat, s16)


class KVPool:
    """Dense decode-lane pool for ONE model: ``stacked`` holds ``lanes``
    single-request caches on a leading lane axis; ``acquire``/``release``
    manage the free list. Lane contents are fully overwritten at
    admission (the gateway copies a freshly prefilled cache into the
    lane), so released lanes need no reset pass. ``device``: where the
    caches live (default the card)."""

    def __init__(self, cfg: ArchConfig, lanes: int, max_len: int,
                 window: int = 0, device=None):
        self.lanes = lanes
        self.window = window
        self.device = resolve_device(device)
        # batch=1 template: the per-lane cache layout (and the fresh
        # cache admission prefills into — only read, never written)
        self.template = tf.init_lm_caches(cfg, 1, max_len, window=window,
                                          device=self.device)
        self.stacked = {k: v.expand(lanes, *v.shape).clone()
                        for k, v in self.template.items()}
        self._free: List[int] = list(range(lanes))

    @property
    def free_lanes(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        if not self._free:
            raise IndexError("pool has no free lane")
        return self._free.pop(0)

    def release(self, lane: int) -> None:
        if lane in self._free or not (0 <= lane < self.lanes):
            raise ValueError(f"bad lane release: {lane}")
        self._free.append(lane)
        self._free.sort()

    # storage interface (paged pools convert; dense is a passthrough)
    def read(self) -> Params:
        return self.stacked

    def write(self, stacked: Params) -> None:
        self.stacked = stacked

    def nbytes(self) -> int:
        return _nbytes(self.stacked)

    def nbytes_in_use(self) -> int:
        return self.nbytes()


class PagedKVPool:
    """Paged int8 decode-lane pool (module docstring).

    Same lane/free-list interface as :class:`KVPool`; storage differs:
    ring-slot leaves live in shared :class:`PageArena`\\ s behind per-lane
    page tables (host numpy int32, FREE where unmapped), everything else
    in a dense residue dict. ``read()`` materializes the dense working
    caches for a dispatch; ``write()`` re-quantizes them back. That costs
    a conversion pass either side of the dispatch — the shrink is in the
    PERSISTENT pool bytes (what ``nbytes`` meters)."""

    def __init__(self, cfg: ArchConfig, lanes: int, max_len: int,
                 window: int = 0, page_slots: int = 8,
                 arenas: Optional[Dict[Tuple[int, int], PageArena]] = None,
                 device=None):
        self.lanes = lanes
        self.window = window
        self.page_slots = page_slots
        self.device = resolve_device(device)
        self.template = tf.init_lm_caches(cfg, 1, max_len, window=window,
                                          device=self.device)
        self.arenas = arenas if arenas is not None else {}
        self._specs: Dict[str, Optional[_LeafSpec]] = {}
        self._residue: Dict[str, Optional[torch.Tensor]] = {}
        self._tables: Dict[str, Optional[np.ndarray]] = {}
        for name, leaf in self.template.items():
            ax = _PAGED_KEYS.get(_key_name(name))
            if ax is None:
                self._specs[name] = None
                self._residue[name] = leaf.expand(lanes, *leaf.shape).clone()
                self._tables[name] = None
                continue
            spec = _LeafSpec(tuple(leaf.shape), ax, page_slots, leaf.dtype)
            self._specs[name] = spec
            self._residue[name] = None
            self._tables[name] = np.full((lanes, spec.R, spec.P), FREE,
                                         np.int32)
            if spec.arena_key not in self.arenas:
                self.arenas[spec.arena_key] = PageArena(spec.T, spec.ps,
                                                        self.device)
        self._free: List[int] = list(range(lanes))

    def _paged(self):
        for name, spec in self._specs.items():
            if spec is not None:
                yield name, spec, self._tables[name]

    @property
    def free_lanes(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        if not self._free:
            raise IndexError("pool has no free lane")
        lane = self._free.pop(0)
        for _name, spec, pt in self._paged():
            # stale page contents are fine: admission overwrites every
            # slot of the lane before any read observes it
            pt[lane] = self.arenas[spec.arena_key].alloc(
                spec.R * spec.P).reshape(spec.R, spec.P)
        return lane

    def release(self, lane: int) -> None:
        if lane in self._free or not (0 <= lane < self.lanes):
            raise ValueError(f"bad lane release: {lane}")
        for _name, spec, pt in self._paged():
            self.arenas[spec.arena_key].free(pt[lane])
            pt[lane] = FREE
        self._free.append(lane)
        self._free.sort()

    def read(self) -> Params:
        out = {}
        for name, spec in self._specs.items():
            if spec is None:
                out[name] = self._residue[name]
            else:
                ar = self.arenas[spec.arena_key]
                out[name] = _dequantize_leaf(ar.storage, ar.scale_storage,
                                             self._tables[name], spec,
                                             self.lanes)
        return out

    def write(self, stacked: Params) -> None:
        for name, spec in self._specs.items():
            if spec is None:
                self._residue[name] = stacked[name]
            else:
                ar = self.arenas[spec.arena_key]
                _quantize_leaf(ar.storage, ar.scale_storage,
                               self._tables[name], stacked[name], spec,
                               self.lanes)

    def _mapped_pages(self) -> Dict[Tuple[int, int], int]:
        out: Dict[Tuple[int, int], int] = {}
        for _name, spec, pt in self._paged():
            k = spec.arena_key
            out[k] = out.get(k, 0) + int(np.sum(pt != FREE))
        return out

    def _residue_nbytes(self) -> int:
        return _nbytes({k: v for k, v in self._residue.items()
                        if v is not None})

    def _tables_nbytes(self) -> int:
        return sum(pt.nbytes for _n, _s, pt in self._paged())

    def nbytes(self) -> int:
        """Bytes this pool holds: mapped pages + dense residue + tables."""
        mapped = sum(self.arenas[k].page_nbytes * n
                     for k, n in self._mapped_pages().items())
        return mapped + self._residue_nbytes() + self._tables_nbytes()

    def nbytes_in_use(self) -> int:
        return self.nbytes()


class KVPoolManager:
    """Allocates/releases per-model pools against the model registry's
    liveness + genealogy. ``paged=True`` switches to :class:`PagedKVPool`
    storage; ``arenas`` lets two managers (target + draft) share one set
    of page arenas, the "one arena per model family" in DESIGN.md §16.
    ``device``: where the pools live (default the card)."""

    def __init__(self, cfg: ArchConfig, lanes: int, max_len: int,
                 window: int = 0, paged: bool = False, page_slots: int = 8,
                 arenas: Optional[Dict[Tuple[int, int], PageArena]] = None,
                 device=None):
        self.cfg = cfg
        self.lanes = lanes
        self.max_len = max_len
        self.window = window
        self.paged = paged
        self.page_slots = page_slots
        self.device = resolve_device(device)
        self.arenas: Dict[Tuple[int, int], PageArena] = (
            arenas if arenas is not None else {})
        self.pools: Dict[int, Any] = {}
        self.created = 0
        self.released = 0

    def get(self, model_id: int) -> Any:
        """The model's pool, allocated lazily on first routed request."""
        pool = self.pools.get(model_id)
        if pool is None:
            if self.paged:
                pool = PagedKVPool(self.cfg, self.lanes, self.max_len,
                                   self.window, self.page_slots,
                                   arenas=self.arenas, device=self.device)
            else:
                pool = KVPool(self.cfg, self.lanes, self.max_len,
                              self.window, device=self.device)
            self.pools[model_id] = pool
            self.created += 1
        return pool

    def sync(self, registry: Any) -> Tuple[List[int], List[int]]:
        """Reconcile pools with the registry after lifecycle events.
        Releases pools of dead models (returning their pages to the
        shared arenas) and pre-warms pools for new clones whose parent
        held one. Returns (prewarmed_ids, released_ids); the gateway
        re-routes the released pools' in-flight requests."""
        live = set(registry.live_ids())
        released = [m for m in self.pools if m not in live]
        for m in released:
            # occupied lanes of a released paged pool still hold arena
            # pages — the caller must evict/release them (the gateway's
            # ``evict_all`` on the dropped group does this)
            del self.pools[m]
            self.released += 1
        prewarmed = []
        for m in sorted(live - set(self.pools)):
            parent = registry.entries[m].parent
            if parent is not None and (parent in self.pools
                                       or parent in released):
                self.get(m)
                prewarmed.append(m)
        return prewarmed, released

    def nbytes(self) -> int:
        """Reserved bytes: dense pools in full; in paged mode the shared
        arenas' whole capacity (free pages included) plus residues."""
        if not self.paged:
            return sum(p.nbytes() for p in self.pools.values())
        return (sum(a.nbytes() for a in self.arenas.values())
                + sum(p._residue_nbytes() + p._tables_nbytes()
                      for p in self.pools.values()))

    def nbytes_in_use(self) -> int:
        """Bytes actually mapped by live lanes (+ residues/tables)."""
        return sum(p.nbytes_in_use() for p in self.pools.values())

    def page_stats(self) -> Dict[str, int]:
        reserved = sum(a.capacity for a in self.arenas.values())
        in_use = sum(a.pages_in_use for a in self.arenas.values())
        return {"pages_reserved": reserved, "pages_in_use": in_use}
