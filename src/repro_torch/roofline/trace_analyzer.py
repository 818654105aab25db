"""Per-cell accounting of one traced step (the port's stand-in for
``repro/roofline/hlo_analyzer.py``).

The reference compiles a step with XLA and parses the optimized HLO
text: loop trip counts, dot FLOPs, collective result bytes and a uniform
memory-traffic model. The port has no HLO and no loops to unroll: its
step is Python, and running it once (on ``meta`` tensors in the dry run,
on real ones on the card) executes every op of every layer. So
:class:`TraceCounter` counts the ops as they run, under a
``TorchDispatchMode``:

* FLOPs from ``torch.utils.flop_counter.flop_registry`` (matrix products
  and convolutions; like the reference's analyzer, products only);
* memory bytes as 2 x the result bytes of every op that materialises a
  result (one write, one read downstream: the reference's uniform
  traffic model), views excluded;
* the collectives the mesh runtime records (``launch/tensor_parallel.py``:
  the kind under the reference's names and the bytes each receiving cell
  receives). Each recorded collective whose result takes a gradient
  records its transpose when that gradient arrives (an all-gather a
  reduce-scatter, an all-reduce an all-reduce, a permute a permute), so
  a training step counts its backward's collectives too. Copies of the
  batch inputs (tokens, labels, frames: ``add_inputs(...,
  batch=True)``), which the step itself cuts over the data cells, are
  not counted, as the reference's ``in_shardings`` lay them out for
  free; gathers of the params and caches are;
* the bytes alive: a storage is counted from the op that creates it
  until its last tensor dies (views share their base's storage), per
  cell and over all cells at once; the peak of each.

One host process runs every cell of a mesh, so every count is split by
cell: the runtime names the cell whose share runs now
(``tensor_parallel.on_cell``), and work outside any cell counts to cell
``(0, 0)``. The backward pass runs outside the forward's cell contexts,
so while a training step is traced each autograd node is tagged with the
cell that created it and sets that cell when it runs.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import tensor_parallel as tp
from repro_torch.roofline.analysis import COLLECTIVE_OPS

Cell = Tuple[int, int]
TRANSPOSE = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
             "all-reduce": "all-reduce", "all-to-all": "all-to-all",
             "collective-permute": "collective-permute"}


@dataclass
class CellCounts:
    """One cell's counts."""
    flops: float = 0.0
    memory_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_OPS})
    collective_counts: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_OPS})
    argument_bytes: int = 0          # inputs held (add_inputs)
    live: int = 0                    # bytes alive, arguments included
    peak: int = 0
    temp_live: int = 0               # bytes alive made by the trace
    temp_peak: int = 0

    def totals(self) -> Dict[str, Any]:
        return {"flops": self.flops, "memory_bytes": self.memory_bytes,
                "collective_bytes": sum(self.collective_bytes.values()),
                "collective_by_kind": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "argument_bytes": self.argument_bytes,
                "peak_bytes": self.peak, "temp_bytes": self.temp_peak}


def _tensors(obj: Any) -> List[torch.Tensor]:
    return [t for t in tree_leaves(obj) if isinstance(t, torch.Tensor)]


class _NodeCells(TorchFunctionMode):
    """Tags each autograd node made under it with the cell that made it;
    the node sets that cell when the backward pass runs it."""

    def __init__(self, counter: "TraceCounter"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            cell = self.counter.cell
            for t in _tensors(out):
                if t.grad_fn is not None:
                    t.grad_fn.register_prehook(
                        lambda grads, cell=cell: self.counter._enter(cell))
        return out


class TraceCounter(TorchDispatchMode):
    """Counts FLOPs, memory traffic, collectives and bytes alive per cell
    while it is entered (module docstring). ``backward``: the traced
    work runs a backward pass, whose nodes are tagged with their cells
    (a ``TorchFunctionMode`` around the trace)."""

    def __init__(self, backward: bool = True):
        super().__init__()
        self.backward = backward
        self.cell: Cell = (0, 0)
        self.cells: Dict[Cell, CellCounts] = {}
        self._storages: Dict[int, Tuple[int, Tuple[Cell, ...], bool]] = {}
        self._batch: set = set()
        self.live_all = 0
        self.peak_all = 0
        self._prev_listener = None
        self._nodes: Optional[_NodeCells] = None

    # -- the mesh runtime's listener interface -------------------------------
    def _enter(self, cell: Cell) -> None:
        self.cell = cell

    def _counts(self, cell: Cell) -> CellCounts:
        c = self.cells.get(cell)
        if c is None:
            c = self.cells[cell] = CellCounts()
        return c

    def collective(self, kind: str, nbytes: int, cells: Sequence[Cell],
                   out: Optional[torch.Tensor] = None,
                   sources: Sequence[torch.Tensor] = ()) -> None:
        if any(self._key(s) in self._batch for s in sources):
            return
        for cell in cells:
            c = self._counts(cell)
            c.collective_bytes[kind] += nbytes
            c.collective_counts[kind] += 1
        if out is not None and out.requires_grad:
            cells = list(cells)
            out.register_hook(lambda g: self.collective(
                TRANSPOSE[kind], nbytes, cells))

    # -- bytes alive ---------------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _alloc(self, st, nbytes: int, cells: Tuple[Cell, ...],
               temp: bool) -> None:
        key = st._cdata
        self._storages[key] = (nbytes, cells, temp)
        weakref.finalize(st, self._free, key)
        for cell in cells:
            c = self._counts(cell)
            c.live += nbytes
            c.peak = max(c.peak, c.live)
            if temp:
                c.temp_live += nbytes
                c.temp_peak = max(c.temp_peak, c.temp_live)
        self.live_all += nbytes
        self.peak_all = max(self.peak_all, self.live_all)

    def _free(self, key: int) -> None:
        nbytes, cells, temp = self._storages.pop(key)
        for cell in cells:
            c = self.cells[cell]
            c.live -= nbytes
            if temp:
                c.temp_live -= nbytes
        self.live_all -= nbytes

    def add_inputs(self, held: Iterable[Tuple[torch.Tensor, Sequence[Cell]]],
                   batch: bool = False) -> None:
        """Inputs laid out before the trace: each tensor with the cells
        that hold it. A cell's argument bytes are its tensors' own bytes
        (a piece's block, not its base's storage); over all cells each
        storage counts once. ``batch``: copies of these are not counted
        as collectives (module docstring)."""
        for t, cells in held:
            for cell in cells:
                c = self._counts(cell)
                n = t.numel() * t.element_size()
                c.argument_bytes += n
                c.live += n
                c.peak = max(c.peak, c.live)
            st = t.untyped_storage()
            if batch:
                self._batch.add(st._cdata)
            if st._cdata in self._storages:
                continue
            self._alloc(st, st.nbytes(), (), False)

    # -- the trace -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self._counts(self.cell)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            c.flops += count(*args, **(kwargs or {}), out_val=out)
        if not func.is_view:
            made = 0
            for t in _tensors(out):
                made += t.numel() * t.element_size()
                st = t.untyped_storage()
                if st._cdata not in self._storages:
                    self._alloc(st, st.nbytes(), (self.cell,), True)
            c.memory_bytes += 2.0 * made
        return out

    def __enter__(self):
        self._prev_listener = tp.set_listener(self)
        if self.backward:
            self._nodes = _NodeCells(self)
            self._nodes.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self._nodes is not None:
            self._nodes.__exit__(*exc)
            self._nodes = None
        tp.set_listener(self._prev_listener)

    # -- results -------------------------------------------------------------
    def busiest(self, step_s: Callable[[Dict[str, Any]], float]) -> Cell:
        """The cell with the largest ``step_s(totals)``, then the largest
        peak, then the lowest index."""
        return max(sorted(self.cells),
                   key=lambda k: (step_s(self.cells[k].totals()),
                                  self.cells[k].peak, -k[0], -k[1]))

    def result(self, step_s: Callable[[Dict[str, Any]], float]
               ) -> Dict[str, Any]:
        """The busiest cell's totals at top level (the reference's
        ``analyze`` keys and the memory figures), every cell's under
        ``cells``, and the peak of bytes alive over all cells at once."""
        if not self.cells:
            self._counts((0, 0))
        cell = self.busiest(step_s)
        return {**self.cells[cell].totals(), "cell": list(cell),
                "cells": {f"{k[0]},{k[1]}": v.totals()
                          for k, v in sorted(self.cells.items())},
                "peak_bytes_all_cells": self.peak_all}


def analyze(fn: Callable, *args, inputs=(), step_s=None, backward=True,
            **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` under a :class:`TraceCounter` whose
    ``inputs`` (tensor, cells) pairs were laid out before it. Returns
    ``(fn's result, counts)``; the busiest cell by ``step_s(totals)``
    (default: its FLOPs)."""
    counter = TraceCounter(backward)
    counter.add_inputs(inputs)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.result(step_s or (lambda t: t["flops"]))
