"""Tensor-parallel leaves and their collectives on a launch mesh.

This module has no counterpart in the reference. There, every LM leaf
carries a ``NamedSharding`` (``launch/sharding.py``), XLA lays it out over
the mesh's devices and inserts the collectives an op needs. The port's
:class:`~repro_torch.launch.mesh.LaunchMesh` is driven by one host
process (PR 19's single controller), so ``torch.distributed``'s DTensor,
which needs a process per device, does not fit. Instead:

* A sharded leaf (:class:`Sharded`) is the list of its pieces, one per
  cell of the mesh (model-major), laid out by a spec of
  ``launch/sharding.py``: piece ``(sm, sd)`` is the leaf's block of that
  cell and lives on ``mesh.device(sm, sd)``. Cells that hold the same
  block on the same device share one tensor, so a leaf whose spec is all
  ``None`` is one tensor per distinct device; cells that hold different
  blocks keep separate pieces even where they share a device (so the
  tensor-parallel code runs on one card and on the CPU).
* The collectives are copies and adds in a fixed cell order:
  :func:`all_gather` (concatenation of pieces on one device),
  :func:`all_reduce_sum` (a sum in cell order, so a card and the CPU add
  the same terms in the same order) and :func:`split`. Gradients flow
  through them by autograd, across devices through ``.to(device)``
  copies; nothing uses ``torch.distributed``.
* :class:`MeshRun` is the layout of one forward: the batch rows split
  over the data cells (``batch_spec``), each data shard's replicated
  computation (norms, residuals) on its home cell ``(0, sd)``, and each
  cell's share of a split op (heads, experts, vocabulary) on its own
  device, with the data pieces of its weights gathered first (FSDP).

Spec entries over combined axes run too. An entry of data axes only,
``("pod", "data")`` on a multi-pod mesh, reads as one data axis over the
flat data-parallel index (``launch/mesh.py``), and is gathered as FSDP.
An entry that combines ``model`` with data axes (the ``decode_2d``
policy's ``("data", "model")``) is not cut on the model axis by the cell
math (:func:`splits_on` answers false for it): the op that uses it
gathers the leaf whole, as it does a leaf of a gathered family, with the
same values and the same count as an all-gather.

Accounting (for the dry run, ``roofline/trace_analyzer.py``): one host
process runs every cell, so counts taken over the process are split by
cell. :func:`on_cell` names the cell whose share runs now; the runtime
sets it where it runs a cell's share (``MeshRun.cell``, ``MeshRun.whole``
and the per-cell loops of the models), and work outside any cell counts
to cell ``(0, 0)``. Collectives are recorded where they are called
(:func:`all_gather`, :func:`all_reduce_sum`, :func:`split`,
``Sharded.full`` / ``local``, :func:`reduce_replicas`), under the
reference's names, with the bytes each receiving cell receives, since on
a mesh whose cells share one device a copy between cells moves nothing.
Both are no-ops unless a listener is set (:func:`set_listener`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import LaunchMesh, dp_axes_of, dp_size
from repro_torch.launch.sharding import PartitionSpec, batch_spec

Block = Tuple[Tuple[int, int], ...]      # (index, count) per dim
Cell = Tuple[int, int]                   # (sm, sd)

# -- accounting (module docstring) --------------------------------------------

_LISTENER: List[Any] = [None]
_NO_CELL = contextlib.nullcontext()


def set_listener(listener: Any) -> Any:
    """Make ``listener`` receive the accounting (``None``: none); returns
    the previous one. A listener has a ``cell`` attribute, the cell whose
    share runs now, and ``collective(kind, nbytes, cells, out,
    sources)``."""
    prev, _LISTENER[0] = _LISTENER[0], listener
    return prev


@contextlib.contextmanager
def _at(listener: Any, cell: Cell):
    prev, listener.cell = listener.cell, cell
    try:
        yield
    finally:
        listener.cell = prev


def on_cell(sm: int, sd: int):
    """A context in which work counts to cell ``(sm, sd)`` (a no-op
    unless a listener is set)."""
    listener = _LISTENER[0]
    return _NO_CELL if listener is None else _at(listener, (sm, sd))


def _record(kind: str, nbytes: int, cells: Optional[Sequence[Cell]] = None,
            out: Optional[torch.Tensor] = None,
            sources: Sequence[torch.Tensor] = ()) -> None:
    """One collective of ``kind``: ``nbytes`` received by each of
    ``cells`` (default the current cell); ``out`` its result, ``sources``
    the tensors it reads."""
    listener = _LISTENER[0]
    if listener is not None and nbytes:
        listener.collective(kind, nbytes,
                            [listener.cell] if cells is None else cells,
                            out, sources)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def axes_of(entry: Any) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _coord(mesh: LaunchMesh, axis: str, sm: int, sd: int) -> int:
    """Cell ``(sm, sd)``'s index along ``axis`` (``sd`` the flat
    data-parallel index ``pod * data + data``)."""
    if axis == "model":
        return sm
    if axis == "data":
        return sd % mesh.shape["data"]
    if axis == "pod" and axis in mesh.axis_names:
        return sd // mesh.shape["data"]
    raise ValueError(f"a launch mesh has no axis {axis!r}")


def cell_blocks(mesh: LaunchMesh, spec: Sequence[Any]) -> List[Block]:
    """Each cell's block (model-major): ``(index, count)`` per dim, the
    first named axis of an entry the major one (JAX's order). Memoized
    per mesh and spec (do not mutate the list)."""
    key = tuple(spec)
    cache = mesh.__dict__.setdefault("_cell_blocks", {})
    if key not in cache:
        cache[key] = _cell_blocks(mesh, key)
    return cache[key]


def _cell_blocks(mesh: LaunchMesh, spec: Sequence[Any]) -> List[Block]:
    D = dp_size(mesh)
    out = []
    for cell in range(mesh.size):
        sm, sd = divmod(cell, D)
        blk = []
        for entry in spec:
            idx, cnt = 0, 1
            for a in axes_of(entry):
                n = mesh.shape[a]
                idx, cnt = idx * n + _coord(mesh, a, sm, sd), cnt * n
            blk.append((idx, cnt))
        out.append(tuple(blk))
    return out


def narrow_block(t: torch.Tensor, blk: Block) -> torch.Tensor:
    """The block ``blk`` of a whole tensor ``t``, as a view."""
    for d, (i, c) in enumerate(blk):
        if c > 1:
            n = t.shape[d] // c
            t = t.narrow(d, i * n, n)
    return t


def _check(shape: Sequence[int], blk: Block, spec) -> None:
    for dim, (_, c) in zip(shape, blk):
        if dim % c:
            raise ValueError(f"spec {spec} does not divide shape "
                             f"{tuple(shape)}")


class Sharded:
    """One leaf laid out over a mesh by ``spec`` (module docstring).

    ``shape`` is the whole leaf's; ``pieces`` holds one tensor per cell,
    model-major, where cells with the same block on the same device share
    one tensor object."""

    __slots__ = ("mesh", "spec", "shape", "pieces")

    def __init__(self, mesh: LaunchMesh, spec: Sequence[Any],
                 shape: Sequence[int], pieces: Sequence[torch.Tensor]):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.shape = torch.Size(shape)
        self.pieces = list(pieces)

    # -- construction ---------------------------------------------------------
    @classmethod
    def _layout(cls, mesh: LaunchMesh, spec, shape,
                make: Callable[[Block, torch.device], torch.Tensor]
                ) -> "Sharded":
        made: Dict[Tuple[Block, torch.device], torch.Tensor] = {}
        pieces = []
        D = dp_size(mesh)
        for cell, (blk, dev) in enumerate(zip(cell_blocks(mesh, spec),
                                              mesh.devices)):
            key = (blk, dev)
            if key not in made:
                _check(shape, blk, spec)
                with on_cell(*divmod(cell, D)):
                    made[key] = make(blk, dev)
            pieces.append(made[key])
        return cls(mesh, spec, shape, pieces)

    @classmethod
    def place(cls, t: torch.Tensor, mesh: LaunchMesh, spec) -> "Sharded":
        """``t`` laid out by ``spec``: each piece a view of ``t`` (a copy
        on another device). Differentiable: gradients of the pieces reach
        ``t``."""
        return cls._layout(mesh, spec, t.shape,
                           lambda blk, dev: narrow_block(t, blk).to(dev))

    @classmethod
    def zeros(cls, mesh: LaunchMesh, spec, shape: Sequence[int],
              dtype: torch.dtype) -> "Sharded":
        def make(blk, dev):
            return torch.zeros([s // c for s, (_, c) in zip(shape, blk)],
                               dtype=dtype, device=dev)
        return cls._layout(mesh, spec, shape, make)

    @classmethod
    def from_cells(cls, mesh: LaunchMesh, spec, shape: Sequence[int],
                   values: Dict[int, torch.Tensor]) -> "Sharded":
        """A leaf laid out by ``spec`` from values computed on some cells
        (by cell index, model-major): a cell takes its own value where it
        computed one, else that of a computed cell holding its block (on
        its own device where there is one), moved to its device. Cells
        with one block on one device share the first one's tensor."""
        blocks = cell_blocks(mesh, spec)
        by_block: Dict[Block, List[torch.Tensor]] = {}
        for cell, t in values.items():
            by_block.setdefault(blocks[cell], []).append(t)
        made: Dict[Tuple[Block, torch.device], torch.Tensor] = {}
        pieces = []
        D = dp_size(mesh)
        for cell, (blk, dev) in enumerate(zip(blocks, mesh.devices)):
            if (blk, dev) not in made:
                _check(shape, blk, spec)
                t = values.get(cell)
                if t is None:
                    ts = by_block[blk]
                    t = next((u for u in ts if u.device == dev), ts[0])
                with on_cell(*divmod(cell, D)):
                    made[(blk, dev)] = t.to(dev)
            pieces.append(made[(blk, dev)])
        return cls(mesh, spec, shape, pieces)

    @classmethod
    def stack(cls, layers: Sequence["Sharded"], *shape: int) -> "Sharded":
        """Leaves of one layout stacked on new leading (replicated) axes
        ``shape`` (default ``(len(layers),)``), piece by piece."""
        first = layers[0]
        shape = shape or (len(layers),)
        values, seen = {}, set()
        D = dp_size(first.mesh)
        for cell, p in enumerate(first.pieces):
            if id(p) not in seen:
                seen.add(id(p))
                with on_cell(*divmod(cell, D)):
                    values[cell] = torch.stack(
                        [lay.pieces[cell] for lay in layers]).reshape(
                            *shape, *p.shape)
        return cls.from_cells(first.mesh,
                              (None,) * len(shape) + tuple(first.spec),
                              (*shape, *first.shape), values)

    def with_pieces(self, tensors: Sequence[torch.Tensor]) -> "Sharded":
        """The same layout over new tensors, one per :meth:`distinct`
        tensor, in its order."""
        new = {id(p): t for p, t in zip(self.distinct(), tensors)}
        return Sharded(self.mesh, self.spec, self.shape,
                       [new[id(p)] for p in self.pieces])

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        """``fn`` of each distinct piece, under the first cell holding
        it."""
        out = []
        for cell, p in self.holders():
            with on_cell(*cell):
                out.append(fn(p))
        return self.with_pieces(out)

    def holders(self) -> List[Tuple[Cell, torch.Tensor]]:
        """The distinct piece tensors, each with the first cell holding
        it, in cell order."""
        D = dp_size(self.mesh)
        seen, out = set(), []
        for cell, p in enumerate(self.pieces):
            if id(p) not in seen:
                seen.add(id(p))
                out.append((divmod(cell, D), p))
        return out

    # -- inspection -----------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def device(self) -> torch.device:
        """The device of cell ``(0, 0)``."""
        return self.pieces[0].device

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def piece(self, sm: int, sd: int = 0) -> torch.Tensor:
        return self.pieces[sm * dp_size(self.mesh) + sd]

    def blocks(self) -> List[Block]:
        return cell_blocks(self.mesh, self.spec)

    def distinct(self) -> List[torch.Tensor]:
        """The distinct piece tensors, in cell order."""
        return [p for _, p in self.holders()]

    def groups(self) -> List[Tuple[Block, List[torch.Tensor]]]:
        """The distinct tensors grouped by the block they hold (copies of
        one block on several devices form a group), in cell order."""
        out: Dict[Block, List[torch.Tensor]] = {}
        seen = set()
        for blk, p in zip(self.blocks(), self.pieces):
            if id(p) not in seen:
                seen.add(id(p))
                out.setdefault(blk, []).append(p)
        return list(out.items())

    def split_dims(self) -> List[int]:
        return [d for d, e in enumerate(self.spec) if axes_of(e)
                and math.prod(self.mesh.shape[a] for a in axes_of(e)) > 1]

    # -- views ----------------------------------------------------------------
    def __getitem__(self, i: int) -> "Sharded":
        """Row ``i`` of the leading (replicated) dim, as views."""
        if axes_of(self.spec[0]):
            raise ValueError("only a replicated leading dim is indexed")
        rows: Dict[int, torch.Tensor] = {}
        for p in self.pieces:
            if id(p) not in rows:
                rows[id(p)] = p[i]
        return Sharded(self.mesh, self.spec[1:], self.shape[1:],
                       [rows[id(p)] for p in self.pieces])

    def layers(self, depth: int) -> List["Sharded"]:
        """The per-layer views of a leaf stacked on ``depth`` leading
        (replicated) dims, in memory order; ``[self]`` at depth 0."""
        if not depth:
            return [self]
        views: Dict[int, List[torch.Tensor]] = {}
        for p in self.pieces:
            if id(p) not in views:
                views[id(p)] = list(p.view(-1, *p.shape[depth:]).unbind(0))
        n = len(views[id(self.pieces[0])])
        return [Sharded(self.mesh, self.spec[depth:], self.shape[depth:],
                        [views[id(p)][i] for p in self.pieces])
                for i in range(n)]

    # -- gathers --------------------------------------------------------------
    def _assemble(self, pick: Dict[Tuple[int, ...], torch.Tensor],
                  dims: List[int], counts: List[int],
                  device: torch.device) -> torch.Tensor:
        # the dim of most blocks innermost: the fewest concatenations
        order = sorted(range(len(dims)), key=lambda j: counts[j])

        def rec(prefix):
            if len(prefix) == len(dims):
                key = [0] * len(dims)
                for j, i in zip(order, prefix):
                    key[j] = i
                return pick[tuple(key)].to(device)
            j = order[len(prefix)]
            parts = [rec(prefix + (i,)) for i in range(counts[j])]
            return parts[0] if len(parts) == 1 else torch.cat(parts,
                                                              dim=dims[j])
        return rec(())

    def full(self, device: torch.device, prefer_sd: int = 0
             ) -> torch.Tensor:
        """The whole leaf on ``device`` (a gather of every block; a copy
        of one block held by several cells is taken from a cell of data
        index ``prefer_sd`` where there is one). Differentiable."""
        dims = self.split_dims()
        blocks = self.blocks()
        counts = [blocks[0][d][1] for d in dims]
        D = dp_size(self.mesh)
        pick: Dict[Tuple[int, ...], torch.Tensor] = {}
        local = set()
        for cell, (blk, p) in enumerate(zip(blocks, self.pieces)):
            key = tuple(blk[d][0] for d in dims)
            here = cell % D == prefer_sd
            if key not in pick or (here and key not in local):
                pick[key] = p
                if here:
                    local.add(key)
        out = self._assemble(pick, dims, counts, torch.device(device))
        if dims:
            _record("all-gather", _nbytes(out), out=out,
                    sources=self.distinct())
        return out

    def local(self, sm: int, sd: int) -> torch.Tensor:
        """Cell ``(sm, sd)``'s block with every split dim but the
        model-only ones gathered (FSDP: the cell's share along the model
        axis, whole along the data axes and along combined axes), on the
        cell's device. Differentiable."""
        dev = self.mesh.device(sm, sd)
        split = self.split_dims()
        gather = [d for d in split if axes_of(self.spec[d]) != ("model",)]
        if not gather:
            return self.piece(sm, sd).to(dev)
        D = dp_size(self.mesh)
        own = sm * D + sd
        blocks = self.blocks()
        keep = [d for d in split if d not in gather]
        pick: Dict[Tuple[int, ...], torch.Tensor] = {}
        counts = [blocks[0][d][1] for d in gather]
        # this cell's piece first, then its model shard's, then any
        shard = range(sm * D, (sm + 1) * D)
        for cell in (own, *shard, *range(self.mesh.size)):
            if len(pick) == math.prod(counts):
                break
            blk = blocks[cell]
            if all(blk[d] == blocks[own][d] for d in keep):
                pick.setdefault(tuple(blk[d][0] for d in gather),
                                self.pieces[cell])
        out = self._assemble(pick, gather, counts, dev)
        _record("all-gather", _nbytes(out), out=out, sources=self.distinct())
        return out

    def relayout(self, spec) -> "Sharded":
        """The same values laid out by ``spec``."""
        return Sharded.place(self.full(self.device), self.mesh, spec)

    # -- in-place writes ------------------------------------------------------
    @torch.no_grad()
    def copy_(self, src: Any) -> "Sharded":
        """Write ``src`` into every piece: a :class:`Sharded` of the same
        layout piece by piece, a whole tensor (or array) block by block."""
        if isinstance(src, Sharded):
            done = set()
            for p, s in zip(self.pieces, src.pieces):
                if id(p) not in done:
                    done.add(id(p))
                    p.copy_(s)
            return self
        t = torch.as_tensor(src)
        done = set()
        for blk, p in zip(self.blocks(), self.pieces):
            if id(p) not in done:
                done.add(id(p))
                p.copy_(narrow_block(t, blk))
        return self

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, spec={self.spec}, "
                f"dtype={self.dtype}, pieces={len(self.distinct())})")


# -- collectives --------------------------------------------------------------

def all_gather(pieces: Sequence[torch.Tensor], dim: int,
               device: torch.device) -> torch.Tensor:
    """The pieces concatenated along ``dim`` on ``device``, in order."""
    parts = [p.to(device) for p in pieces]
    if len(parts) == 1:
        return parts[0]
    out = torch.cat(parts, dim=dim)
    _record("all-gather", _nbytes(out), out=out, sources=pieces)
    return out


def all_reduce_sum(parts: Sequence[torch.Tensor], device: torch.device
                   ) -> torch.Tensor:
    """The sum of ``parts`` on ``device``, added in cell order (one
    order on every device, so a card and the CPU add alike)."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    if len(parts) > 1:
        _record("all-reduce", _nbytes(out), out=out, sources=parts)
    return out


def split(x: torch.Tensor, dim: int, devices: Sequence[torch.device],
          cells: Optional[Sequence[Cell]] = None) -> List[torch.Tensor]:
    """``x`` cut into ``len(devices)`` equal blocks along ``dim``, block
    ``i`` on ``devices[i]`` (a view where it already lives there). Block
    ``i >= 1`` is received by ``cells[i]`` (default the current cell),
    block 0 stays where ``x`` is."""
    n = x.shape[dim] // len(devices)
    out = [x.narrow(dim, i * n, n).to(dev)
           for i, dev in enumerate(devices)]
    for i, t in enumerate(out[1:], 1):
        _record("collective-permute", _nbytes(t),
                None if cells is None else [cells[i]], t, (x,))
    return out


def reduce_replicas(grad: Sharded) -> Sharded:
    """Gradients of a leaf whose blocks have copies on several devices
    (a block replicated over the data axis, a replicated leaf): each
    copy's gradient is its consumers' share, so every copy takes the sum
    of its group's, added in cell order. One tensor per group: as is.
    Every block held by several cells is recorded as an all-reduce to
    each of them, whether or not they share a device."""
    D = dp_size(grad.mesh)
    holders: Dict[Block, List[int]] = {}
    for cell, blk in enumerate(grad.blocks()):
        holders.setdefault(blk, []).append(cell)
    for cells in holders.values():
        if len(cells) > 1:
            _record("all-reduce", _nbytes(grad.pieces[cells[0]]),
                    [divmod(c, D) for c in cells])
    new: Dict[int, torch.Tensor] = {}
    for _, ts in grad.groups():
        if len(ts) == 1:
            new[id(ts[0])] = ts[0]
            continue
        total = all_reduce_sum(ts, ts[0].device)
        for i, t in enumerate(ts):
            # a tensor of each copy's own (the layout keeps its copies)
            new[id(t)] = total if i == 0 else total.to(t.device, copy=True)
    return grad.with_pieces([new[id(p)] for p in grad.distinct()])


# -- the layout of one forward ------------------------------------------------

class MeshRun:
    """Where one forward over a mesh runs (module docstring): data shard
    ``sd``'s rows on the cells ``(·, sd)``, its replicated computation on
    its home cell ``(0, sd)``."""

    def __init__(self, mesh: LaunchMesh,
                 dp_axes: Sequence[str] = ("data",)):
        self.mesh = mesh
        self.dp_axes = tuple(a for a in dp_axes if a in mesh.axis_names)
        if self.dp_axes not in ((), dp_axes_of(mesh)):
            raise ValueError(f"data-parallel axes {self.dp_axes} on a mesh "
                             f"whose data-parallel axes are "
                             f"{dp_axes_of(mesh)}")
        self.tp = mesh.shape["model"]
        self.dp = dp_size(mesh) if self.dp_axes else 1

    def device(self, sm: int, sd: int = 0) -> torch.device:
        return self.mesh.device(sm, sd)

    def home(self, sd: int = 0) -> torch.device:
        return self.mesh.device(0, sd)

    def split_batch(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Batch rows over the data shards where ``batch_spec`` splits
        them (the batch divides over dp), else one shard of every row."""
        spec = batch_spec(self.mesh, x.shape[0], x.dim()).spec
        if self.dp > 1 and axes_of(spec[0]):
            return split(x, 0, [self.home(sd) for sd in range(self.dp)],
                         [(0, sd) for sd in range(self.dp)])
        return [x.to(self.home(0))]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The data shards' rows, in order, on cell ``(0, 0)``."""
        return all_gather(xs, 0, self.home(0))

    def whole(self, params: Dict[str, Any], sd: int = 0
              ) -> Dict[str, torch.Tensor]:
        """``params`` whole on data shard ``sd``'s home cell (the op is
        computed whole there)."""
        dev = self.home(sd)
        with on_cell(0, sd):
            return {k: v.full(dev, prefer_sd=sd) if isinstance(v, Sharded)
                    else v.to(dev) for k, v in params.items()}

    def cell(self, params: Dict[str, Any], sm: int, sd: int,
             split_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Cell ``(sm, sd)``'s params of a split op: the leaves in
        ``split_keys`` as the cell's pieces (data pieces gathered), every
        other leaf whole, on the cell's device."""
        dev = self.device(sm, sd)
        out = {}
        with on_cell(sm, sd):
            for k, v in params.items():
                if not isinstance(v, Sharded):
                    out[k] = v.to(dev)
                elif k in split_keys:
                    out[k] = v.local(sm, sd)
                else:
                    out[k] = v.full(dev, prefer_sd=sd)
        return out

    def reduce(self, parts: Sequence[torch.Tensor], sd: int
               ) -> torch.Tensor:
        """The sum of the model cells' ``parts`` on data shard ``sd``'s
        home cell."""
        with on_cell(0, sd):
            return all_reduce_sum(parts, self.home(sd))


def splits_on(leaf: Any, dim: int, axis: str = "model") -> bool:
    """Whether ``leaf`` is a :class:`Sharded` split along ``dim`` by
    exactly ``axis``."""
    return isinstance(leaf, Sharded) and axes_of(leaf.spec[dim]) == (axis,)
