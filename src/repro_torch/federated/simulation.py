"""Federated simulation: local SGD on the devices' data (port of
``repro/federated/simulation.py``: the legacy, batched, fused and
mesh-sharded engines' building blocks, and the mode-B LM round).

Every ``(model, device)`` pair trains a copy of its model on the
device's data for E epochs of minibatch SGD, all pairs at once
(``torch.func.vmap`` of ``torch.func.grad``, where the reference uses
``jax.vmap(jax.grad)``). The round data planes, as in the reference:

* ``make_local_train`` / ``make_eval`` — the legacy per-model loop's
  building blocks (one model trains on every device);
* ``make_pair_train`` / ``make_group_eval`` — the batched engine: one
  call over gathered (model, device) pairs, dense (M, N) eval matrices;
* the fused engine, synchronous or pipelined alike: ``make_pair_train``
  (training, a pure read of the stacked bank), then ``make_fused_finish``
  (``make_fused_apply``: eq-1 aggregation, the transport roundtrip and
  the scatter into the bank; then the val/test eval matrices of
  ``make_fused_eval``); ``make_pair_eval`` scores holders only (sparse
  eval);
* the sharded planes on a launch mesh: the reference's host bucketing
  (``shard_rows``, ``shard_work_batch``, ``shard_pairs_2d``, ...) and
  per-cell builders (``make_sharded_train``, ``make_sharded_finish``,
  ...), each cell's block run on its own device;
* the mode-B LM plane: ``make_llm_round`` / ``make_llm_eval``, which
  train and score the rows of a per-layer-stacked transformer bank in
  place.

Index, permutation and weight arguments are host numpy arrays; params
and data are tensors on the server's device. A host array reaches the
card through pinned memory without blocking (``to_device``): a pageable
copy would make the host wait for every kernel enqueued before it.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import telemetry
from repro_torch.core import quantize as qz
from repro_torch.core.aggregate import multi_weighted_average
from repro_torch.launch.mesh import (LaunchMesh, data_axis_size,
                                     model_axis_size)
from repro_torch.models.common import Params


def bucket_size(n: int, minimum: int = 8) -> int:
    """Static bucket for the work buffers: round ``n`` up to an
    eighth-octave step (multiples of 2^k/8 within each power-of-two
    octave); padding waste stays < 20% once ``n > 8 * minimum``."""
    if n <= minimum:
        return minimum
    octave = 1 << (n - 1).bit_length()          # next power of two >= n
    step = max(octave // 8, minimum)
    return -(-n // step) * step


def pad_work_batch(model_idx: "list[int]", device_idx: "list[int]",
                   perm_rows: "list[np.ndarray]", minimum: int = 8
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad gathered (model, device, perm) pair lists to one static bucket.
    Padding pairs point at model 0 / device 0 with all-zero perms; callers
    mask them out of aggregation with zero weight columns."""
    b = len(model_idx)
    b_pad = bucket_size(b, minimum)
    m_idx = np.zeros(b_pad, np.int32)
    m_idx[:b] = model_idx
    d_idx = np.zeros(b_pad, np.int32)
    d_idx[:b] = device_idx
    perms = np.zeros((b_pad,) + perm_rows[0].shape, np.int32)
    perms[:b] = np.stack(perm_rows)
    return m_idx, d_idx, perms


def pad_live_rows(live: "list[int]", minimum: int = 1) -> np.ndarray:
    """Pad the live-model row-index list to one static bucket (padding
    rows repeat the first live row; callers slice the first ``len(live)``
    matrix rows)."""
    pad = bucket_size(len(live), minimum=minimum)
    idx = np.full(pad, live[0] if live else 0, np.int32)
    idx[:len(live)] = live
    return idx


def to_device(a: np.ndarray, dtype: type, device: torch.device
              ) -> torch.Tensor:
    """Host array -> tensor of numpy ``dtype`` on ``device``, without
    synchronising the stream: a CUDA copy is staged in pinned memory and
    made non-blocking (PyTorch waits for the stream to drain after a
    pageable copy). On the CPU a plain conversion."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return to_device(a, np.int64, device)


def _pair_train(loss_fn: Callable, lr: float) -> Callable:
    """fn(stacked, m_idx (B,), xs (N, n, ...), ys (N, n), d_idx (B,),
    perms (B, T, b)) -> trained param dict with leading pair axis B.
    Pair k trains bank row ``m_idx[k]`` on data row ``d_idx[k]`` for the
    T minibatches of ``perms[k]``; the (B, n, ...) gathered dataset is
    never materialized, only each step's (B, b, ...) batch."""
    pair_grad = vmap(grad(loss_fn))

    def train(stacked: Params, m_idx: torch.Tensor, xs: torch.Tensor,
              ys: torch.Tensor, d_idx: torch.Tensor,
              perms: torch.Tensor) -> Params:
        params = {k: v[m_idx] for k, v in stacked.items()}
        rows = d_idx[:, None]
        for t in range(perms.shape[1]):
            idx = perms[:, t]
            g = pair_grad(params, (xs[rows, idx], ys[rows, idx]))
            params = {k: p - lr * g[k] for k, p in params.items()}
        return params

    return train


def _aggregate_rows(trained: Params, w: torch.Tensor,
                    quantize_bits: int) -> Params:
    """Steps 2-3 of the round: eq-1 aggregation over the (A, B) weight
    matrix, then the transport quantize roundtrip of the A rows."""
    agg = multi_weighted_average(trained, w)
    return qz.roundtrip_rows(agg, quantize_bits)


def _scatter_rows(stacked: Params, agg: Params, agg_rows: np.ndarray) -> None:
    """Step 4: write the aggregated rows into the bank IN PLACE (the
    reference donates the bank). Padding rows repeat row 0, so each bank
    row is written once, from its first occurrence."""
    _, first = np.unique(agg_rows, return_index=True)
    device = next(iter(stacked.values())).device
    rows, pick = _index(agg_rows[first], device), _index(first, device)
    for k, v in stacked.items():
        v.index_copy_(0, rows, agg[k][pick].to(v.dtype))


def _eval_gathered(eval_model: Callable, stacked: Params, idx: np.ndarray,
                   xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Step 5: score each scheduled bank row on every device's split —
    the (rows, N) accuracy matrix, one row at a time (``eval_rows``)."""
    telemetry.count("eval_rows", len(idx))
    return torch.stack([
        eval_model({k: v[int(m)] for k, v in stacked.items()}, xs, ys)
        for m in idx])


def make_local_train(loss_fn: Callable, lr: float, batch_size: int
                     ) -> Callable:
    """fn(params, xs (N, n, ...), ys (N, n), perms (N, T, b)) -> trained
    param dict with leading device axis N: ONE model trained on EVERY
    device's data (the reference vmaps with ``in_axes=(None, 0, 0, 0)``),
    through the pair trainer with pair k = (model 0, device k).
    ``batch_size`` is implied by ``perms``; it is kept for the
    reference's signature."""
    train = _pair_train(loss_fn, lr)

    def local_train(params: Params, xs: torch.Tensor, ys: torch.Tensor,
                    perms: np.ndarray) -> Params:
        device = xs.device
        n = perms.shape[0]
        stacked = {k: v[None] for k, v in params.items()}
        with torch.no_grad():
            return train(stacked,
                         torch.zeros(n, dtype=torch.int64, device=device),
                         xs, ys, torch.arange(n, device=device),
                         _index(perms, device))

    return local_train


def make_eval(acc_fn: Callable) -> Callable:
    """fn(params, xs (N, n, ...), ys (N, n)) -> (N,) accuracy of one
    model on every device's split."""
    eval_model = vmap(acc_fn, in_dims=(None, 0, 0))

    def evaluate(params: Params, xs: torch.Tensor,
                 ys: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return eval_model(params, xs, ys)

    return evaluate


def make_pair_train(loss_fn: Callable, lr: float) -> Callable:
    """Step 1 of a round (paper Algorithm 1 lines 5-12), multi-model
    local training over a gathered work batch: fn(stacked (M, ...),
    m_idx (B,), xs, ys, d_idx (B,), perms (B, T, b)) -> trained param
    dict with leading pair axis B. Pair k trains row ``m_idx[k]`` of
    ``stacked`` on device ``d_idx[k]``'s data; only ``(participating &
    holder)`` pairs are gathered, so the work is O(pairs), not the
    legacy O(models x devices). A pure read of the bank (no scatter, no
    aggregation), which is what lets the pipelined executors enqueue
    round t+1's training while round t's eval matrices are still on
    their way to the host, and drop the result on a misspeculation."""
    train = _pair_train(loss_fn, lr)

    def pair_train(stacked: Params, m_idx: np.ndarray, xs: torch.Tensor,
                   ys: torch.Tensor, d_idx: np.ndarray,
                   perms: np.ndarray) -> Params:
        device = xs.device
        with torch.no_grad():
            return train(stacked, _index(m_idx, device), xs, ys,
                         _index(d_idx, device), _index(perms, device))

    return pair_train


def make_group_eval(acc_fn: Callable) -> Callable:
    """fn(stacked (M, ...), xs, ys) -> (M, N) accuracy of every model on
    every device's split (the batched engine's eval matrix)."""
    eval_model = vmap(acc_fn, in_dims=(None, 0, 0))

    def group_eval(stacked: Params, xs: torch.Tensor,
                   ys: torch.Tensor) -> torch.Tensor:
        rows = np.arange(next(iter(stacked.values())).shape[0])
        with torch.no_grad():
            return _eval_gathered(eval_model, stacked, rows, xs, ys)

    return group_eval


def make_fused_apply(quantize_bits: int = 0) -> Callable:
    """Steps 2-4 of a round: fn(stacked [updated in place], trained
    (B, ...), w (A, B), agg_rows (A,)) -> None.
      2. score-weighted aggregation of the models that trained, over the
         bucketed (A, B) weight matrix (row j weights the pairs of model
         ``agg_rows[j]``; padding rows repeat row 0);
      3. the transport quantize roundtrip of the A aggregated rows, when
         ``quantize_bits`` is set;
      4. the scatter of the updated rows into the bank.
    The weights and scatter rows arrive after training was enqueued,
    which is what lets the host resolve them from round t-1's readback
    while training runs."""

    def apply_step(stacked: Params, trained: Params, w: np.ndarray,
                   agg_rows: np.ndarray) -> None:
        device = next(iter(stacked.values())).device
        with torch.no_grad():
            agg = _aggregate_rows(trained, to_device(w, np.float32, device),
                                  quantize_bits)
            _scatter_rows(stacked, agg, np.asarray(agg_rows))

    return apply_step


def make_fused_finish(acc_fn: Callable, quantize_bits: int = 0) -> Callable:
    """Everything AFTER training as one call: fn(stacked [updated in
    place], trained (B, ...), w (A, B), agg_rows (A,), live_idx (L,),
    test_idx (R,), vx, vy, tx, ty) -> (val (L, N), test (R, N)). Steps
    2-4 are ``make_fused_apply``; step 5 scores the rows ``live_idx`` on
    every device's val split and the rows ``test_idx`` on every
    device's test split. The index and weight arguments are host
    numpy."""
    apply_step = make_fused_apply(quantize_bits)
    eval_model = vmap(acc_fn, in_dims=(None, 0, 0))

    def finish_step(stacked, trained, w, agg_rows, live_idx, test_idx,
                    vx, vy, tx, ty):
        apply_step(stacked, trained, w, agg_rows)
        with torch.no_grad():
            val = _eval_gathered(eval_model, stacked, live_idx, vx, vy)
            test = _eval_gathered(eval_model, stacked, test_idx, tx, ty)
        return val, test

    return finish_step


def make_pair_eval(acc_fn: Callable) -> Callable:
    """Holder-only (sparse) evaluation: fn(stacked, m_idx (P,),
    d_idx (P,), xs, ys) -> (P,) accuracy of bank row ``m_idx[k]`` on
    device ``d_idx[k]``'s split, in pair order (host numpy indices).
    The pairs are grouped by model: each model's holders are scored in
    one call of the dense path's per-row eval, on their gathered splits,
    so O(active pairs) eval work and no per-pair copy of the params."""
    eval_model = vmap(acc_fn, in_dims=(None, 0, 0))

    def pair_eval(stacked: Params, m_idx: np.ndarray, d_idx: np.ndarray,
                  xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        m_idx, d_idx = np.asarray(m_idx), np.asarray(d_idx)
        device = xs.device
        if not len(m_idx):
            return torch.zeros(0, dtype=torch.float32, device=device)
        order, parts = [], []
        with torch.no_grad():
            for m in np.unique(m_idx):
                sel = np.nonzero(m_idx == m)[0]
                rows = _index(d_idx[sel], device)
                parts.append(eval_model(
                    {k: v[int(m)] for k, v in stacked.items()},
                    xs[rows], ys[rows]))
                order.append(sel)
            inverse = np.argsort(np.concatenate(order), kind="stable")
            return torch.cat(parts)[_index(inverse, device)]

    return pair_eval


def make_fused_eval(acc_fn: Callable) -> Callable:
    """fn(stacked (m_cap, ...), live_idx (L,), xs, ys) -> (L, N): the
    standalone eval-matrix call, for rounds with no training pairs, the
    quantized-cloning refresh and test-row mispredictions."""
    eval_model = vmap(acc_fn, in_dims=(None, 0, 0))

    def mat(stacked, live_idx, xs, ys):
        with torch.no_grad():
            return _eval_gathered(eval_model, stacked, live_idx, xs, ys)

    return mat


# -- the mesh-sharded planes -------------------------------------------------
#
# Port of ``repro/federated/simulation.py:339-1057``. The reference runs
# each round phase as one ``shard_map`` program over the launch mesh; the
# port runs each CELL's block of the phase on the cell's device, from one
# host thread, in cell order (model-major: ``cell = sm * Sd + sd``). Host
# arrays keep the reference's flat layouts — ``(C*B,)`` pair buckets,
# ``(S*A, B)`` / ``(Sm*A, Sd*B)`` weight grids, ``(S*L,)`` row buckets —
# so the bucketing below is the reference's, copied as is. A cell whose
# bucket is all padding is not launched (``run``): its outputs are
# discarded in the reference too. The monolithic ``make_sharded_round``
# and ``make_sharded2d_round`` are not ported: the port has one
# train-then-finish launch path.

def shard_rows(rows: "list[int]", rows_per_shard: int, n_shards: int,
               minimum: int = 1) -> Tuple[np.ndarray, List[List[int]], int]:
    """Partition global bank-row ids by owning shard (row ``m`` lives on
    shard ``m // rows_per_shard``) and pad every shard's list to ONE
    shared bucket ``L = bucket_size(max per-shard count, minimum)``.

    Returns ``(idx, groups, L)``: ``idx`` is the (S*L,) int32 array of
    LOCAL row indices (shard s reads ``idx[s*L:(s+1)*L]``), ``groups[s]``
    lists shard s's global ids in bucket order — the matrix row of global
    id ``groups[s][j]`` in a sharded (S*L, N) eval output is ``s*L + j``.
    Padding entries repeat the shard's first real local row (or local row
    0 on an empty shard); callers discard their output rows."""
    groups: List[List[int]] = [[] for _ in range(n_shards)]
    for r in rows:
        groups[r // rows_per_shard].append(r)
    width = bucket_size(max((len(g) for g in groups), default=0),
                        minimum=minimum)
    idx = np.zeros(n_shards * width, np.int32)
    for s, g in enumerate(groups):
        base = s * width
        fill = g[0] - s * rows_per_shard if g else 0
        idx[base:base + width] = fill
        idx[base:base + len(g)] = [r - s * rows_per_shard for r in g]
    return idx, groups, width


def shard_work_batch(pair_model: "list[int]", pair_device: "list[int]",
                     perm_rows: "list[np.ndarray]", rows_per_shard: int,
                     n_shards: int, minimum: int = 8
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                List[List[int]], int]:
    """Bucket the gathered (model row, device) pairs per OWNING shard:
    pair k goes to shard ``pair_model[k] // rows_per_shard`` with a
    shard-LOCAL model index, every shard's list padded to one shared
    bucket ``B`` (padding pairs point at local row 0 / device 0 with
    all-zero perms and get zero weight columns).

    Returns ``(m_idx (S*B,), d_idx (S*B,), perms (S*B, T, b),
    pair_groups, B)``; ``pair_groups[s]`` lists the original pair
    positions of shard s in bucket-column order."""
    groups: List[List[int]] = [[] for _ in range(n_shards)]
    for k, m in enumerate(pair_model):
        groups[m // rows_per_shard].append(k)
    width = bucket_size(max(len(g) for g in groups), minimum)
    m_idx = np.zeros(n_shards * width, np.int32)
    d_idx = np.zeros(n_shards * width, np.int32)
    perms = np.zeros((n_shards * width,) + perm_rows[0].shape, np.int32)
    for s, g in enumerate(groups):
        base = s * width
        for j, k in enumerate(g):
            m_idx[base + j] = pair_model[k] - s * rows_per_shard
            d_idx[base + j] = pair_device[k]
            perms[base + j] = perm_rows[k]
    return m_idx, d_idx, perms, groups, width


def shard_eval_pairs(pair_rows: "list[int]", pair_device: "list[int]",
                     rows_per_shard: int, n_shards: int,
                     minimum: int = 8
                     ) -> Tuple[np.ndarray, np.ndarray,
                                List[List[int]], int]:
    """Bucket (bank row, device) eval pairs per OWNING shard (the eval
    analogue of ``shard_work_batch``). Returns ``(m_idx (S*P,),
    d_idx (S*P,), groups, P)``; the output slot of pair
    ``groups[s][j]`` in the (S*P,) accuracy vector is ``s*P + j``."""
    groups: List[List[int]] = [[] for _ in range(n_shards)]
    for k, r in enumerate(pair_rows):
        groups[r // rows_per_shard].append(k)
    width = bucket_size(max((len(g) for g in groups), default=0), minimum)
    m_idx = np.zeros(n_shards * width, np.int32)
    d_idx = np.zeros(n_shards * width, np.int32)
    for s, g in enumerate(groups):
        base = s * width
        for j, k in enumerate(g):
            m_idx[base + j] = pair_rows[k] - s * rows_per_shard
            d_idx[base + j] = pair_device[k]
    return m_idx, d_idx, groups, width


def shard_pairs_2d(pair_mrows: "list[int]", pair_drows: "list[int]",
                   perm_rows: "list[np.ndarray]", rows_per_mshard: int,
                   n_mshards: int, rows_per_dshard: int, n_dshards: int,
                   minimum: int = 2
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              List[List[int]], int]:
    """Bucket gathered work pairs per owning MESH CELL: pair k (model
    bank row ``pair_mrows[k]``, data bank row ``pair_drows[k]``) runs on
    model shard ``pair_mrows[k] // rows_per_mshard`` × data shard
    ``pair_drows[k] // rows_per_dshard``; cells are model-major
    (``cell = sm * n_dshards + sd``). Every cell pads to ONE shared
    bucket ``B``. Returns ``(m_idx (C*B,), d_idx (C*B,), perms (C*B, T,
    b), cell_groups, B)``, both index arrays shard-LOCAL; at one data
    shard this is ``shard_work_batch``'s bucketing."""
    n_cells = n_mshards * n_dshards
    groups: List[List[int]] = [[] for _ in range(n_cells)]
    for k, (mr, dr) in enumerate(zip(pair_mrows, pair_drows)):
        cell = (mr // rows_per_mshard) * n_dshards + dr // rows_per_dshard
        groups[cell].append(k)
    width = bucket_size(max((len(g) for g in groups), default=0), minimum)
    m_idx = np.zeros(n_cells * width, np.int32)
    d_idx = np.zeros(n_cells * width, np.int32)
    perms = np.zeros((n_cells * width,) + perm_rows[0].shape, np.int32)
    for c, g in enumerate(groups):
        base = c * width
        for j, k in enumerate(g):
            m_idx[base + j] = pair_mrows[k] % rows_per_mshard
            d_idx[base + j] = pair_drows[k] % rows_per_dshard
            perms[base + j] = perm_rows[k]
    return m_idx, d_idx, perms, groups, width


def shard_eval_pairs_2d(pair_mrows: "list[int]", pair_drows: "list[int]",
                        rows_per_mshard: int, n_mshards: int,
                        rows_per_dshard: int, n_dshards: int,
                        minimum: int = 2
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   List[List[int]], int]:
    """``shard_eval_pairs`` per mesh CELL: pair k goes to cell (model
    shard × data shard) with shard-LOCAL row indices; the output slot of
    pair ``cell_groups[c][j]`` in the (C*P,) accuracy vector is
    ``c*P + j``."""
    n_cells = n_mshards * n_dshards
    groups: List[List[int]] = [[] for _ in range(n_cells)]
    for k, (mr, dr) in enumerate(zip(pair_mrows, pair_drows)):
        cell = (mr // rows_per_mshard) * n_dshards + dr // rows_per_dshard
        groups[cell].append(k)
    width = bucket_size(max((len(g) for g in groups), default=0), minimum)
    m_idx = np.zeros(n_cells * width, np.int32)
    d_idx = np.zeros(n_cells * width, np.int32)
    for c, g in enumerate(groups):
        base = c * width
        for j, k in enumerate(g):
            m_idx[base + j] = pair_mrows[k] % rows_per_mshard
            d_idx[base + j] = pair_drows[k] % rows_per_dshard
    return m_idx, d_idx, groups, width


def _cells(mesh: LaunchMesh) -> List[Tuple[int, int]]:
    """The mesh's cells ``(sm, sd)`` in model-major order."""
    return [(sm, sd) for sm in range(model_axis_size(mesh))
            for sd in range(data_axis_size(mesh))]


def _shared_device(mesh: LaunchMesh) -> Optional[torch.device]:
    """The one device every cell of ``mesh`` lies on, else None."""
    return mesh.devices[0] if len(set(mesh.devices)) == 1 else None


def make_sharded_train(loss_fn: Callable, lr: float, mesh: LaunchMesh
                       ) -> Callable:
    """The TRAIN phase over the mesh's cells (the reference's
    ``make_sharded_train``, ``make_sharded2d_train`` and both FedAvg
    trains, ``simulation.py:468-495, 746-764, 897-904, 992-1010``):
    fn(bank, databank, m_idx (C*B,), d_idx (C*B,), perms (C*B, T, b),
    counts (C,)) -> [trained (B, ...) of cell c, or None]. ``bank`` is
    the FedCD param bank or FedAvg's global model (``resident``,
    ``tree``, ``rows_per_shard``); indices are shard-LOCAL;
    ``counts[c]`` real pairs lead cell c's bucket, and a cell without
    any is not launched. A pure read of both banks, so the pipelined
    executors can enqueue it speculatively.

    Cells on distinct devices each train their B-pair block on their own
    device, against the model block and the data shard they hold. Cells
    that share one device train together in ONE call: every cell's real
    pairs at global rows, padded as the fused engine pads its batch
    (``pad_work_batch``); each cell's block is then gathered out of it,
    with zero rows for its padding (zero weight in every reduction).
    A pair's result depends on the width of the batch it trains in (on
    the CNN the wgrad kernel cuts its pixel sums into more slices the
    fewer pairs a call has), so one call keeps a one-device mesh's
    training bit-equal to the fused engine's, whose per-pair results do
    not depend on the pairs' order."""
    train = _pair_train(loss_fn, lr)
    cells = _cells(mesh)
    shared = _shared_device(mesh)

    def per_cell(bank, databank, m_idx, d_idx, perms, counts, width):
        out: List[Optional[Params]] = []
        for c, (sm, sd) in enumerate(cells):
            if not counts[c]:
                out.append(None)
                continue
            dev = mesh.device(sm, sd)
            sl = slice(c * width, (c + 1) * width)
            xs, ys = databank.resident(sd, "train", dev)
            out.append(train(bank.resident(sm, dev), _index(m_idx[sl], dev),
                             xs, ys, _index(d_idx[sl], dev),
                             _index(perms[sl], dev)))
        return out

    def together(bank, databank, m_idx, d_idx, perms, counts, width):
        slots = [c * width + j for c in range(len(cells))
                 for j in range(counts[c])]
        if not slots:
            return [None] * len(cells)
        gm = [int(m_idx[k]) + cells[k // width][0] * bank.rows_per_shard
              for k in slots]
        gd = [int(d_idx[k]) + cells[k // width][1] * databank.rows_per_shard
              for k in slots]
        gm, gd, pp = pad_work_batch(gm, gd, [perms[k] for k in slots])
        out = train(bank.tree, _index(gm, shared), *databank.splits["train"],
                    _index(gd, shared), _index(pp, shared))
        # row len(gm) of ``padded`` is the zero row of the cells' padding
        padded = {k: torch.cat([v, torch.zeros_like(v[:1])])
                  for k, v in out.items()}
        row = {k: i for i, k in enumerate(slots)}
        blocks: List[Optional[Params]] = []
        for c in range(len(cells)):
            if not counts[c]:
                blocks.append(None)
                continue
            idx = _index(np.asarray([row.get(c * width + j, len(gm))
                                     for j in range(width)]), shared)
            blocks.append({k: v.index_select(0, idx)
                           for k, v in padded.items()})
        return blocks

    def sharded_train(bank, databank, m_idx, d_idx, perms, counts):
        width = len(m_idx) // len(cells)
        with torch.no_grad():
            return (together if shared is not None else per_cell)(
                bank, databank, m_idx, d_idx, perms, counts, width)

    return sharded_train


def _write_shard(bank, s: int, agg: Params, agg_rows: np.ndarray) -> None:
    """Scatter one shard's aggregated rows into its block in place."""
    _scatter_rows(bank.block(s), agg, agg_rows)
    bank.mark_written(s)


def make_sharded_apply(mesh: LaunchMesh, quantize_bits: int = 0
                       ) -> Callable:
    """Aggregate + writeback on the 1-D model mesh
    (``simulation.py:498-518``): fn(bank [updated in place], trained
    [per shard], w (S*A, B), agg_rows (S*A,) LOCAL, keep (S*A,)) -> None.
    Shard s aggregates its A rows from its (A, B) weight block of its own
    trained pairs — eq 1 through the kernel, one grouped launch per shard
    with work — quantize-roundtrips them and scatters into its block.
    ``keep`` false (a shard without aggregation work) leaves the shard's
    rows as they are: the reference writes their existing values back."""
    n = model_axis_size(mesh)

    def apply_step(bank, trained, w, agg_rows, keep):
        a = len(agg_rows) // n
        with torch.no_grad():
            for s in range(n):
                sl = slice(s * a, (s + 1) * a)
                if not keep[sl].any():
                    continue
                dev = bank.devices[s]
                agg = _aggregate_rows(trained[s],
                                      to_device(w[sl], np.float32, dev),
                                      quantize_bits)
                _write_shard(bank, s, agg, agg_rows[sl])

    return apply_step


def _aggregate_rows_psum(parts: List[Tuple[Params, torch.Tensor]],
                         owner: torch.device, quantize_bits: int
                         ) -> Params:
    """Steps 2-3 on the 2-D mesh (``simulation.py:672-693``): each cell's
    (trained block, (A, B) weight block) gives eq-1 PARTIAL sums
    ``einsum("b...,ab->a...")`` and ``rowsum(w)`` on its device; the sum
    over the ``data`` axis (the reference's ``psum``) adds them on the
    model shard's owner device in ascending ``sd`` order, then divides
    and quantize-roundtrips. Plain PyTorch, as the reference keeps the
    kernel off this plane."""
    num: Optional[Params] = None
    den: Optional[torch.Tensor] = None
    for trained, w in parts:
        part = {k: torch.einsum("b...,ab->a...", v.float(), w).to(
            owner, non_blocking=True) for k, v in trained.items()}
        dpart = w.sum(dim=1).to(owner, non_blocking=True)
        if num is None:
            num, den = part, dpart
        else:
            num = {k: num[k] + part[k] for k in num}
            den = den + dpart
    den = torch.clamp(den, min=1e-12)
    ref = parts[0][0]
    agg = {k: (n / den.reshape((-1,) + (1,) * (n.dim() - 1))
               ).to(ref[k].dtype) for k, n in num.items()}
    return qz.roundtrip_rows(agg, quantize_bits)


def make_sharded2d_apply(mesh: LaunchMesh, quantize_bits: int = 0
                         ) -> Callable:
    """Aggregate + writeback on the 2-D mesh (``simulation.py:767-783``):
    fn(bank [updated in place], trained [per cell], w (Sm*A, Sd*B),
    agg_rows (Sm*A,) LOCAL, keep (Sm*A,)) -> None. Model shard sm's A
    rows complete eq 1 over the partial sums of its cells
    (:func:`_aggregate_rows_psum`) and are written once, into the owner
    block; cells of the shard on other devices read it through the
    bank's refreshed copies."""
    n_m, n_d = model_axis_size(mesh), data_axis_size(mesh)

    def apply_step(bank, trained, w, agg_rows, keep):
        a = len(agg_rows) // n_m
        b = w.shape[1] // n_d
        with torch.no_grad():
            for sm in range(n_m):
                sl = slice(sm * a, (sm + 1) * a)
                if not keep[sl].any():
                    continue
                parts = []
                for sd in range(n_d):
                    t = trained[sm * n_d + sd]
                    if t is not None:
                        dev = next(iter(t.values())).device
                        wb = w[sl, sd * b:(sd + 1) * b]
                        parts.append((t, to_device(wb, np.float32, dev)))
                agg = _aggregate_rows_psum(parts, bank.devices[sm],
                                           quantize_bits)
                _write_shard(bank, sm, agg, agg_rows[sl])

    return apply_step


def make_sharded_eval(acc_fn: Callable, mesh: LaunchMesh) -> Callable:
    """The eval matrix over a sharded bank (``simulation.py:449-465,
    815-830``): fn(bank, databank, idx (Sm*L,) LOCAL rows from
    ``shard_rows``, split, run (Sm,)) -> (Sm*L, n_cap) on cell (0, 0)'s
    device. Cell ``(sm, sd)`` scores model shard sm's rows on data shard
    sd's split (its columns are data rows); the blocks cross to cell
    (0, 0) in cell order — the readback boundary. Where every cell
    shares one device, each row is scored on every device's split in
    one call, as the fused engine scores it. A padding row repeats its
    shard's first row and is scored once; a shard with ``run`` false is
    not launched and reads zeros."""
    eval_model = vmap(acc_fn, in_dims=(None, 0, 0))
    n_m, n_d = model_axis_size(mesh), data_axis_size(mesh)
    out_dev = mesh.device(0, 0)
    shared = _shared_device(mesh)

    def mat(bank, databank, idx, split, run):
        width = len(idx) // n_m
        rows = []
        with torch.no_grad():
            if shared is not None:
                sel = np.asarray([sm * width + j for sm in range(n_m)
                                  if run[sm] for j in range(width)],
                                 np.int64)
                out = torch.zeros(len(idx), databank.n_cap, device=out_dev)
                if len(sel):
                    rows_g = idx[sel] + (sel // width) * bank.rows_per_shard
                    uniq, inv = np.unique(rows_g, return_inverse=True)
                    block = _eval_gathered(eval_model, bank.tree, uniq,
                                           *databank.splits[split])
                    out.index_copy_(0, _index(sel, out_dev),
                                    block[_index(inv, out_dev)])
                return out
            for sm in range(n_m):
                if not run[sm]:
                    rows.append(torch.zeros(width, databank.n_cap,
                                            device=out_dev))
                    continue
                uniq, inv = np.unique(idx[sm * width:(sm + 1) * width],
                                      return_inverse=True)
                cols = []
                for sd in range(n_d):
                    dev = mesh.device(sm, sd)
                    xs, ys = databank.resident(sd, split, dev)
                    block = _eval_gathered(eval_model,
                                           bank.resident(sm, dev), uniq,
                                           xs, ys)
                    cols.append(block.to(out_dev, non_blocking=True))
                rows.append(torch.cat(cols, dim=1)[_index(inv, out_dev)])
        return torch.cat(rows)

    return mat


def make_sharded_pair_eval(acc_fn: Callable, mesh: LaunchMesh) -> Callable:
    """Holder-only eval over the mesh's cells (``simulation.py:552-571,
    833-852``): fn(bank, databank, m_idx (C*P,) LOCAL model rows,
    d_idx (C*P,) LOCAL data rows, split, counts (C,)) -> (C*P,)
    accuracies on cell (0, 0)'s device, in ``shard_eval_pairs(_2d)``
    slot order; ``counts[c]`` real pairs lead cell c's bucket, and the
    padding slots read zeros. Where every cell shares one device, the
    real pairs are scored in one call at global rows, as the fused
    engine scores them."""
    pair_eval = make_pair_eval(acc_fn)
    cells = _cells(mesh)
    out_dev = mesh.device(0, 0)
    shared = _shared_device(mesh)

    def sharded_pair_eval(bank, databank, m_idx, d_idx, split, counts):
        width = len(m_idx) // len(cells)
        if shared is not None:
            slots = np.asarray([c * width + j for c in range(len(cells))
                                for j in range(counts[c])], np.int64)
            out = torch.zeros(len(m_idx), device=out_dev)
            if len(slots):
                sm = np.asarray([cells[k // width][0] for k in slots])
                sd = np.asarray([cells[k // width][1] for k in slots])
                vec = pair_eval(bank.tree,
                                m_idx[slots] + sm * bank.rows_per_shard,
                                d_idx[slots] + sd * databank.rows_per_shard,
                                *databank.splits[split])
                out.index_copy_(0, _index(slots, out_dev), vec)
            return out
        parts = []
        for c, (sm, sd) in enumerate(cells):
            if not counts[c]:
                parts.append(torch.zeros(width, device=out_dev))
                continue
            dev = mesh.device(sm, sd)
            sl = slice(c * width, c * width + counts[c])
            vec = pair_eval(bank.resident(sm, dev), m_idx[sl], d_idx[sl],
                            *databank.resident(sd, split, dev))
            parts.append(torch.cat([vec.to(out_dev, non_blocking=True),
                                    torch.zeros(width - counts[c],
                                                device=out_dev)]))
        return torch.cat(parts)

    return sharded_pair_eval


def make_sharded_finish(acc_fn: Callable, mesh: LaunchMesh,
                        quantize_bits: int = 0) -> Callable:
    """Everything after training on the mesh (``simulation.py:521-549,
    786-812``): fn(bank [updated in place], databank, trained [per cell],
    w, agg_rows, keep, live_idx (Sm*L,), live_run (Sm,), test_idx
    (Sm*R,), test_run (Sm,)) -> (val (Sm*L, n_cap), test (Sm*R,
    n_cap)). The apply is :func:`make_sharded_apply` on a 1-D mesh (eq 1
    through the kernel) and :func:`make_sharded2d_apply` with a data axis
    (eq 1 completed by the data-axis sum)."""
    apply_step = (make_sharded_apply if data_axis_size(mesh) == 1
                  else make_sharded2d_apply)(mesh, quantize_bits)
    evaluate = make_sharded_eval(acc_fn, mesh)

    def finish_step(bank, databank, trained, w, agg_rows, keep, live_idx,
                    live_run, test_idx, test_run):
        apply_step(bank, trained, w, agg_rows, keep)
        return (evaluate(bank, databank, live_idx, "val", live_run),
                evaluate(bank, databank, test_idx, "test", test_run))

    return finish_step


def make_sharded_fedavg_eval(acc_fn: Callable, mesh: LaunchMesh
                             ) -> Callable:
    """FedAvg's global model scored on every device (``simulation.py:
    1039-1055``): fn(params_at, databank, split) -> (1, n_cap) on cell
    (0, 0)'s device. Data slice sd scores it on its own rows (cell
    (0, sd)); where every cell shares one device, one call scores every
    device's split, as the fused engine does."""
    eval_model = vmap(acc_fn, in_dims=(None, 0, 0))
    out_dev = mesh.device(0, 0)

    def evaluate(params_at, databank, split):
        telemetry.count("eval_rows")
        cols = []
        with torch.no_grad():
            if _shared_device(mesh) is not None:
                model = {k: v[0] for k, v in params_at(0, out_dev).items()}
                return eval_model(model, *databank.splits[split])[None]
            for sd in range(data_axis_size(mesh)):
                dev = mesh.device(0, sd)
                model = {k: v[0] for k, v in params_at(0, dev).items()}
                xs, ys = databank.resident(sd, split, dev)
                cols.append(eval_model(model, xs, ys).to(
                    out_dev, non_blocking=True))
        return torch.cat(cols)[None]

    return evaluate


def make_sharded_fedavg_finish(acc_fn: Callable, mesh: LaunchMesh
                               ) -> Callable:
    """FedAvg's aggregate + eval on the mesh (``simulation.py:907-946,
    1013-1036``): fn(model, databank, trained [per cell], w (C*B,)) ->
    (val (1, n_cap), test (1, n_cap)). ``model`` holds the (1, ...)
    global model on cell (0, 0) (``model.stacked``, updated in place),
    its copies for other devices (``model.resident``) and
    ``model.mark_written()``. Each cell reduces the partial weighted sum
    of its pairs, ``einsum("b...,b->...")``, and ``sum(w)`` on its
    device; the sum over every cell (the reference's ``psum`` over both
    axes) adds them on cell (0, 0)'s device in cell order, then the
    quotient overwrites the global model, which every cell then scores.
    Plain PyTorch, as in the reference."""
    cells = _cells(mesh)
    owner = mesh.device(0, 0)
    evaluate = make_sharded_fedavg_eval(acc_fn, mesh)

    def finish_step(model, databank, trained, w):
        stacked = model.stacked
        width = len(w) // len(cells)
        num: Optional[Params] = None
        den: Optional[torch.Tensor] = None
        with torch.no_grad():
            for c, t in enumerate(trained):
                if t is None:
                    continue
                dev = next(iter(t.values())).device
                wc = to_device(w[c * width:(c + 1) * width], np.float32, dev)
                part = {k: torch.einsum("b...,b->...", v.float(), wc).to(
                    owner, non_blocking=True) for k, v in t.items()}
                dpart = wc.sum().to(owner, non_blocking=True)
                if num is None:
                    num, den = part, dpart
                else:
                    num = {k: num[k] + part[k] for k in num}
                    den = den + dpart
            den = torch.clamp(den, min=1e-12)
            for k, v in stacked.items():
                v[0].copy_((num[k] / den).to(v.dtype))
        model.mark_written()
        return (evaluate(model.resident, databank, "val"),
                evaluate(model.resident, databank, "test"))

    return finish_step


def make_perms(rng: np.random.Generator, n_devices: int, n_examples: int,
               batch_size: int, epochs: int) -> np.ndarray:
    """(N, epochs*steps, batch) minibatch index matrices, drawn by one
    ``rng.permuted`` call (the reference's stream walk)."""
    steps = max(n_examples // batch_size, 1)
    flat = np.broadcast_to(np.arange(n_examples, dtype=np.int32),
                           (n_devices * epochs, n_examples))
    perms = rng.permuted(flat, axis=1)
    perms = perms.reshape(n_devices, epochs, n_examples)
    return perms[:, :, :steps * batch_size].reshape(
        n_devices, epochs * steps, batch_size)


def draw_round_sample(rng: np.random.Generator, n_devices: int,
                      devices_per_round: int, n_examples: int,
                      batch_size: int, epochs: int,
                      present: "np.ndarray | None" = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One round's participation mask + shared minibatch perms — the one
    place the sampling stream is consumed, so FedCD and FedAvg servers
    with equal seeds train identical cohorts. ``present`` (churn
    scenarios): sample only present device ids, clamping the cohort to
    the population; the full-fleet fast path consumes the generator
    exactly as the presence-free form, so static runs keep their
    streams."""
    participating = np.zeros(n_devices, bool)
    if present is None or present.all():
        chosen = rng.choice(n_devices, devices_per_round, replace=False)
    else:
        ids = np.nonzero(present)[0]
        k = min(devices_per_round, len(ids))
        chosen = ids[rng.choice(len(ids), k, replace=False)]
    participating[chosen] = True
    perms = make_perms(rng, n_devices, n_examples, batch_size, epochs)
    return participating, perms


# -- mode-B LM round programs (DESIGN.md §14) -----------------------------

def _bank_row(bank: Params, r: int) -> Params:
    """Bank row ``r`` as views: in-place writes land in the bank."""
    return {k: v[r] for k, v in bank.items()}


def _eval_rows(acc_fn: Callable, bank: Params, eval_rows: "list[int]",
               vt: torch.Tensor, vl: torch.Tensor) -> torch.Tensor:
    if not len(eval_rows):
        return torch.zeros((0, vt.shape[0]), device=vt.device)
    return torch.stack([acc_fn(_bank_row(bank, int(r)), vt, vl)
                        for r in eval_rows])                 # (L, N)


def make_llm_round(train_fn: Callable, acc_fn: Callable) -> Callable:
    """A mode-B LM round over a per-layer-stacked bank: train each of the
    listed rows IN PLACE with its per-client weight row, then evaluate
    per-client accuracy on each eval row. Returns (losses (T,), accs
    (L, N)), both on the bank's device, without waiting for the card.

    The reference gathers the training rows into a copy of the bank,
    scans the step over it, scatters the rows back, then gathers the
    eval rows into another copy (and pads both row lists to stable
    shapes against retraces). The rows are independent — every
    contraction stays within one model — so training each row where it
    lies computes the same values without the copies (at full width a
    copy of a row is a whole model), and there is nothing to retrace.

    ``train_fn``/``acc_fn`` are the single-model steps of
    ``launch.steps.make_train_step`` (which updates its params in place)
    and ``llm.make_acc_step``."""

    def round_step(bank: Params, train_rows, w: torch.Tensor, tokens,
                   labels, vt, vl, eval_rows):
        losses = []
        for r, wm in zip(train_rows, w):
            _, met = train_fn(_bank_row(bank, int(r)), tokens, labels, wm,
                              None)
            losses.append(met["loss"])
        return torch.stack(losses), _eval_rows(acc_fn, bank, eval_rows,
                                               vt, vl)

    return round_step


def make_llm_eval(acc_fn: Callable) -> Callable:
    """Eval-only LM round (no model trains): per-client accuracy of each
    eval row of the bank, which it only reads."""

    def eval_step(bank: Params, eval_rows, vt, vl):
        return _eval_rows(acc_fn, bank, eval_rows, vt, vl)

    return eval_step
