"""Mode-A federated simulation: local SGD on the devices' data (port of
``repro/federated/simulation.py``: the legacy, batched and fused
engines' building blocks).

Every ``(model, device)`` pair trains a copy of its model on the
device's data for E epochs of minibatch SGD, all pairs at once
(``torch.func.vmap`` of ``torch.func.grad``, where the reference uses
``jax.vmap(jax.grad)``). Three generations of round data plane, as in
the reference:

* ``make_local_train`` / ``make_eval`` — the legacy per-model loop's
  building blocks (one model trains on every device);
* ``make_pair_train`` / ``make_group_eval`` — the batched engine: one
  call over gathered (model, device) pairs, dense (M, N) eval matrices;
* the fused engine, synchronous or pipelined alike: ``make_pair_train``
  (training, a pure read of the stacked bank), then ``make_fused_finish``
  (``make_fused_apply``: eq-1 aggregation, the transport roundtrip and
  the scatter into the bank; then the val/test eval matrices of
  ``make_fused_eval``); ``make_pair_eval`` scores holders only (sparse
  eval).

Index, permutation and weight arguments are host numpy arrays; params
and data are tensors on the server's device. A host array reaches the
card through pinned memory without blocking (``to_device``): a pageable
copy would make the host wait for every kernel enqueued before it.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core import quantize as qz
from repro_torch.core.aggregate import multi_weighted_average
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
    the (rows, N) accuracy matrix, one row at a time."""
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
