"""Mode-A federated simulation: the fused round (port of the fused-engine
part of ``repro/federated/simulation.py``).

Every sampled ``(model, device)`` pair trains a copy of its model on the
device's data for E epochs of minibatch SGD, all pairs at once
(``torch.func.vmap`` of ``torch.func.grad``, where the reference uses
``jax.vmap(jax.grad)``); the models that trained are aggregated by eq 1,
transport-quantized, and written back into the stacked bank; then the
val/test accuracy matrices are computed.
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


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


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


def make_fused_round(loss_fn: Callable, acc_fn: Callable, lr: float,
                     quantize_bits: int = 0) -> Callable:
    """The fused engine's whole round as one call.

    Returns fn(stacked (m_cap, ...) [updated in place], m_idx (B,),
    d_idx (B,), perms (B, T, b), w (A, B), agg_rows (A,), live_idx (L,),
    test_idx (R,), xs, ys, vx, vy, tx, ty) -> (val_mat (L, N),
    test_mat (R, N)); the index and weight arguments are host numpy.

    Semantics, in order (paper Algorithm 1 lines 5-12):
      1. train the gathered (participating & holder) pairs;
      2. score-weighted aggregation of the models that trained, over the
         bucketed (A, B) weight matrix (row j weights the pairs of model
         ``agg_rows[j]``; padding rows repeat row 0);
      3. the transport quantize roundtrip of the A aggregated rows, when
         ``quantize_bits`` is set;
      4. the scatter of the updated rows into the bank;
      5. the live rows ``live_idx`` scored on every device's val split,
         and the rows ``test_idx`` on every device's test split.
    """
    train = _pair_train(loss_fn, lr)
    eval_model = vmap(acc_fn, in_dims=(None, 0, 0))

    def round_step(stacked, m_idx, d_idx, perms, w, agg_rows, live_idx,
                   test_idx, xs, ys, vx, vy, tx, ty):
        device = xs.device
        with torch.no_grad():
            trained = train(stacked, _index(m_idx, device), xs, ys,
                            _index(d_idx, device), _index(perms, device))
            w_t = torch.as_tensor(np.asarray(w, np.float32), device=device)
            agg = _aggregate_rows(trained, w_t, quantize_bits)
            _scatter_rows(stacked, agg, np.asarray(agg_rows))
            val = _eval_gathered(eval_model, stacked, live_idx, vx, vy)
            test = _eval_gathered(eval_model, stacked, test_idx, tx, ty)
        return val, test

    return round_step


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
                      batch_size: int, epochs: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One round's participation mask + shared minibatch perms — the one
    place the sampling stream is consumed, so FedCD and FedAvg servers
    with equal seeds train identical cohorts (static population)."""
    participating = np.zeros(n_devices, bool)
    chosen = rng.choice(n_devices, devices_per_round, replace=False)
    participating[chosen] = True
    perms = make_perms(rng, n_devices, n_examples, batch_size, epochs)
    return participating, perms
