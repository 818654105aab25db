"""Score-weighted federated aggregation, paper eq 1 (port of
``repro/core/aggregate.py``).

``w_m = Σ_i w_m_i · c_m_i / Σ_i c_m_i`` over the devices contributing to
model m. (The paper's printed denominator Σ_m c_m_i is a typo — it equals
1 after eq 3 and would make w_m a *sum*, not an average; the literal form
is available behind ``literal_eq1=True``, as in the reference.)

Every leaf goes through ``kernels.weighted_agg.ops``: on CUDA tensors
that is a hand-written kernel (the reference keeps its Pallas kernels
behind ``use_kernel=True``; here the kernels are the path), on CPU
tensors its plain version. Each call is one grouped call over every leaf
of the param dict, so one launch on the card: ``multi_weighted_average``
(the fused and batched engines) through ``multi_weighted_agg_group``,
``weighted_average`` (the legacy engines) through ``weighted_agg_group``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.weighted_agg import ops as wa_ops
from repro_torch.models.common import Params


def multi_weighted_average(stacked_updates: Params, weights: torch.Tensor,
                           literal_eq1: bool = False) -> Params:
    """Aggregate every model that trained from one shared work batch.

    stacked_updates: param dict with leading pair axis B; weights (M, B)
    with row m carrying c_m_i for pairs that belong to model m and 0
    elsewhere (padding pairs are all-zero columns). Returns a param dict
    with leading model axis M."""
    w = weights.float().contiguous()
    denoms = (torch.ones_like(w[:, 0]) if literal_eq1
              else torch.clamp(w.sum(dim=1), min=1e-12))
    leaves = list(stacked_updates.values())
    aggs = wa_ops.multi_weighted_agg_group(
        [leaf.reshape(leaf.shape[0], -1).float().contiguous()
         for leaf in leaves], w, denoms)
    return {name: agg.reshape((w.shape[0],) + tuple(leaf.shape[1:])
                              ).to(leaf.dtype)
            for name, leaf, agg in zip(stacked_updates, leaves, aggs)}


def weighted_average(stacked_updates: Params, weights: torch.Tensor,
                     literal_eq1: bool = False) -> Params:
    """stacked_updates: param dict with leading device axis N; weights
    (N,). Devices with weight 0 contribute nothing (deleted or
    non-participating) — unless their update is not finite: like the
    reference, the kernel multiplies every row. The denominator stays a
    0-d tensor on the weights' device."""
    w = weights.float().contiguous()
    denom = (torch.ones((), dtype=torch.float32, device=w.device)
             if literal_eq1 else torch.clamp(w.sum(), min=1e-12))
    leaves = list(stacked_updates.values())
    aggs = wa_ops.weighted_agg_group(
        [leaf.reshape(leaf.shape[0], -1).float().contiguous()
         for leaf in leaves], w, denom)
    return {name: agg.reshape(tuple(leaf.shape[1:])).to(leaf.dtype)
            for name, leaf, agg in zip(stacked_updates, leaves, aggs)}


def participation_weights(scores_c: np.ndarray, model_id: int,
                          participating: np.ndarray,
                          active: np.ndarray) -> np.ndarray:
    """Per-device weight for aggregating model ``model_id`` this round:
    c_m_i for participating devices that hold m, else 0."""
    w = scores_c[:, model_id].copy()
    w[~participating] = 0.0
    w[~active[:, model_id]] = 0.0
    return w
