"""Score-weighted federated aggregation, paper eq 1 (port of
``repro/core/aggregate.py``).

``w_m = Σ_i w_m_i · c_m_i / Σ_i c_m_i`` over the devices contributing to
model m. Every leaf goes through ``kernels.weighted_agg.ops``: on CUDA
tensors that is the hand-written kernel (the reference keeps its Pallas
kernel behind ``use_kernel=True``; here the kernel is the path), on CPU
tensors its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.weighted_agg import ops as wa_ops
from repro_torch.models.common import Params


def multi_weighted_average(stacked_updates: Params,
                           weights: torch.Tensor) -> Params:
    """Aggregate every model that trained from one shared work batch.

    stacked_updates: param dict with leading pair axis B; weights (M, B)
    with row m carrying c_m_i for pairs that belong to model m and 0
    elsewhere (padding pairs are all-zero columns). Returns a param dict
    with leading model axis M."""
    w = weights.float().contiguous()
    denoms = torch.clamp(w.sum(dim=1), min=1e-12)
    out: Params = {}
    for name, leaf in stacked_updates.items():
        B = leaf.shape[0]
        flat = leaf.reshape(B, -1).float().contiguous()
        agg = wa_ops.multi_weighted_agg(flat, w, denoms)
        out[name] = agg.reshape((w.shape[0],) + tuple(leaf.shape[1:])
                                ).to(leaf.dtype)
    return out


def weighted_average(stacked_updates: Params, weights: torch.Tensor) -> Params:
    """stacked_updates: param dict with leading device axis N; weights
    (N,). Devices with weight 0 contribute nothing. The one-model case of
    :func:`multi_weighted_average`."""
    multi = multi_weighted_average(stacked_updates, weights.reshape(1, -1))
    return {name: leaf[0] for name, leaf in multi.items()}
