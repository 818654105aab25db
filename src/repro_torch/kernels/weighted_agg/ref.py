"""Plain PyTorch versions of the eq-1 aggregation kernels (port of
``repro/kernels/weighted_agg/ref.py``).

updates (N, D) f32, weights (N,), denom 0-d ->
    out (D,) = sum_n w_n * u_n / denom                 (weighted_agg_ref)
updates (B, D) f32, weights (M, B), denoms (M,) ->
    out (M, D) = weights @ updates / denoms[:, None]   (multi_weighted_agg_ref)
q (N, D) int8, scales (N, D // block), weights (N,), denom ->
    out (D,) = sum_n w_n * (q_n * s_n[d // block]) / denom   (dequant_agg_ref)
All accumulate in float32.
"""
from __future__ import annotations

import torch


def weighted_agg_ref(updates: torch.Tensor, weights: torch.Tensor,
                     denom: torch.Tensor) -> torch.Tensor:
    """Rows with weight 0 are still multiplied, as in the reference: a
    non-finite row poisons the aggregate."""
    acc = torch.einsum("nd,n->d", updates.float(), weights.float())
    return acc / denom.float()


def multi_weighted_agg_ref(updates: torch.Tensor, weights: torch.Tensor,
                           denoms: torch.Tensor) -> torch.Tensor:
    """Row m of ``weights`` holds the pair weights of model m (0 where a
    pair belongs to another model or is padding)."""
    acc = weights.float() @ updates.float()
    return acc / denoms.float()[:, None]


def dequant_agg_ref(q: torch.Tensor, scales: torch.Tensor,
                    weights: torch.Tensor, denom: torch.Tensor,
                    block: int = 128) -> torch.Tensor:
    """Dequantize each ``block`` of a row with its scale, then
    :func:`weighted_agg_ref`. D must be a multiple of ``block``."""
    N, D = q.shape
    x = q.float().reshape(N, D // block, block) * scales.float()[..., None]
    return weighted_agg_ref(x.reshape(N, D), weights, denom)
