"""Plain PyTorch version of the eq-1 aggregation kernel (port of
``repro/kernels/weighted_agg/ref.py``, multi-model form).

updates (B, D), weights (M, B), denoms (M,) ->
    out (M, D) = weights @ updates / denoms[:, None]   (float32)
"""
from __future__ import annotations

import torch


def multi_weighted_agg_ref(updates: torch.Tensor, weights: torch.Tensor,
                           denoms: torch.Tensor) -> torch.Tensor:
    """Row m of ``weights`` holds the pair weights of model m (0 where a
    pair belongs to another model or is padding)."""
    acc = weights.float() @ updates.float()
    return acc / denoms.float()[:, None]
