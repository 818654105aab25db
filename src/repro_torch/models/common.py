"""Shared model pieces (port of the parts of ``repro/models/common.py``
the mode-A learners use).

Params are flat ``{name: tensor}`` dicts whose keys follow the
reference's pytree leaf order (``conv.3`` is ``params["conv"][3]``
there), so that ``convert.params_from_jax`` maps leaf to leaf.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def normal_init(generator: torch.Generator, shape, dtype=torch.float32,
                stddev: float = 0.02,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """N(0, stddev²) draws from ``generator`` (a CPU generator, so a seed
    gives the same params on every device). Not the reference's
    ``jax.random`` bits: parity tests load the reference's params."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32) * stddev
    return x.to(device=device, dtype=dtype)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch. logits (B, V) float; labels (B,) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - gold)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Float32 share of argmax hits (ties go to the first index, as
    ``jnp.argmax``)."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())
