"""Small MLP classifier (port of ``repro/models/mlp.py``) — the fast
stand-in for the paper's CNN. Weights keep the reference's ``(in, out)``
layout."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.common import (Params, accuracy, normal_init,
                                       softmax_cross_entropy)


def init_mlp_classifier(generator: torch.Generator,
                        in_dim: int = 32 * 32 * 3, hidden: int = 128,
                        n_classes: int = 10, dtype=torch.float32,
                        device: Optional[torch.device] = None) -> Params:
    z = dict(dtype=dtype, device=device)
    w1 = normal_init(generator, (in_dim, hidden), dtype, 0.03, device)
    w2 = normal_init(generator, (hidden, n_classes), dtype, 0.03, device)
    return {"b1": torch.zeros(hidden, **z), "b2": torch.zeros(n_classes, **z),
            "w1": w1, "w2": w2}


def apply_mlp_classifier(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params: Params,
             batch: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    x, y = batch
    return softmax_cross_entropy(apply_mlp_classifier(params, x), y)


def mlp_accuracy(params: Params, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    return accuracy(apply_mlp_classifier(params, x), y)
