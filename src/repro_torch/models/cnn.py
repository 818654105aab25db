"""The paper's 10-layer CNN for CIFAR-shaped inputs (port of
``repro/models/cnn.py``, section 3.1).

8 conv layers (3x3, channels 32-32-64-64-128-128-256-256, maxpool every
2) + 2 dense layers. Params stay in the reference's layout — HWIO conv
kernels, ``(in, out)`` dense weights — because transport quantization
blocks each leaf in memory order (``core/quantize.py``): an OIHW bank
would put other values into each 128-value block. The activations stay
NHWC from input to flatten: the convolutions (each with its bias and
ReLU) and the max-pools are one call of ``kernels/conv3x3``, whose
kernels take NHWC and HWIO as they are, and which pools on
channels-last views; the flatten is a plain reshape, so ``fc1`` rows
keep their HWC meaning.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.conv3x3.ops import conv3x3_stack
from repro_torch.models.common import (Params, accuracy, normal_init,
                                       softmax_cross_entropy)

CHANNELS = (32, 32, 64, 64, 128, 128, 256, 256)
POOLS = tuple(i % 2 == 1 for i in range(len(CHANNELS)))  # maxpool every 2
DENSE = 256


def init_cnn(generator: torch.Generator, n_classes: int = 10,
             in_ch: int = 3, image: int = 32, dtype=torch.float32,
             device: Optional[torch.device] = None) -> Params:
    z = dict(dtype=dtype, device=device)
    p: Params = {}
    c_in = in_ch
    for i, c_out in enumerate(CHANNELS):
        p[f"conv.{i}"] = normal_init(generator, (3, 3, c_in, c_out), dtype,
                                     math.sqrt(2.0 / (9 * c_in)), device)
        c_in = c_out
    for i, c_out in enumerate(CHANNELS):
        p[f"conv_b.{i}"] = torch.zeros(c_out, **z)
    spatial = image // (2 ** (len(CHANNELS) // 2))
    flat = spatial * spatial * CHANNELS[-1]
    p["fc1"] = normal_init(generator, (flat, DENSE), dtype, 0.05, device)
    p["fc1_b"] = torch.zeros(DENSE, **z)
    p["fc2"] = normal_init(generator, (DENSE, n_classes), dtype, 0.05,
                           device)
    p["fc2_b"] = torch.zeros(n_classes, **z)
    return p


def apply_cnn(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, n_classes)."""
    n = len(CHANNELS)
    x = conv3x3_stack(x, [params[f"conv.{i}"] for i in range(n)],
                      [params[f"conv_b.{i}"] for i in range(n)], POOLS)
    x = x.reshape(x.shape[0], -1)                           # HWC flatten
    x = torch.relu(x @ params["fc1"] + params["fc1_b"])
    return x @ params["fc2"] + params["fc2_b"]


def cnn_loss(params: Params,
             batch: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    images, labels = batch
    return softmax_cross_entropy(apply_cnn(params, images), labels)


def cnn_accuracy(params: Params, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    return accuracy(apply_cnn(params, images), labels)
