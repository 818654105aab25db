"""Plain PyTorch version of blockwise symmetric quantization (port of
``repro/kernels/quantize/ref.py``).

Layout contract (shared with the CUDA kernel):
  input  x        (R, D)  — callers reshape to 2D; D padded to ``block``
  output q        (R, D_pad) int8
  output scales   (R, D_pad // block) float32
  q = clip(round(x / s), -qmax, qmax),  s = max(max|x_block| / qmax, 1e-12)
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 128


def qmax_of(bits: int) -> int:
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    return (1 << (bits - 1)) - 1


def to_2d(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    shape = tuple(x.shape)
    if x.dim() == 0:
        return x.reshape(1, 1), shape
    if x.dim() == 1:
        return x.reshape(1, -1), shape
    return x.reshape(-1, shape[-1]), shape


def quantize_ref(x: torch.Tensor, bits: int = 8, block: int = BLOCK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    x2, _ = to_2d(x)
    R, D = x2.shape
    x2 = F.pad(x2.float(), (0, (-D) % block))
    nb = x2.shape[1] // block
    xb = x2.reshape(R, nb, block)
    qmax = qmax_of(bits)
    amax = torch.amax(torch.abs(xb), dim=2)                       # (R, nb)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not IEEE division
    s = torch.clamp(amax / torch.full_like(amax, qmax), min=1e-12)
    q = torch.clamp(torch.round(xb / s[..., None]), -qmax, qmax)
    return q.reshape(R, nb * block).to(torch.int8), s.float()


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor, shape, dtype,
                   block: int = BLOCK) -> torch.Tensor:
    R, Dp = q.shape
    nb = Dp // block
    x = q.float().reshape(R, nb, block) * scales[..., None]
    x = x.reshape(R, Dp)
    d_last = shape[-1] if len(shape) else 1
    x = x[:, :d_last] if len(shape) else x[0, :1]
    return x.reshape(shape).to(dtype)
