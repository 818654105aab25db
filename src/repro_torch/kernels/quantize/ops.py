"""Wrappers for the transport quantization kernels (``csrc/quantize.cu``,
which replaces ``repro/kernels/quantize/kernel.py::quantize_2d`` and
``::dequantize_2d``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version (``ref.py``). There is no fallback
between the two. ``quantize.launches`` / ``dequantize.launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quantize.ref import (BLOCK, dequantize_ref,
                                              qmax_of, quantize_ref)


@functools.lru_cache(maxsize=1)
def _kernels():
    lib = build.library("quantize")
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    q = lib.fedcd_quantize
    q.argtypes = [vp, vp, vp, ll, ll, ctypes.c_float, ctypes.c_int, vp]
    q.restype = ctypes.c_int
    dq = lib.fedcd_dequantize
    dq.argtypes = [vp, vp, vp, ll, ll, ctypes.c_int, vp]
    dq.restype = ctypes.c_int
    return lib, q, dq


def _require(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


def quantize(x: torch.Tensor, bits: int = 8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, n) -> (q int8 (R, n_pad), scales float32 (R, n_pad // 128)),
    each row blocked on its own, the ragged tail quantized as zeros.
    A floating-point x is read as float32, as the reference does."""
    if x.dim() != 2:
        raise ValueError(f"expected x (R, n), got {tuple(x.shape)}")
    qmax = qmax_of(bits)
    if x.device.type == "cpu":
        return quantize_ref(x, bits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_floating_point():
        raise ValueError(f"x must be floating point, got {x.dtype}")
    x = x.float().contiguous()
    R, n = x.shape
    nb = -(-n // BLOCK)
    q = torch.empty((R, nb * BLOCK), dtype=torch.int8, device=x.device)
    scales = torch.empty((R, nb), dtype=torch.float32, device=x.device)
    if R == 0 or n == 0:
        return q, scales
    vec = n % 4 == 0 and x.data_ptr() % 16 == 0
    lib, fn, _ = _kernels()
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), R, n,
                  float(qmax), int(vec),
                  torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, code, "quantize")
    quantize.launches += 1
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: int
               ) -> torch.Tensor:
    """q int8 (R, n_pad), scales (R, n_pad // 128) -> float32 (R, n):
    ``q * scales[block]``, cropped to the first ``n`` columns."""
    if q.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"expected q (R, n_pad), scales (R, nb); got "
                         f"{tuple(q.shape)}, {tuple(scales.shape)}")
    R, n_pad = q.shape
    if (n_pad % BLOCK or scales.shape != (R, n_pad // BLOCK)
            or not 0 <= n <= n_pad):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, scales "
                         f"{tuple(scales.shape)}, n={n}")
    if q.device != scales.device:
        raise ValueError(f"q on {q.device}, scales on {scales.device}")
    if q.device.type == "cpu":
        return dequantize_ref(q, scales, (R, n), torch.float32)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _require(q, "q", torch.int8)
    _require(scales, "scales", torch.float32)
    if q.data_ptr() % 4:
        raise ValueError("q must be 4-byte aligned")
    out = torch.empty((R, n), dtype=torch.float32, device=q.device)
    if R == 0 or n == 0:
        return out
    vec = n % 4 == 0 and out.data_ptr() % 16 == 0
    lib, _, fn = _kernels()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), R, n,
                  int(vec), torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, code, "dequantize")
    dequantize.launches += 1
    return out


quantize.launches = 0
dequantize.launches = 0
