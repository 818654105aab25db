"""Wrappers for the eq-1 aggregation kernels (``csrc/weighted_agg.cu``,
which replaces ``repro/kernels/weighted_agg/kernel.py::
multi_weighted_agg_2d``, ``::weighted_agg_2d`` and ``::dequant_agg_2d``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version (``ref.py``). There is no fallback
between the two. ``multi_weighted_agg.launches``,
``weighted_agg.launches`` and ``dequant_agg.launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.weighted_agg.ref import (dequant_agg_ref,
                                                  multi_weighted_agg_ref,
                                                  weighted_agg_ref)

# the kernels stage their weights (and denominators) in dynamic shared
# memory below the default per-block limit; beyond it a launch is refused
SMEM_LIMIT = 48 * 1024


@functools.lru_cache(maxsize=1)
def _kernels():
    lib = build.library("weighted_agg")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    multi = lib.fedcd_multi_weighted_agg
    multi.argtypes = [vp] * 4 + [i, i, ll, i, vp]
    single = lib.fedcd_weighted_agg
    single.argtypes = [vp] * 4 + [i, ll, i, vp]
    deq = lib.fedcd_dequant_agg
    deq.argtypes = [vp] * 5 + [i, ll, i, i, vp]
    for fn in (multi, single, deq):
        fn.restype = ctypes.c_int
    return lib, multi, single, deq


def _require(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}, got "
                         f"{t.dtype} contiguous={t.is_contiguous()}")


def _same_device(*tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _check_smem(n_weights: int) -> None:
    if n_weights * 4 > SMEM_LIMIT:
        raise ValueError(f"{n_weights} weights exceed the kernel's "
                         f"{SMEM_LIMIT} B of shared memory")


def _check(updates: torch.Tensor, weights: torch.Tensor,
           denoms: torch.Tensor) -> None:
    if updates.dim() != 2 or weights.dim() != 2 or denoms.dim() != 1:
        raise ValueError("expected updates (B, D), weights (M, B), "
                         f"denoms (M,); got {tuple(updates.shape)}, "
                         f"{tuple(weights.shape)}, {tuple(denoms.shape)}")
    B = updates.shape[0]
    M = weights.shape[0]
    if weights.shape[1] != B or denoms.shape[0] != M:
        raise ValueError(f"shape mismatch: updates {tuple(updates.shape)}, "
                         f"weights {tuple(weights.shape)}, "
                         f"denoms {tuple(denoms.shape)}")


def multi_weighted_agg(updates: torch.Tensor, weights: torch.Tensor,
                       denoms: torch.Tensor) -> torch.Tensor:
    """updates (B, D), weights (M, B), denoms (M,) -> (M, D) float32:
    ``weights @ updates / denoms[:, None]``, the per-model eq-1
    averages of one shared work batch. CUDA tensors must be contiguous
    float32."""
    _check(updates, weights, denoms)
    if _same_device(updates, weights, denoms).type == "cpu":
        return multi_weighted_agg_ref(updates, weights, denoms)
    for name, t in (("updates", updates), ("weights", weights),
                    ("denoms", denoms)):
        _require(t, name, torch.float32)
    B, D = updates.shape
    M = weights.shape[0]
    _check_smem(M * (B + 1))
    out = torch.empty((M, D), dtype=torch.float32, device=updates.device)
    if M == 0 or D == 0:
        return out
    vec = (D % 4 == 0 and updates.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    lib, fn, _, _ = _kernels()
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(updates.data_ptr(), weights.data_ptr(), denoms.data_ptr(),
                  out.data_ptr(), B, M, D, int(vec), stream)
    build.check_launch(lib, code, "multi_weighted_agg")
    multi_weighted_agg.launches += 1
    return out


def _check_single(updates: torch.Tensor, weights: torch.Tensor,
                  denom: torch.Tensor) -> None:
    if updates.dim() != 2 or weights.dim() != 1 or denom.dim() != 0:
        raise ValueError("expected updates (N, D), weights (N,), a 0-d "
                         f"denom; got {tuple(updates.shape)}, "
                         f"{tuple(weights.shape)}, {tuple(denom.shape)}")
    if weights.shape[0] != updates.shape[0]:
        raise ValueError(f"shape mismatch: updates {tuple(updates.shape)}, "
                         f"weights {tuple(weights.shape)}")


def weighted_agg(updates: torch.Tensor, weights: torch.Tensor,
                 denom: torch.Tensor) -> torch.Tensor:
    """updates (N, D), weights (N,), denom 0-d -> (D,) float32:
    ``Σ_n w_n · updates[n] / denom``, the single-model eq-1 average.
    CUDA tensors must be contiguous float32; ``denom`` stays on the
    device (reading it on the host would synchronize once per leaf)."""
    _check_single(updates, weights, denom)
    if _same_device(updates, weights, denom).type == "cpu":
        return weighted_agg_ref(updates, weights, denom)
    for name, t in (("updates", updates), ("weights", weights),
                    ("denom", denom)):
        _require(t, name, torch.float32)
    N, D = updates.shape
    _check_smem(N)
    out = torch.empty((D,), dtype=torch.float32, device=updates.device)
    if D == 0:
        return out
    vec = (D % 4 == 0 and updates.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    lib, _, fn, _ = _kernels()
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(updates.data_ptr(), weights.data_ptr(), denom.data_ptr(),
                  out.data_ptr(), N, D, int(vec), stream)
    build.check_launch(lib, code, "weighted_agg")
    weighted_agg.launches += 1
    return out


def dequant_agg(q: torch.Tensor, scales: torch.Tensor,
                weights: torch.Tensor, denom: torch.Tensor,
                block: int = 128) -> torch.Tensor:
    """q int8 (N, D) with D % block == 0, scales (N, D // block),
    weights (N,), denom 0-d -> (D,) float32: the eq-1 average of the
    dequantized rows, ``Σ_n w_n · (q[n] · s[n, d // block]) / denom``.
    CUDA tensors must be contiguous (q int8, the rest float32)."""
    _check_single(q, weights, denom)
    N, D = q.shape
    if block < 1 or D % block:
        raise ValueError(f"D={D} is not a multiple of block={block}")
    if tuple(scales.shape) != (N, D // block):
        raise ValueError(f"scales {tuple(scales.shape)} must be "
                         f"{(N, D // block)} for q {tuple(q.shape)}")
    if _same_device(q, scales, weights, denom).type == "cpu":
        return dequant_agg_ref(q, scales, weights, denom, block)
    _require(q, "q", torch.int8)
    for name, t in (("scales", scales), ("weights", weights),
                    ("denom", denom)):
        _require(t, name, torch.float32)
    _check_smem(N)
    out = torch.empty((D,), dtype=torch.float32, device=q.device)
    if D == 0:
        return out
    vec = (D % 4 == 0 and block % 4 == 0 and q.data_ptr() % 4 == 0
           and out.data_ptr() % 16 == 0)
    lib, _, _, fn = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), scales.data_ptr(), weights.data_ptr(),
                  denom.data_ptr(), out.data_ptr(), N, D, block, int(vec),
                  stream)
    build.check_launch(lib, code, "dequant_agg")
    dequant_agg.launches += 1
    return out


multi_weighted_agg.launches = 0
weighted_agg.launches = 0
dequant_agg.launches = 0
