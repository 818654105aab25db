"""Wrapper for the eq-1 aggregation kernel (``csrc/weighted_agg.cu``,
which replaces ``repro/kernels/weighted_agg/kernel.py::
multi_weighted_agg_2d``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it computes the plain version (``ref.py``). There is no fallback
between the two. ``multi_weighted_agg.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.weighted_agg.ref import multi_weighted_agg_ref

# the kernel stages W (M, B) and the denominators in static-size dynamic
# shared memory; beyond this the launch would be refused
SMEM_LIMIT = 48 * 1024


@functools.lru_cache(maxsize=1)
def _kernel():
    lib = build.library("weighted_agg")
    fn = lib.fedcd_multi_weighted_agg
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


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
    devices = {t.device for t in (updates, weights, denoms)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def multi_weighted_agg(updates: torch.Tensor, weights: torch.Tensor,
                       denoms: torch.Tensor) -> torch.Tensor:
    """updates (B, D), weights (M, B), denoms (M,) -> (M, D) float32:
    ``weights @ updates / denoms[:, None]``, the per-model eq-1
    averages of one shared work batch. CUDA tensors must be contiguous
    float32."""
    _check(updates, weights, denoms)
    if updates.device.type == "cpu":
        return multi_weighted_agg_ref(updates, weights, denoms)
    if updates.device.type != "cuda":
        raise ValueError(f"unsupported device {updates.device}")
    for name, t in (("updates", updates), ("weights", weights),
                    ("denoms", denoms)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
    B, D = updates.shape
    M = weights.shape[0]
    if M * (B + 1) * 4 > SMEM_LIMIT:
        raise ValueError(f"M={M} x B={B} weights exceed the kernel's "
                         f"{SMEM_LIMIT} B of shared memory")
    out = torch.empty((M, D), dtype=torch.float32, device=updates.device)
    if M == 0 or D == 0:
        return out
    vec = (D % 4 == 0 and updates.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    lib, fn = _kernel()
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(updates.data_ptr(), weights.data_ptr(), denoms.data_ptr(),
                  out.data_ptr(), B, M, D, int(vec), stream)
    build.check_launch(lib, code, "multi_weighted_agg")
    multi_weighted_agg.launches += 1
    return out


multi_weighted_agg.launches = 0
