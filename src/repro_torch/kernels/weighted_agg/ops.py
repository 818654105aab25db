"""Wrappers for the eq-1 aggregation kernels (``csrc/weighted_agg.cu``,
which replaces ``repro/kernels/weighted_agg/kernel.py::
multi_weighted_agg_2d``, ``::weighted_agg_2d`` and ``::dequant_agg_2d``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version (``ref.py``). There is no fallback
between the two. The three eq-1 forms share one kernel body and take a
group of leaves (``multi_weighted_agg_group``, ``weighted_agg_group``,
``dequant_agg_group``): one launch covers every leaf of a param dict.
The per-leaf ``multi_weighted_agg``, ``weighted_agg`` and
``dequant_agg`` are groups of one. ``multi_weighted_agg.launches``,
``weighted_agg.launches`` and ``dequant_agg.launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build, group
from repro_torch.kernels.weighted_agg.ref import (dequant_agg_ref,
                                                  multi_weighted_agg_ref,
                                                  weighted_agg_ref)

# the kernel stages its weights (and denominators) in dynamic shared
# memory; this much is taken, more is refused here. (It adds 4-32 KB of
# partial sums; its launcher lifts the block's limit past the default
# 48 KB where the sum needs it.)
SMEM_LIMIT = 48 * 1024


@functools.lru_cache(maxsize=1)
def _kernels():
    lib = build.library("weighted_agg")
    vp, i = ctypes.c_void_p, ctypes.c_int
    eq1 = lib.fedcd_eq1_agg
    eq1.argtypes = [vp, vp, vp, i, vp, vp, i, i, vp]
    deq = lib.fedcd_dequant_agg_group
    deq.argtypes = [vp] * 4 + [i, vp, vp, i, i, vp]
    for fn in (eq1, deq):
        fn.restype = ctypes.c_int
    lib.fedcd_eq1_max_leaves.argtypes = []
    lib.fedcd_eq1_max_leaves.restype = ctypes.c_int
    return lib, eq1, deq, lib.fedcd_eq1_max_leaves()


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


def _check_leaves(updates: Sequence[torch.Tensor], B: int) -> None:
    for i, u in enumerate(updates):
        if u.dim() != 2 or u.shape[0] != B:
            raise ValueError(f"leaf {i}: expected updates ({B}, D), got "
                             f"{tuple(u.shape)}")
        _require(u, f"leaf {i}", torch.float32)


def _eq1_launch(updates: Sequence[torch.Tensor], weights: torch.Tensor,
                denoms: torch.Tensor, M: int, squeeze: bool
                ) -> Tuple[List[torch.Tensor], int]:
    """Eq 1 over every leaf on the card, one launch per ``max_leaves``
    non-empty leaves. The results are views of one buffer, laid out leaf
    by leaf, each leaf starting 16-byte aligned (the quantize kernel's
    float4 path reads them): (M, D_i), or (D_i,) when ``squeeze``.
    Returns them and the number of launches."""
    sizes = [u.shape[1] for u in updates]
    outs, out_ptrs = group.views([(d,) if squeeze else (M, d)
                                  for d in sizes], torch.float32,
                                 weights.device)
    lib, fn, _, cap = _kernels()
    vp = ctypes.c_void_p
    launches = group.launch(
        fn, [(vp, [u.data_ptr() for u in updates]), (vp, out_ptrs),
             (ctypes.c_longlong, sizes)],
        group.launch_groups([M * d for d in sizes], cap),
        [weights.data_ptr(), denoms.data_ptr(), weights.shape[-1], M],
        weights.device,
        lambda code: build.check_launch(lib, code, "eq-1 aggregation"))
    return outs, launches


def multi_weighted_agg_group(updates: Sequence[torch.Tensor],
                             weights: torch.Tensor, denoms: torch.Tensor
                             ) -> List[torch.Tensor]:
    """updates: leaves (B, D_i), weights (M, B), denoms (M,) -> one
    (M, D_i) float32 result per leaf, ``weights @ updates[i] /
    denoms[:, None]``: the per-model eq-1 averages of one shared work
    batch over every leaf of a param dict. Every tensor must be
    contiguous float32 and on one device. On the card the leaves go
    through one launch (per ``max_leaves`` leaves), each adding 1 to
    ``multi_weighted_agg.launches``."""
    if weights.dim() != 2 or denoms.dim() != 1:
        raise ValueError("expected weights (M, B), denoms (M,); got "
                         f"{tuple(weights.shape)}, {tuple(denoms.shape)}")
    M, B = weights.shape
    if denoms.shape[0] != M:
        raise ValueError(f"shape mismatch: weights {tuple(weights.shape)}, "
                         f"denoms {tuple(denoms.shape)}")
    _check_leaves(updates, B)
    for name, t in (("weights", weights), ("denoms", denoms)):
        _require(t, name, torch.float32)
    if _same_device(weights, denoms, *updates).type == "cpu":
        return [multi_weighted_agg_ref(u, weights, denoms) for u in updates]
    _check_smem(M * (B + 1))
    outs, launches = _eq1_launch(updates, weights, denoms, M, squeeze=False)
    multi_weighted_agg.launches += launches
    return outs


def multi_weighted_agg(updates: torch.Tensor, weights: torch.Tensor,
                       denoms: torch.Tensor) -> torch.Tensor:
    """updates (B, D), weights (M, B), denoms (M,) -> (M, D) float32:
    :func:`multi_weighted_agg_group` over one leaf."""
    return multi_weighted_agg_group([updates], weights, denoms)[0]


def weighted_agg_group(updates: Sequence[torch.Tensor],
                       weights: torch.Tensor, denom: torch.Tensor
                       ) -> List[torch.Tensor]:
    """updates: leaves (N, D_i), weights (N,), denom 0-d -> one (D_i,)
    float32 result per leaf, ``Σ_n w_n · updates[i][n] / denom``: the
    single-model eq-1 average over every leaf of a param dict. Every
    tensor must be contiguous float32 and on one device; ``denom`` stays
    on the device (reading it on the host would synchronize). On the
    card the leaves go through one launch (per ``max_leaves`` leaves),
    each adding 1 to ``weighted_agg.launches``."""
    if weights.dim() != 1 or denom.dim() != 0:
        raise ValueError("expected weights (N,), a 0-d denom; got "
                         f"{tuple(weights.shape)}, {tuple(denom.shape)}")
    _check_leaves(updates, weights.shape[0])
    for name, t in (("weights", weights), ("denom", denom)):
        _require(t, name, torch.float32)
    if _same_device(weights, denom, *updates).type == "cpu":
        return [weighted_agg_ref(u, weights, denom) for u in updates]
    _check_smem(weights.shape[0] + 1)           # M = 1, B = N
    outs, launches = _eq1_launch(updates, weights, denom, 1, squeeze=True)
    weighted_agg.launches += launches
    return outs


def weighted_agg(updates: torch.Tensor, weights: torch.Tensor,
                 denom: torch.Tensor) -> torch.Tensor:
    """updates (N, D), weights (N,), denom 0-d -> (D,) float32:
    :func:`weighted_agg_group` over one leaf."""
    return weighted_agg_group([updates], weights, denom)[0]


def dequant_agg_group(qs: Sequence[torch.Tensor],
                      scales: Sequence[torch.Tensor], weights: torch.Tensor,
                      denom: torch.Tensor, block: int = 128
                      ) -> List[torch.Tensor]:
    """qs: leaves of int8 codes (N, D_i) with D_i % block == 0, scales:
    their float32 block scales (N, D_i // block), weights (N,), denom 0-d
    -> one (D_i,) float32 result per leaf, ``Σ_n w_n · (qs[i][n] ·
    s_i[n, d // block]) / denom``: the eq-1 average of the dequantized
    rows. Codes int8, the rest float32, every tensor contiguous and on one
    device. On the card the leaves go through one launch (per
    ``max_leaves`` non-empty leaves), each adding 1 to
    ``dequant_agg.launches``; the results are views of one buffer."""
    if weights.dim() != 1 or denom.dim() != 0:
        raise ValueError("expected weights (N,), a 0-d denom; got "
                         f"{tuple(weights.shape)}, {tuple(denom.shape)}")
    if len(qs) != len(scales):
        raise ValueError(f"{len(qs)} codes and {len(scales)} scales")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    N = weights.shape[0]
    for i, (q, s) in enumerate(zip(qs, scales)):
        if q.dim() != 2 or q.shape[0] != N:
            raise ValueError(f"leaf {i}: expected codes ({N}, D), got "
                             f"{tuple(q.shape)}")
        D = q.shape[1]
        if D % block:
            raise ValueError(f"leaf {i}: D={D} is not a multiple of "
                             f"block={block}")
        if tuple(s.shape) != (N, D // block):
            raise ValueError(f"leaf {i}: scales {tuple(s.shape)} must be "
                             f"{(N, D // block)} for codes {tuple(q.shape)}")
        _require(q, f"leaf {i} codes", torch.int8)
        _require(s, f"leaf {i} scales", torch.float32)
    for name, t in (("weights", weights), ("denom", denom)):
        _require(t, name, torch.float32)
    if _same_device(weights, denom, *qs, *scales).type == "cpu":
        return [dequant_agg_ref(q, s, weights, denom, block)
                for q, s in zip(qs, scales)]
    _check_smem(N + 1)                           # M = 1, B = N
    sizes = [q.shape[1] for q in qs]
    outs, out_ptrs = group.views([(d,) for d in sizes], torch.float32,
                                 weights.device)
    lib, _, fn, cap = _kernels()
    vp = ctypes.c_void_p
    dequant_agg.launches += group.launch(
        fn, [(vp, [q.data_ptr() for q in qs]),
             (vp, [s.data_ptr() for s in scales]), (vp, out_ptrs),
             (ctypes.c_longlong, sizes)],
        group.launch_groups(sizes, cap),
        [weights.data_ptr(), denom.data_ptr(), N, block], weights.device,
        lambda code: build.check_launch(lib, code, "dequant_agg"))
    return outs


def dequant_agg(q: torch.Tensor, scales: torch.Tensor,
                weights: torch.Tensor, denom: torch.Tensor,
                block: int = 128) -> torch.Tensor:
    """q int8 (N, D) with D % block == 0, scales (N, D // block),
    weights (N,), denom 0-d -> (D,) float32: :func:`dequant_agg_group`
    over one leaf."""
    return dequant_agg_group([q], [scales], weights, denom, block)[0]


multi_weighted_agg.launches = 0
weighted_agg.launches = 0
dequant_agg.launches = 0
