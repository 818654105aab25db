"""Wrappers for the transport quantization kernels (``csrc/quantize.cu``,
which replaces ``repro/kernels/quantize/kernel.py::quantize_2d`` and
``::dequantize_2d``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version (``ref.py``). There is no fallback
between the two. Both kernels take a group of leaves
(``quantize_group``, ``dequantize_group``): one launch covers every leaf
of a param dict. The per-leaf ``quantize`` and ``dequantize`` are groups
of one. ``quantize.launches`` / ``dequantize.launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build, group
from repro_torch.kernels.quantize.ref import (BLOCK, dequantize_ref,
                                              qmax_of, quantize_ref)


@functools.lru_cache(maxsize=1)
def _kernels():
    lib = build.library("quantize")
    vp, i = ctypes.c_void_p, ctypes.c_int
    q = lib.fedcd_quantize_group
    q.argtypes = [vp] * 5 + [i, ctypes.c_float, vp]
    dq = lib.fedcd_dequantize_group
    dq.argtypes = [vp] * 5 + [i, vp]
    for fn in (q, dq):
        fn.restype = ctypes.c_int
    lib.fedcd_quantize_max_leaves.argtypes = []
    lib.fedcd_quantize_max_leaves.restype = ctypes.c_int
    return lib, {"quantize": q, "dequantize": dq}, \
        lib.fedcd_quantize_max_leaves()


def max_leaves() -> int:
    """The most leaves one launch takes (the kernels' leaf table); builds
    the kernels on first use."""
    return _kernels()[2]


def _require(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


def _same_device(tensors: Sequence[torch.Tensor]) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _launch(name: str, pointers: Sequence[List[int]], rows: List[int],
            ns: List[int], args: list, device: torch.device) -> int:
    """Launch kernel ``name`` over the leaves (the leaves' data pointers,
    one list per tensor argument in the launcher's order; their rows and
    row lengths), one launch per ``max_leaves`` non-empty leaves. Returns
    the number of launches."""
    lib, fns, cap = _kernels()
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    columns = [(vp, p) for p in pointers] + [(ll, rows), (ll, ns)]
    sizes = [r * n for r, n in zip(rows, ns)]
    return group.launch(fns[name], columns, group.launch_groups(sizes, cap),
                        args, device,
                        lambda code: build.check_launch(lib, code, name))


def _quantize_plain(x: torch.Tensor, bits: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.shape[1] == 0:     # the plain version cannot reshape (R, 0)
        return (torch.empty((x.shape[0], 0), dtype=torch.int8),
                torch.empty((x.shape[0], 0)))
    return quantize_ref(x, bits)


def quantize_group(xs: Sequence[torch.Tensor], bits: int = 8
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """xs: leaves (R_i, n_i) -> (codes int8 (R_i, n_pad_i), scales float32
    (R_i, n_pad_i // 128)) per leaf, each row blocked on its own, the
    ragged tail quantized as zeros. Every leaf must be contiguous float32
    and on one device. On the card the leaves go through one launch (per
    ``max_leaves`` non-empty leaves), each adding 1 to
    ``quantize.launches``; codes and scales are views of one buffer each."""
    qmax = qmax_of(bits)
    for i, x in enumerate(xs):
        if x.dim() != 2:
            raise ValueError(f"leaf {i}: expected (R, n), got "
                             f"{tuple(x.shape)}")
        _require(x, f"leaf {i}", torch.float32)
    if not xs:
        return [], []
    device = _same_device(xs)
    if device.type == "cpu":
        out = [_quantize_plain(x, bits) for x in xs]
        return [q for q, _ in out], [s for _, s in out]
    rows = [x.shape[0] for x in xs]
    ns = [x.shape[1] for x in xs]
    nbs = [-(-n // BLOCK) for n in ns]
    qs, q_ptrs = group.views([(r, nb * BLOCK) for r, nb in zip(rows, nbs)],
                             torch.int8, device)
    ss, s_ptrs = group.views(list(zip(rows, nbs)), torch.float32, device)
    quantize.launches += _launch(
        "quantize", ([x.data_ptr() for x in xs], q_ptrs, s_ptrs), rows, ns,
        [float(qmax)], device)
    return qs, ss


def dequantize_group(qs: Sequence[torch.Tensor],
                     scales: Sequence[torch.Tensor], ns: Sequence[int]
                     ) -> List[torch.Tensor]:
    """qs: codes int8 (R_i, n_pad_i), scales float32 (R_i, n_pad_i // 128)
    and row lengths ns -> float32 (R_i, n_i) per leaf, ``q * s[block]``
    cropped to the first n_i columns; n_pad_i must be 128 * ceil(n_i /
    128), the width :func:`quantize_group` gives. Every tensor must be
    contiguous and on one device. On the card the leaves go through one
    launch (per ``max_leaves`` non-empty leaves), each adding 1 to
    ``dequantize.launches``; the results are views of one buffer."""
    if not len(qs) == len(scales) == len(ns):
        raise ValueError(f"{len(qs)} codes, {len(scales)} scales and "
                         f"{len(ns)} lengths")
    for i, (q, s, n) in enumerate(zip(qs, scales, ns)):
        if q.dim() != 2 or s.dim() != 2:
            raise ValueError(f"leaf {i}: expected q (R, n_pad), scales "
                             f"(R, nb); got {tuple(q.shape)}, "
                             f"{tuple(s.shape)}")
        R, n_pad = q.shape
        # rows n_pad = 128 * ceil(n / 128) long, as quantize_group makes
        # them: the kernel takes each row's stride from n
        if (n < 0 or n_pad != -(-n // BLOCK) * BLOCK
                or s.shape != (R, n_pad // BLOCK)):
            raise ValueError(f"leaf {i}: shape mismatch: q {tuple(q.shape)},"
                             f" scales {tuple(s.shape)}, n={n}")
        _require(q, f"leaf {i} codes", torch.int8)
        _require(s, f"leaf {i} scales", torch.float32)
    if not qs:
        return []
    device = _same_device([*qs, *scales])
    if device.type == "cpu":
        return [dequantize_ref(q, s, (q.shape[0], n), torch.float32)
                for q, s, n in zip(qs, scales, ns)]
    q_ptrs = [q.data_ptr() for q in qs]
    if any(p % 4 for p in q_ptrs):
        raise ValueError("codes must be 4-byte aligned")
    rows, ns = [q.shape[0] for q in qs], [int(n) for n in ns]
    outs, out_ptrs = group.views(list(zip(rows, ns)), torch.float32, device)
    dequantize.launches += _launch(
        "dequantize", (q_ptrs, [s.data_ptr() for s in scales], out_ptrs),
        rows, ns, [], device)
    return outs


def quantize(x: torch.Tensor, bits: int = 8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, n) -> (q int8 (R, n_pad), scales float32 (R, n_pad // 128)):
    :func:`quantize_group` over one leaf. A floating-point x is read as
    float32, as the reference does."""
    if x.dim() != 2:
        raise ValueError(f"expected x (R, n), got {tuple(x.shape)}")
    if not x.is_floating_point():
        raise ValueError(f"x must be floating point, got {x.dtype}")
    qs, ss = quantize_group([x.float().contiguous()], bits)
    return qs[0], ss[0]


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: int
               ) -> torch.Tensor:
    """q int8 (R, n_pad), scales (R, n_pad // 128) -> float32 (R, n):
    :func:`dequantize_group` over one leaf."""
    return dequantize_group([q], [scales], [n])[0]


quantize.launches = 0
dequantize.launches = 0
