"""Transport/storage quantization, paper §3.4 (port of
``repro/core/quantize.py``).

Blockwise symmetric int8/int4 quantization: for each block of 128 values,
q = round(x / s), s = max|x| / qmax. Leaves are FLATTENED before blocking
(transport does not care about tensor layout, and per-row padding of
narrow matrices would blow the payload up), so the blocks follow each
leaf's memory order — which is why the port keeps the reference's param
layouts. Every leaf goes through ``kernels.quantize.ops``: the CUDA
kernels on CUDA tensors, their plain versions on CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.models.common import Params

BLOCK = 128


def quantize_leaf(x: torch.Tensor, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8 (1, n_pad), scales f32 (1, n_pad // 128))."""
    return q_ops.quantize(x.reshape(1, -1), bits)


def dequantize_leaf(q: torch.Tensor, scales: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return q_ops.dequantize(q, scales, n).reshape(shape).to(dtype)


def _roundtrip_rows(leaf: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-then-dequantize each row of ``leaf`` (R, ...) as its own
    flattened payload, all rows in one launch per kernel."""
    flat = leaf.reshape(leaf.shape[0], -1)
    q, s = q_ops.quantize(flat, bits)
    return q_ops.dequantize(q, s, flat.shape[1]).reshape(leaf.shape
                                                         ).to(leaf.dtype)


def roundtrip(tree: Params, bits: int = 8) -> Params:
    """Quantize-then-dequantize one model — what a device/server actually
    stores. ``bits <= 0`` returns ``tree`` itself."""
    if bits <= 0:
        return tree
    return {k: _roundtrip_rows(v.reshape(1, -1), bits).reshape(v.shape)
            for k, v in tree.items()}


def roundtrip_rows(stacked: Params, bits: int = 8) -> Params:
    """:func:`roundtrip` of every model of a stacked (A, ...) param dict —
    the reference's ``vmap(roundtrip)`` over the aggregated rows."""
    if bits <= 0:
        return stacked
    return {k: _roundtrip_rows(v, bits) for k, v in stacked.items()}


def compressed_bytes(tree: Params, bits: int = 8) -> int:
    """Transport cost of one model under quantization (paper §3.6)."""
    total = 0
    for leaf in tree.values():
        n = leaf.numel()
        padded = n + (-n) % BLOCK                       # flattened blocking
        total += padded * bits // 8                     # payload
        total += (padded // BLOCK) * 4                  # f32 scales
    return total
