"""Transport/storage quantization, paper §3.4 (port of
``repro/core/quantize.py``).

Blockwise symmetric int8/int4 quantization: for each block of 128 values,
q = round(x / s), s = max|x| / qmax. Leaves are FLATTENED before blocking
(transport does not care about tensor layout, and per-row padding of
narrow matrices would blow the payload up), so the blocks follow each
leaf's memory order — which is why the port keeps the reference's param
layouts. Every leaf goes through ``kernels.quantize.ops``: the CUDA
kernels on CUDA tensors, their plain versions on CPU tensors; a param
dict's leaves go through one grouped call of each.

``quantize_pytree`` / ``dequantize_pytree`` are the packed wire format
(codes, scales, shapes, dtypes, leaf names, bits); ``roundtrip`` /
``roundtrip_rows`` are what a device or the server stores after it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.models.common import Params, canonical

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


def quantize_pytree(tree: Params, bits: int = 8) -> Dict[str, Any]:
    """The packed payload of one model: per leaf, in the reference's leaf
    order (``names``, which stands in for its treedef), the int8 codes
    ``(1, n_pad)`` and float32 scales ``(1, n_pad // 128)`` of the whole
    leaf flattened into one row, and its shape and dtype. Every leaf goes
    through one ``quantize_group`` call (on the card, one launch per 32
    leaves)."""
    tree = canonical(tree)
    rows = [v.reshape(1, -1).float().contiguous() for v in tree.values()]
    qs, ss = q_ops.quantize_group(rows, bits)
    return {"q": qs, "scales": ss,
            "shapes": [tuple(v.shape) for v in tree.values()],
            "dtypes": [v.dtype for v in tree.values()],
            "names": list(tree), "bits": bits}


def dequantize_pytree(packed: Dict[str, Any]) -> Params:
    """:func:`quantize_pytree`'s payload back to a param dict (each leaf
    in its shape and dtype), through one ``dequantize_group`` call."""
    ns = [math.prod(shape) for shape in packed["shapes"]]
    outs = q_ops.dequantize_group(packed["q"], packed["scales"], ns)
    return {name: o.reshape(shape).to(dtype)
            for name, o, shape, dtype in zip(
                packed["names"], outs, packed["shapes"], packed["dtypes"])}


def roundtrip(tree: Params, bits: int = 8) -> Params:
    """Quantize-then-dequantize one model — what a device/server actually
    stores. ``bits <= 0`` returns ``tree`` itself."""
    if bits <= 0:
        return tree
    rows = roundtrip_rows({k: v.reshape(1, -1) for k, v in tree.items()},
                          bits)
    return {k: rows[k].reshape(v.shape) for k, v in tree.items()}


def roundtrip_rows(stacked: Params, bits: int = 8) -> Params:
    """:func:`roundtrip` of every model of a stacked (A, ...) param dict —
    the reference's ``vmap(roundtrip)`` over the aggregated rows. Each
    row of a leaf is its own flattened payload; every leaf goes through
    one ``quantize_group`` and one ``dequantize_group`` call (on the card,
    one launch of each kernel for up to 32 leaves)."""
    if bits <= 0:
        return stacked
    flat = [v.reshape(v.shape[0], math.prod(v.shape[1:])).float()
            .contiguous() for v in stacked.values()]
    qs, ss = q_ops.quantize_group(flat, bits)
    outs = q_ops.dequantize_group(qs, ss, [f.shape[1] for f in flat])
    return {k: o.reshape(v.shape).to(v.dtype)
            for (k, v), o in zip(stacked.items(), outs)}


def compressed_bytes(tree: Params, bits: int = 8) -> int:
    """Transport cost of one model under quantization (paper §3.6)."""
    total = 0
    for leaf in tree.values():
        n = leaf.numel()
        padded = n + (-n) % BLOCK                       # flattened blocking
        total += padded * bits // 8                     # payload
        total += (padded // BLOCK) * 4                  # f32 scales
    return total
