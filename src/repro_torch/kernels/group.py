"""Leaf groups: how a grouped kernel call lays out its outputs and splits
its leaves into launches. Plain Python, so the CPU tests reach it.

A grouped wrapper writes each kind of output of a call into one buffer,
leaf after leaf, each leaf's segment starting 16-byte aligned (so a leaf
that allows it takes the kernels' 16-byte loads and stores), and launches
its kernel once per ``cap`` non-empty leaves, ``cap`` being the size of
the kernel's leaf table.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

ALIGN_BYTES = 16


def segments(sizes: Sequence[int], itemsize: int
             ) -> Tuple[List[int], int]:
    """Offsets (in elements) of consecutive segments of ``sizes`` elements
    of ``itemsize`` bytes, each starting 16-byte aligned, and the buffer's
    total length in elements."""
    if ALIGN_BYTES % itemsize:
        raise ValueError(f"itemsize {itemsize} does not divide "
                         f"{ALIGN_BYTES}")
    align = ALIGN_BYTES // itemsize
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // align) * align
    return offsets, total


def views(shapes: Sequence[Tuple[int, ...]], dtype: torch.dtype,
          device: torch.device) -> Tuple[List[torch.Tensor], List[int]]:
    """Contiguous 1-D or 2-D tensors of ``shapes``, views of one new
    buffer laid out by :func:`segments`, and their data pointers (taken
    from the buffer's, which is cheaper than asking each view)."""
    if any(len(s) not in (1, 2) for s in shapes):
        raise ValueError(f"expected 1-D or 2-D shapes, got {shapes}")
    itemsize = dtype.itemsize
    offsets, total = segments([math.prod(s) for s in shapes], itemsize)
    buf = torch.empty(total, dtype=dtype, device=device)
    base = buf.data_ptr()
    return ([buf.as_strided(s, (s[1], 1) if len(s) == 2 else (1,), o)
             for s, o in zip(shapes, offsets)],
            [base + o * itemsize for o in offsets])


def launch_groups(sizes: Sequence[int], cap: int) -> List[List[int]]:
    """The indices of the non-empty leaves (size > 0), in launches of at
    most ``cap`` leaves each, in order."""
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    live = [i for i, size in enumerate(sizes) if size > 0]
    return [live[s:s + cap] for s in range(0, len(live), cap)]


def launch(fn, columns: Sequence[Tuple[type, Sequence]],
           groups: List[List[int]], args: Sequence, device: torch.device,
           check) -> int:
    """Call the C launcher ``fn`` once per group, on the current stream of
    ``device``: ``fn(*arrays, count, *args, stream)``, where each of
    ``columns`` ``(ctype, values)`` becomes a host array of the group's
    values. ``check(code)`` raises on a failed launch. Returns the number
    of launches."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for idx in groups:
            n = len(idx)
            arrays = [(ctype * n)(*[values[i] for i in idx])
                      for ctype, values in columns]
            check(fn(*arrays, n, *args, stream))
    return len(groups)
