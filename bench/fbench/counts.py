"""The benchmark's own operation and byte counts: what the algorithm
needs for these shapes, not what an implementation happens to execute.

* The CNN (paper section 3.1): 2 x multiply-adds of every convolution
  and dense layer. Training a sample is its forward, the gradient of
  every weight, and the gradient of every layer's input but the first
  (the images take none). Elementwise work (bias, ReLU, pooling, the
  loss) is left out, as is usual for a share of peak.
* Eq 1 (``weighted_agg``): one call over a group of leaves (B pairs of
  D_i floats each, an (M, B) weight matrix, M denominators) reads the
  updates and the weights once and writes M rows of each leaf.
* The transport round trip (``quantize`` + ``dequantize``): a row of D
  floats in 128-value blocks is read once and written as int8 codes of
  the padded row plus one float32 scale a block; dequantizing reads the
  codes and scales and writes the D floats.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

BLOCK = 128
F32 = 4


def cnn_layers(channels: Sequence[int], dense: int, n_classes: int,
               image: int, in_ch: int = 3) -> List[Tuple[str, float]]:
    """(layer, forward FLOPs per image) of the paper's CNN: 3x3 convs at
    padding 1, a 2x2 pool after every second, then two dense layers."""
    out, size, c_in = [], image, in_ch
    for i, c_out in enumerate(channels):
        out.append((f"conv.{i}", 2.0 * size * size * c_in * c_out * 9))
        c_in = c_out
        if i % 2 == 1:
            size //= 2
    flat = size * size * c_in
    out.append(("fc1", 2.0 * flat * dense))
    out.append(("fc2", 2.0 * dense * n_classes))
    return out


def cnn_flops(channels: Sequence[int], dense: int, n_classes: int,
              image: int) -> Tuple[float, float]:
    """(forward FLOPs of one image, training FLOPs of one sample)."""
    layers = cnn_layers(channels, dense, n_classes, image)
    fwd = sum(f for _, f in layers)
    # weight gradients: one product per layer; input gradients: all but
    # the first layer's
    train = fwd + fwd + (fwd - layers[0][1])
    return fwd, train


def eq1_bytes(pairs: int, widths: Sequence[int], models: int) -> int:
    """One grouped eq-1 call: updates (B, D_i) and weights (M, B) and
    denominators (M,) read, (M, D_i) written, float32."""
    d = sum(widths)
    return F32 * (pairs * d + models * pairs + models + models * d)


def padded(n: int) -> int:
    return n + (-n) % BLOCK


def quantize_bytes(rows: Sequence[Tuple[int, int]]) -> int:
    """One grouped quantize call over (R, D) float32 rows: R*D floats
    read, R*D_pad int8 codes and R*D_pad/128 float32 scales written."""
    return sum(r * (F32 * d + padded(d) + F32 * padded(d) // BLOCK)
               for r, d in rows)


def dequantize_bytes(rows: Sequence[Tuple[int, int]]) -> int:
    """One grouped dequantize call back to (R, D) float32 rows."""
    return sum(r * (padded(d) + F32 * padded(d) // BLOCK + F32 * d)
               for r, d in rows)
