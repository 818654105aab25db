"""Roofline analysis of a traced dry-run step (port of
``repro/roofline/analysis.py``; no hardware).

Terms, per chip (the reference's formulas, an H100's constants):
  compute    = FLOPs  / peak_flops
  memory     = bytes  / hbm_bw
  collective = Σ collective bytes / link_bw

The reference reads per-device FLOPs and bytes from XLA's SPMD-
partitioned module; here they are the busiest cell's counts from one
trace of the port's own step (``trace_analyzer.analyze``), which are
per-chip figures in the same sense. The reported seconds assume that
nothing overlaps.

:class:`HW` holds NVIDIA's figures for the H100 SXM5 80 GB (700 W), from
NVIDIA's *H100 Tensor Core GPU* datasheet:

* ``peak_flops`` = 989e12: the dense BF16 Tensor Core rate (the
  datasheet's 1,979 TFLOPS is with 2:4 sparsity, which no step here
  uses);
* ``hbm_bw`` = 3.35e12 B/s, the HBM3 bandwidth;
* ``link_bw`` = 450e9 B/s: the datasheet gives NVLink 900 GB/s per GPU,
  the sum of both directions over its 18 links; a cell *receives* a
  collective's bytes, so the term takes one direction, half of it. It
  plays the part of the reference's ``ici_bw`` (50e9 B/s a TPU v5e ICI
  link).

The reference's ``collective_bytes_from_hlo`` parses XLA's optimized HLO
for collective ops; the port has no HLO. Its collectives are the
runtime's own calls (``launch/tensor_parallel.py``), recorded where they
are called with the bytes each receiving cell receives, in the
reference's shape ``{"total_bytes", "by_kind", "counts"}`` so that
:func:`roofline_terms` takes them unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from repro_torch.config import ArchConfig, ShapeConfig

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


@dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12        # dense bf16 per chip
    hbm_bw: float = 3.35e12           # B/s per chip
    link_bw: float = 450e9            # NVLink B/s per chip, one direction


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), D = tokens/step."""
    counts = cfg.param_counts()
    n = counts["active"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                   else (shape.seq_len if shape.kind ==
                                         "prefill" else 1))
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def roofline_terms(cost: Dict[str, float], collectives: Dict[str, Any],
                   chips: int, cfg: Optional[ArchConfig] = None,
                   shape: Optional[ShapeConfig] = None,
                   hw: HW = HW()) -> Dict[str, Any]:
    """cost: per-chip ``{"flops", "bytes accessed"}`` (the busiest
    cell's)."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = float(collectives["total_bytes"])
    t_compute = flops_dev / hw.peak_flops
    t_memory = bytes_dev / hw.hbm_bw
    t_coll = coll_dev / hw.link_bw
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    out = {
        "chips": chips,
        "hlo_flops_per_chip": flops_dev,
        "hlo_bytes_per_chip": bytes_dev,
        "collective_bytes_per_chip": coll_dev,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "collectives": collectives,
    }
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        out["model_flops_global"] = mf
        hlo_global = flops_dev * chips
        out["useful_flops_ratio"] = (mf / hlo_global) if hlo_global else 0.0
        step_time = max(t_compute, t_memory, t_coll)
        out["mfu_bound"] = (mf / chips / hw.peak_flops / step_time
                            if step_time else 0.0)
    return out
