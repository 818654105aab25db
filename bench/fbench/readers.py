"""What the per-layer metric files under ``bench/metrics/`` read from a
traced run's context (``ctx``), shared so that one quantity split over
cells by name is read alike. Each returns None where there is nothing
to read."""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

from fbench import peaks


def window(ctx: Dict[str, Any], key: str) -> Optional[float]:
    """A per-round mean of the window (``plan_ms``, ``train_ms``,
    ``eval_ms``)."""
    return ctx.get("window", {}).get(key)


def roofline(ctx: Dict[str, Any], kernel: str, calls: str
             ) -> Optional[float]:
    """Percent of the roofline: the least time the H100 needs for the
    traced rounds' calls (``(bytes, operations)`` each, bounded by 3.35
    TB/s or 67 TFLOP/s float32, whichever is larger) over the device
    time of the kernels whose names match ``kernel``."""
    tr = ctx.get("traced", {})
    pattern = re.compile(kernel)
    t = sum(s for name, s in tr.get("kernels", {}).items()
            if pattern.search(name))
    work = tr.get(calls, [])
    if not t or not work:
        return None
    bound = sum(max(b / peaks.HBM_BYTES_PER_S, f / peaks.FLOAT32_FLOPS)
                for b, f in work)
    return 100.0 * bound / t


def idle_share(ctx: Dict[str, Any]) -> Optional[float]:
    """Percent of the traced rounds' host windows with nothing running
    on the device."""
    tr = ctx.get("traced", {})
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(ctx: Dict[str, Any]) -> Optional[float]:
    """Percent of the peak of the cell's dtype: the benchmark's FLOPs of
    the window's rounds over their walls."""
    w = ctx.get("window", {})
    if not w.get("flops") or not w.get("wall_s"):
        return None
    return 100.0 * w["flops"] / (w["wall_s"] * w["peak_flops"])
