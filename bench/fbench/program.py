"""The program's own round records (``repro_torch.telemetry``) of a
traced run's window, for the per-layer metrics that read them.

A traced run records, in order, the set-up's rounds, the window's
``ctx["window"]["rounds"]`` rounds and the ``ctx["traced"]["rounds"]``
profiled rounds, so the window is the records before the profiled ones.
Each function returns None where there is nothing to read: a context
without those counts, fewer records than they add up to, or a program
without the telemetry module.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def window(ctx: Dict[str, Any]) -> Optional[List[Any]]:
    n = ctx.get("window", {}).get("rounds")
    t = ctx.get("traced", {}).get("rounds")
    if not n or t is None:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    recs = telemetry.records()
    if len(recs) < n + t:
        return None
    return recs[len(recs) - n - t:len(recs) - t]


def span_ms(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """Host milliseconds a round in the spans called ``name``, the
    window's mean."""
    recs = window(ctx)
    if recs is None:
        return None
    ns = sum(s[3] - s[2] for r in recs for s in r.spans if s[0] == name)
    return 1e-6 * ns / len(recs)


def counter(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """The counter ``name`` a round, the window's mean."""
    recs = window(ctx)
    if recs is None:
        return None
    return sum(r.counters.get(name, 0) for r in recs) / len(recs)


def pad_share(ctx: Dict[str, Any]) -> Optional[float]:
    """Percent of the trained rows that were padding, over the window."""
    recs = window(ctx)
    if recs is None:
        return None
    pad = sum(r.counters.get("pairs_padded", 0) for r in recs)
    rows = pad + sum(r.counters.get("pairs", 0) for r in recs)
    return 100.0 * pad / rows if rows else None
