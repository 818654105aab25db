"""The device trace of a traced run, reduced: the device's busy time
inside the rounds' host windows, its idle time split by what the host
was doing, and device time by kernel name. The arithmetic is that of
``examples/profile_round_torch.py`` (``union``, ``phase_at``), copied;
the device's intervals are read from the profiler's raw (kineto)
events, and the rounds' windows and the host phases are spans the
benchmark took itself on the same clock (``time.time_ns``).

A moment of a gap belongs to the first of ``phases`` whose span is
open then, else to ``other``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch

Span = Tuple[int, int]


def union(spans: Sequence[Span]) -> Tuple[int, List[List[int]]]:
    merged: List[List[int]] = []
    for s0, e0 in sorted(spans):
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e0)
        else:
            merged.append([s0, e0])
    return sum(e - s for s, e in merged), merged


def device_events(prof) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of every kernel, copy and set on the
    device in ``prof``'s trace."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def _phase_at(t: float, ranges: Dict[str, List[Span]],
              phases: Sequence[str]) -> str:
    for label in phases:
        for s, e in ranges.get(label, ()):
            if s <= t < e:
                return label
    return "other"


def analyse(device: List[Tuple[int, int, str]], windows: List[Span],
            ranges: Dict[str, List[Span]], phases: Sequence[str]) -> Dict:
    """{"busy_s", "window_s", "rounds", "kernels": {name: s},
    "idle": {phase: s}} over the round ``windows`` (ns; they do not
    overlap)."""
    windows = sorted(windows)
    starts = [w[0] for w in windows]
    kernels: Dict[str, float] = defaultdict(float)
    idle: Dict[str, float] = defaultdict(float)
    per_window: Dict[int, List[Span]] = defaultdict(list)
    for s0, e0, name in device:
        i = bisect.bisect_right(starts, e0) - 1
        while i >= 0 and windows[i][1] > s0:
            w0, w1 = windows[i]
            a, b = max(s0, w0), min(e0, w1)
            if a < b:
                per_window[i].append((a, b))
                kernels[name] += (b - a) * 1e-9
            i -= 1
    busy_total = window_total = 0
    for i, (w0, w1) in enumerate(windows):
        busy, merged = union(per_window[i])
        busy_total += busy
        window_total += w1 - w0
        inside = {k: [(max(s, w0), min(e, w1)) for s, e in v
                      if e > w0 and s < w1] for k, v in ranges.items()}
        cuts = sorted({t for v in inside.values() for span in v
                       for t in span})
        prev, gaps = w0, []
        for s0, e0 in merged:
            if s0 > prev:
                gaps.append((prev, s0))
            prev = max(prev, e0)
        if prev < w1:
            gaps.append((prev, w1))
        for g0, g1 in gaps:
            lo, hi = bisect.bisect_right(cuts, g0), bisect.bisect_left(cuts,
                                                                       g1)
            pts = [g0] + cuts[lo:hi] + [g1]
            for a, b in zip(pts, pts[1:]):
                idle[_phase_at((a + b) / 2, inside, phases)] += (b - a) * 1e-9
    return {"busy_s": busy_total * 1e-9, "window_s": window_total * 1e-9,
            "rounds": len(windows), "kernels": dict(kernels),
            "idle": dict(idle)}


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
