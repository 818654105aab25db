"""Wrappers the benchmark puts around the program's calls in a traced
run: host spans (``time.perf_counter``), device spans (CUDA events at
the call's ends, as ``examples/profile_round_torch.py`` takes them) and,
while the profiler runs, the host phases on the profiler's clock
(``time.time_ns``). None of them is installed in a timed run."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch


class Spans:
    """``on``: per-round sums of host and device spans by name (the
    window); ``tracing``: each host phase's (start, end) ns (the
    profiled rounds)."""

    def __init__(self) -> None:
        self.host: Dict[str, List[float]] = defaultdict(list)
        self.device: Dict[str, List[float]] = defaultdict(list)
        self.ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self._host: Dict[str, float] = defaultdict(float)
        self._device: Dict[str, List[Tuple]] = defaultdict(list)
        self.on = False
        self.tracing = False

    def host_span(self, name: str, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            if not (self.on or self.tracing):
                return fn(*args, **kwargs)
            t0, n0 = time.perf_counter(), time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                if self.on:
                    self._host[name] += time.perf_counter() - t0
                if self.tracing:
                    self.ranges[name].append((n0, time.time_ns()))
        return wrapper

    def device_span(self, name: str, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self._device[name].append((start, end))
            return out
        return wrapper

    def end_round(self) -> None:
        """Close a round of the window (after its synchronize)."""
        if not self.on:
            return
        for name, s in self._host.items():
            self.host[name].append(s)
        for name, evs in self._device.items():
            self.device[name].append(sum(a.elapsed_time(b) * 1e-3
                                         for a, b in evs))
        self._host.clear()
        self._device.clear()

    def mean_ms(self, name: str, kind: str = "host"):
        vals = (self.host if kind == "host" else self.device).get(name)
        return 1e3 * sum(vals) / len(vals) if vals else None
