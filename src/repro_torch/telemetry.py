"""Round telemetry: each federated round's host spans and work counters,
kept in a bounded ring on the host, like ``logging``'s process-wide
state.

``FedCDServer.run_round`` and ``FedAvgServer.run_round`` each open one
:class:`Record` (:class:`Round`) and close it on return. A record holds
the server's kind and instance id, the round number ``t``, a sequence
number shared by every span of the round (its identifier), the spans
and the counters. A span is ``[name, parent, t0_ns, t1_ns]``: ``parent``
is the index of the span that was open when it began (``None`` for the
``round`` span), and its self time, its duration less what its
children cover, is computed when read (:meth:`Record.self_ns`).

Spans are stamped with ``time.time_ns()``, the Unix clock in which
``torch.profiler``'s (kineto) events carry their ``start_ns`` /
``end_ns``, so a span and the kernels of a profiled round lie on one
timeline. No span synchronizes: each is the host side of its phase,
and every blocking read on the round path is a ``wait`` span
(:func:`wait`).

Recording is on by default; ``configure(enabled=False)`` turns it off,
and then every span and count site costs one test (the round still
times itself, since ``RoundMetrics.wall_s`` is read from its start).
The round level holds about fifteen spans and a dict of integers; no
CUDA event and no device memory. Spans and counts made while no round is
open are dropped, except the process-level ones (:func:`process_span`,
:func:`process_count`: the kernels' builds), which go to one record of
kind ``"process"``. One thread records at a time.

    from repro_torch import telemetry
    srv.run(30)
    telemetry.records()[-1].counters     # the last round's counters
    telemetry.write_jsonl("rounds.jsonl")
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

CAPACITY = 4096                  # round records kept (the newest)

clock_ns = time.time_ns          # the profiler's clock (Unix ns)


class Record:
    """One round's (or the process's) spans and counters."""

    __slots__ = ("kind", "server", "t", "seq", "spans", "counters")

    def __init__(self, kind: str, server: Optional[int], t: Optional[int],
                 seq: Optional[int]):
        self.kind, self.server, self.t, self.seq = kind, server, t, seq
        self.spans: List[List[Any]] = []
        self.counters: Dict[str, int] = {}

    def self_ns(self) -> List[int]:
        """Each span's duration less its children's, in span order."""
        out = [t1 - t0 for _, _, t0, t1 in self.spans]
        for _, parent, t0, t1 in self.spans:
            if parent is not None:
                out[parent] -= t1 - t0
        return out

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "server": self.server, "t": self.t,
                "seq": self.seq, "spans": self.spans,
                "counters": self.counters}


class _Recorder:
    def __init__(self) -> None:
        self.enabled = True
        self.records: Deque[Record] = deque(maxlen=CAPACITY)
        self.process = Record("process", None, None, None)
        self.current: Optional[Record] = None    # the open round's
        self.stack: List[int] = []               # its open spans
        self.shapes: set = set()                 # train widths seen
        self.seq = itertools.count()
        self.ids = itertools.count()


_rec = _Recorder()


class _Null:
    """What a span site gets while nothing records."""

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("_record", "_stack", "_name", "_i")

    def __init__(self, record: Record, stack: List[int], name: str):
        self._record, self._stack, self._name = record, stack, name

    def __enter__(self) -> "_Span":
        spans, stack = self._record.spans, self._stack
        self._i = len(spans)
        spans.append([self._name, stack[-1] if stack else None,
                      clock_ns(), 0])
        stack.append(self._i)
        return self

    def __exit__(self, *exc) -> bool:
        self._record.spans[self._i][3] = clock_ns()
        self._stack.pop()
        return False


class Round:
    """``run_round``'s scope: opens the round's record and its ``round``
    span, and appends the record when the round returns (a round that
    raises leaves none). Times the round whether or not recording is on:
    ``elapsed_s()`` is the host time since it opened. ``stats``, an
    executor's :class:`~repro_torch.federated.executors.PipelineStats`,
    adds the round's delta of each of its counts as ``spec.<name>``."""

    __slots__ = ("_kind", "_server", "_t", "_stats", "_before", "record",
                 "t0")

    def __init__(self, kind: str, server: int, t: int, stats: Any = None):
        self._kind, self._server, self._t = kind, server, t
        self._stats, self._before, self.record = stats, None, None

    def __enter__(self) -> "Round":
        self.t0 = clock_ns()
        r = _rec
        if r.enabled and r.current is None:
            self.record = rec = Record(self._kind, self._server, self._t,
                                       next(r.seq))
            rec.spans.append(["round", None, self.t0, 0])
            r.current, r.stack = rec, [0]
            if self._stats is not None:
                self._before = self._stats.as_dict()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        rec = self.record
        if rec is not None:
            rec.spans[0][3] = clock_ns()
            if self._before is not None:
                for k, v in self._stats.as_dict().items():
                    if v != self._before[k]:
                        rec.counters[f"spec.{k}"] = v - self._before[k]
            _rec.current, _rec.stack = None, []
            if exc_type is None:
                _rec.records.append(rec)
        return False

    def elapsed_s(self) -> float:
        return (clock_ns() - self.t0) * 1e-9


def new_id() -> int:
    """An instance id for a server's records."""
    return next(_rec.ids)


def span(name: str):
    """A context manager timing ``name`` inside the open round."""
    rec = _rec.current
    if rec is None:
        return _NULL
    return _Span(rec, _rec.stack, name)


def wait():
    """A ``wait`` span: a blocking read on the round path."""
    return span("wait")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open round's counter ``name``."""
    rec = _rec.current
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def new_train_width(width: int) -> None:
    """Count ``new_shapes`` the first time this process (since the last
    :func:`reset`, while recording) launches a train bucket ``width``."""
    if _rec.current is not None and width not in _rec.shapes:
        _rec.shapes.add(width)
        count("new_shapes")


def process_span(name: str):
    """A span of the process record (outside any round's tree)."""
    if not _rec.enabled:
        return _NULL
    return _Span(_rec.process, [], name)


def process_count(name: str, n: int = 1) -> None:
    if _rec.enabled:
        c = _rec.process.counters
        c[name] = c.get(name, 0) + n


def records() -> List[Record]:
    """The round records kept, oldest first."""
    return list(_rec.records)


def process() -> Record:
    """The process record: the kernels' builds."""
    return _rec.process


def reset() -> None:
    """Forget every record, the process record and the shapes seen."""
    _rec.records.clear()
    _rec.process = Record("process", None, None, None)
    _rec.shapes = set()
    _rec.seq = itertools.count()


def configure(enabled: bool = True) -> None:
    """Turn recording on or off."""
    _rec.enabled = bool(enabled)


def write_jsonl(path: str) -> int:
    """Write the process record, then every round record, one JSON
    object a line; returns the number of lines."""
    lines = [_rec.process, *_rec.records]
    with open(path, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec.as_dict()) + "\n")
    return len(lines)
