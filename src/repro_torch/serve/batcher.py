"""Request and model-group bookkeeping for the serving gateway (port of
``repro/serve/batcher.py``; DESIGN.md §15): the continuous-batching slot
machine's HOST half.

A :class:`ModelGroup` owns one model's admission queue, its lane→request
map, and the per-lane current-token vector the next decode dispatch
consumes. All device-side work (prefill, lane insert, grouped decode)
lives in ``serve.gateway`` — the group is pure bookkeeping so its
invariants are testable without touching the device.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serve.kv_pool import KVPool


@dataclass
class Request:
    """One in-flight generation request."""
    rid: int
    device: int
    prompt: np.ndarray               # (P,) int32 prompt token ids
    max_new: int                     # decode budget
    model: int = -1                  # routed model id (-1 = unrouted)
    lane: int = -1                   # pool lane (-1 = queued)
    tokens: List[int] = field(default_factory=list)   # generated ids
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    rerouted: int = 0                # times re-routed (model deleted)
    failed: Optional[str] = None     # set when a re-route found no model

    @property
    def done(self) -> bool:
        return self.done_t is not None or self.failed is not None

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit → first generated token (the prefill-bound latency)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def total_s(self) -> Optional[float]:
        if self.done_t is None:
            return None
        return self.done_t - self.submit_t


class ModelGroup:
    """Slot machine for one model id: FIFO admission queue + active
    lane map + the (lanes,) current-token vector fed to the grouped
    decode dispatch. Finished requests free lanes mid-stream; the
    gateway re-admits from the queue in the same step."""

    def __init__(self, model_id: int, pool: KVPool,
                 draft_pool: Optional[KVPool] = None, spec_k: int = 0):
        self.model = model_id
        self.pool = pool
        self.draft_pool = draft_pool
        self.spec_k = spec_k
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.cur_tok = np.zeros((pool.lanes,), np.int32)
        self.steps = 0               # decode dispatches issued
        self.lane_steps = 0          # sum of active lanes over dispatches
        # speculative-decode lane state: the chunk the draft committed
        # last round ([cur, d_1..d_k]) and how many of its tokens the
        # verifier kept (0 = nothing pending, e.g. right after admit)
        self.prev_chunk = np.zeros((pool.lanes, spec_k + 1), np.int32)
        self.prev_keep = np.zeros((pool.lanes,), np.int32)
        self.spec_proposed = 0       # draft tokens proposed (active lanes)
        self.spec_accepted = 0       # of those, accepted by the verifier

    @property
    def live_lanes(self) -> int:
        return len(self.active)

    def has_work(self) -> bool:
        return bool(self.active or self.queue)

    def admit(self, req: Request, lane: int, first_token: int,
              now: Optional[float] = None) -> None:
        """Bind a prefilled request to ``lane`` (cache already inserted
        by the gateway) and record its first generated token."""
        req.model = self.model
        req.lane = lane
        req.tokens.append(int(first_token))
        req.first_token_t = time.perf_counter() if now is None else now
        self.cur_tok[lane] = int(first_token)
        self.prev_keep[lane] = 0     # fresh lane: nothing to commit
        self.active[lane] = req

    def finish(self, lane: int, now: Optional[float] = None) -> Request:
        """Retire the lane's request and free the lane."""
        req = self.active.pop(lane)
        req.done_t = time.perf_counter() if now is None else now
        req.lane = -1
        self.pool.release(lane)
        if self.draft_pool is not None:
            self.draft_pool.release(lane)
        self.prev_keep[lane] = 0
        return req

    def evict_all(self) -> List[Request]:
        """Drain every request (active + queued) for re-routing — the
        group's model was deleted. Active requests lose their lane
        state; the gateway re-prefills them on their new model."""
        out: List[Request] = []
        for lane in sorted(self.active):
            req = self.active.pop(lane)
            req.lane = -1
            self.pool.release(lane)
            if self.draft_pool is not None:
                self.draft_pool.release(lane)
            self.prev_keep[lane] = 0
            out.append(req)
        out.extend(self.queue)
        self.queue.clear()
        return out

    def batching_efficiency(self) -> float:
        """Mean occupied-lane fraction over the group's dispatches."""
        if self.steps == 0:
            return 0.0
        return self.lane_steps / (self.steps * self.pool.lanes)

    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the verifier accepted."""
        if self.spec_proposed == 0:
            return 0.0
        return self.spec_accepted / self.spec_proposed
