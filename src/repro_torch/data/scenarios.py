"""Dynamic device populations and semi-synchronous arrival models (port
of ``repro/data/scenarios.py``: churn schedules, straggler latencies and
dropouts; pure numpy, the reference's RNG streams).

A :class:`ChurnSchedule` scripts the device lifecycle — joins (a new
device with a fresh non-IID split enters), leaves (a device departs; its
data-bank slot is freed for reuse) and label drift (a device's local
distribution shifts to a new archetype) — as per-round intents the
control plane consumes alongside FedCD's model clone/delete intents.

Determinism contract: the schedule is resolved on the host at round
START, in a fixed order (leaves → joins → drifts), drawing data for
joins and drifts from a dedicated churn RNG stream seeded off the
schedule, never off an engine's dispatch order. Joining devices claim
monotonically increasing device ids (ids are never reused; data ROWS are
— ``data.bank.DeviceDataBank``), so the present set of any future round
is computable without applying it: the sampling prefetch and the
pipelined executors' speculation guards rely on that.

A :class:`StragglerModel` makes rounds semi-synchronous: per-device
virtual latencies decide which pairs make the round's quorum deadline,
drawn per round from a stream keyed on (seed, round) alone.

A :class:`FaultSchedule` scripts process crashes at named phases of a
round, for the elastic checkpoint/resume harness.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from repro_torch.data.partition import (DeviceData, dirichlet_probs,
                                        hierarchical_probs,
                                        hypergeometric_probs, make_device)

CHURN_STREAM = 0xC4A12   # keys the churn-data RNG off the schedule seed
STRAGGLER_STREAM = 0x57A66   # keys the latency/dropout RNG off the model seed


@dataclass(frozen=True)
class DeviceJoin:
    round: int
    archetype: int


@dataclass(frozen=True)
class DeviceLeave:
    round: int
    device: int


@dataclass(frozen=True)
class LabelDrift:
    round: int
    device: int
    archetype: int


@dataclass
class ChurnSchedule:
    """A scripted device lifecycle + the recipe for generating the data
    of joining/drifting devices (split sizes must match the base
    population's — the bank validates row shapes on write)."""
    events: Tuple = ()
    partition: str = "hierarchical"   # hierarchical|hypergeometric|dirichlet
    seed: int = 0
    bias: float = 0.65                # hierarchical archetype bias
    alpha: float = 0.5                # dirichlet concentration
    n_train: int = 64
    n_val: int = 32
    n_test: int = 32
    noise: float = 2.0
    _by_round: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        for e in self.events:
            self._by_round.setdefault(e.round, []).append(e)

    def make_rng(self) -> np.random.Generator:
        return np.random.default_rng([self.seed, CHURN_STREAM])

    @property
    def total_joins(self) -> int:
        return sum(1 for e in self.events if isinstance(e, DeviceJoin))

    def row_capacity(self, n_initial: int) -> int:
        """Upper bound on concurrent devices: every join before any
        leave (slot reuse only shrinks the real requirement)."""
        return n_initial + self.total_joins

    def has_events(self, t: int) -> bool:
        return t in self._by_round

    def last_round(self) -> int:
        return max((e.round for e in self.events), default=0)

    def joins_at(self, t: int) -> List[DeviceJoin]:
        return [e for e in self._by_round.get(t, ())
                if isinstance(e, DeviceJoin)]

    def leaves_at(self, t: int) -> List[DeviceLeave]:
        return [e for e in self._by_round.get(t, ())
                if isinstance(e, DeviceLeave)]

    def drifts_at(self, t: int) -> List[LabelDrift]:
        return [e for e in self._by_round.get(t, ())
                if isinstance(e, LabelDrift)]

    def archetype_probs(self, archetype: int) -> np.ndarray:
        if self.partition == "hierarchical":
            return hierarchical_probs(archetype, self.bias)
        if self.partition == "hypergeometric":
            return hypergeometric_probs(archetype)
        if self.partition == "dirichlet":
            # deterministic per-archetype draw so a drift target's
            # distribution doesn't depend on event interleaving
            rng = np.random.default_rng([self.seed, archetype])
            return dirichlet_probs(rng, self.alpha)
        raise ValueError(f"unknown partition {self.partition!r}")

    def make_device(self, rng: np.random.Generator,
                    archetype: int) -> DeviceData:
        return make_device(rng, archetype, self.archetype_probs(archetype),
                           self.n_train, self.n_val, self.n_test,
                           self.noise)


@dataclass(frozen=True)
class DeviceDropout:
    """A scripted mid-round failure: the device's dispatched update for
    ``round`` never arrives (its pairs aggregate with zero weight and
    are never buffered — unlike a straggler, there is nothing to fold)."""
    round: int
    device: int


@dataclass
class StragglerModel:
    """Per-device latency + mid-round dropout model for semi-synchronous
    rounds. Latencies are VIRTUAL time: the planner uses them to resolve
    which pairs make the round's aggregation deadline, not to delay any
    real dispatch.

    Determinism contract (as :class:`ChurnSchedule`'s): each round's
    latencies and random dropouts are drawn on the host from a dedicated
    RNG stream seeded ``[seed, STRAGGLER_STREAM, round]`` as whole
    per-device vectors in a fixed order; a device's persistent speed
    factor (``hetero``) comes from the round-independent stream
    ``[seed, STRAGGLER_STREAM]``.

    * ``distribution``: ``"zero"`` (the synchronous gate — all arrivals
      instantaneous), ``"exponential"``, or ``"lognormal"`` (heavy tail;
      ``sigma`` is the log-space spread).
    * ``quorum``: fraction of this round's arriving pairs the server
      waits for before aggregating (FedBuff's K). The round's deadline
      is the K-th smallest arrival; later pairs become stragglers.
    * ``gamma`` / ``max_staleness``: a straggler folding in after τ
      rounds carries eq-1 weight ``c·γ^τ``; buffered updates staler
      than ``max_staleness`` rounds are discarded.
    * ``dropout_rate`` / ``dropouts``: random per-(device, round) and
      scripted mid-round failures.
    """
    distribution: str = "lognormal"   # zero|exponential|lognormal
    scale: float = 1.0                # latency scale (virtual seconds)
    sigma: float = 1.0                # lognormal log-space spread
    hetero: float = 0.0               # persistent per-device speed spread
    quorum: float = 0.75              # aggregate at this arrival fraction
    gamma: float = 0.5                # staleness discount base
    max_staleness: int = 2            # rounds buffered before expiry
    dropout_rate: float = 0.0         # random mid-round failure rate
    dropouts: Tuple[DeviceDropout, ...] = ()
    seed: int = 0
    _drops_by_round: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.distribution not in ("zero", "exponential", "lognormal"):
            raise ValueError(
                f"unknown latency distribution {self.distribution!r}")
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1]: {self.quorum}")
        if not 0.0 <= self.gamma <= 1.0:
            raise ValueError(f"gamma must be in [0, 1]: {self.gamma}")
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0: {self.max_staleness}")
        for e in self.dropouts:
            self._drops_by_round.setdefault(e.round, set()).add(e.device)

    @classmethod
    def zero(cls, **kw) -> "StragglerModel":
        """The zero-latency gate: every pair arrives instantly, so a
        semi-synchronous run is bit-identical to the synchronous one."""
        return cls(distribution="zero", dropout_rate=0.0, **kw)

    def speeds(self, id_cap: int) -> np.ndarray:
        """Persistent per-device latency multipliers (lognormal around 1
        with log-space spread ``hetero``; all-ones when disabled)."""
        if self.hetero <= 0.0:
            return np.ones(id_cap)
        rng = np.random.default_rng([self.seed, STRAGGLER_STREAM])
        return np.exp(self.hetero * rng.standard_normal(id_cap))

    def resolve(self, t: int, id_cap: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Round ``t``'s per-device ``(latency, dropped)`` vectors, drawn
        for the whole id space so the result never depends on which
        devices participate or how an engine buckets them."""
        rng = np.random.default_rng([self.seed, STRAGGLER_STREAM, t])
        if self.distribution == "zero":
            lat = np.zeros(id_cap)
        elif self.distribution == "exponential":
            lat = self.scale * rng.exponential(size=id_cap)
        else:
            lat = self.scale * rng.lognormal(mean=0.0, sigma=self.sigma,
                                             size=id_cap)
        lat = lat * self.speeds(id_cap)
        dropped = rng.random(id_cap) < self.dropout_rate
        for d in self._drops_by_round.get(t, ()):
            if d < id_cap:
                dropped[d] = True
        return lat, dropped


#: the scripted crash points a :class:`FaultSchedule` may name, in
#: round order: after the plan is built, after dispatch (work in
#: flight, nothing read back), after readback + lifecycle (the round's
#: state is complete but unsaved), and inside the checkpoint writer
#: between the array commit and the manifest commit (a torn save).
FAULT_PHASES = ("post-plan", "mid-dispatch", "post-readback", "mid-save")


class SimulatedCrash(RuntimeError):
    """A scripted process crash (fault-injection harness). Raised
    mid-round by the server's phase hooks — everything the process held
    (device buffers, in-flight work, host state) is presumed lost;
    recovery is construct-anew + ``resume_from``."""


@dataclass(frozen=True)
class FaultEvent:
    """Crash the process at round ``round``, phase ``phase``."""
    round: int
    phase: str

    def __post_init__(self):
        if self.phase not in FAULT_PHASES:
            raise ValueError(
                f"unknown fault phase {self.phase!r} "
                f"(want one of {FAULT_PHASES})")


@dataclass
class FaultSchedule:
    """Scripted process crashes for the elastic-resume harness. The
    servers call :meth:`check` at each phase boundary of every round; a
    scheduled event raises :class:`SimulatedCrash` there. The schedule is
    stateless — a resumed run that re-executes the crash round must be
    constructed WITHOUT it (a real restarted process would not
    re-crash)."""
    events: Tuple[FaultEvent, ...] = ()
    _at: set = field(default_factory=set, repr=False)

    def __post_init__(self):
        for e in self.events:
            self._at.add((e.round, e.phase))

    def fires(self, t: int, phase: str) -> bool:
        return (t, phase) in self._at

    def check(self, t: int, phase: str) -> None:
        if self.fires(t, phase):
            raise SimulatedCrash(
                f"scripted crash at round {t} ({phase})")


def random_churn(rounds: int, n_initial: int, seed: int = 0,
                 join_rate: float = 0.3, leave_rate: float = 0.2,
                 drift_rate: float = 0.1, min_devices: int = 2,
                 n_archetypes: int = 10, first_round: int = 2,
                 **schedule_kw) -> ChurnSchedule:
    """A deterministic random schedule: each round independently draws a
    join (fresh archetype), a leave (uniform over the devices that would
    be present, floored at ``min_devices``), and a drift. Built entirely
    at schedule-construction time so the run itself stays scripted."""
    rng = np.random.default_rng([seed, 0x5C4ED])
    present = list(range(n_initial))
    next_id = n_initial
    events: List = []
    for t in range(first_round, rounds + 1):
        stayers = list(present)     # valid leave/drift targets this round
        if rng.random() < leave_rate and len(present) > min_devices:
            d = stayers.pop(int(rng.integers(len(stayers))))
            events.append(DeviceLeave(t, d))
            present.remove(d)
        if rng.random() < join_rate:
            events.append(DeviceJoin(t, int(rng.integers(n_archetypes))))
            present.append(next_id)
            stayers.append(next_id)  # drifting a same-round join is fine
            next_id += 1
        if rng.random() < drift_rate and stayers:
            d = stayers[int(rng.integers(len(stayers)))]
            events.append(LabelDrift(t, d, int(rng.integers(n_archetypes))))
    return ChurnSchedule(events=tuple(events), seed=seed, **schedule_kw)
