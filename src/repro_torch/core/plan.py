"""Host-side round planning: the control-plane half of a FedCD round
(port of ``repro/core/plan.py``: the synchronous, semi-synchronous and
speculative planner with the sparse-eval crossover).

A :class:`RoundPlan` is everything the host decides about one round
before any device work is dispatched: the sampled cohort, the gathered
``(participating & holder)`` work pairs, which eval rows are stale, the
transport count, whether validation scoring may go sparse, the pending
lifecycle intent (cloning on milestone rounds), the device churn applied
at the round's start and, on semi-synchronous rounds, which pairs
straggle or drop and which buffered updates fold in
(:class:`SemiSyncCoordinator`). Plans reference models and devices by
id; with one bank shard the model id is the bank row, and the executor
resolves device ids to data rows at dispatch.

The planner is pure host bookkeeping and consumes no RNG, which is what
makes *speculative* plans possible: the pipelined executors ask for
round t+1's plan from the prefetched sample and the PRE-lifecycle state
while round t's eval matrices are still in flight, then repair or
rebuild it once round t's lifecycle has run (``speculative=True`` marks
such plans; their pair set is a superset of the true round's whenever
only deletions occurred).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.config import FedCDConfig
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.scores import ScoreState


@dataclass
class EvalHints:
    """What the executor already knows bit-identically: which models
    have cached val/test accuracy rows, and which test rows next round
    is predicted to read (last round's preferred models)."""
    val_cached: Set[int]
    test_cached: Set[int]
    pred_rows: List[int]


@dataclass(frozen=True)
class FoldEntry:
    """One buffered straggler update folding into this round: the
    executor blends its harvested trained row into the model's params
    with eq-1 weight ``weight = c·γ^τ``."""
    model: int
    device: int
    dispatch_round: int              # the round whose train produced it
    staleness: int                   # τ = fold round − dispatch round
    weight: float                    # staleness-discounted eq-1 weight


@dataclass
class SemiSyncStats:
    """Semi-synchronous round accounting."""
    rounds: int = 0
    dispatched: int = 0              # work pairs dispatched
    ontime: int = 0                  # pairs inside the quorum deadline
    stragglers: int = 0              # pairs buffered past the deadline
    dropouts: int = 0                # pairs that never arrived
    folded: int = 0                  # buffered updates blended back in
    expired: int = 0                 # buffered updates discarded
    staleness_hist: Dict[int, int] = field(default_factory=dict)
    t_semisync: float = 0.0          # Σ virtual quorum-deadline waits
    t_sync: float = 0.0              # Σ virtual full-barrier waits

    def as_dict(self) -> Dict:
        return {"rounds": self.rounds, "dispatched": self.dispatched,
                "ontime": self.ontime, "stragglers": self.stragglers,
                "dropouts": self.dropouts, "folded": self.folded,
                "expired": self.expired,
                "staleness_hist": dict(sorted(
                    self.staleness_hist.items())),
                "t_semisync": self.t_semisync, "t_sync": self.t_sync}


@dataclass
class RoundPlan:
    """One round's host-side work order (model ids)."""
    round: int
    participating: np.ndarray        # (N,) bool — sampled cohort
    perms: np.ndarray                # (N, T, b) int32 minibatch schedule
    scores: np.ndarray               # c (N, M_cap) — eq 3 at plan time
    live: List[int]                  # live model ids, sorted
    agg_models: List[int]            # models with >= 1 work pair
    pair_model: List[int]            # work pairs: model id per pair
    pair_device: List[int]           # work pairs: device id per pair
    transfers: int                   # up+down transport count (§3.6)
    val_stale: List[int]             # rows to (re-)score on val
    test_stale: List[int]            # predicted test rows to refresh
    sparse_val: bool = False         # score only holders' splits
    val_pair_model: List[int] = field(default_factory=list)
    val_pair_device: List[int] = field(default_factory=list)
    clone_milestone: bool = False    # pending lifecycle intent
    speculative: bool = False        # built from pre-lifecycle state
    # device-lifecycle intents: churn already applied at THIS round's
    # start, and whether the NEXT round has scheduled churn (the
    # pipelined executors skip speculation across it — the cohort and
    # data rows it would train against are about to change)
    device_joins: List[int] = field(default_factory=list)
    device_leaves: List[int] = field(default_factory=list)
    churn_next: bool = False
    # semi-synchronous resolution — all empty/zero on a synchronous
    # round, and then every dispatch path is the synchronous one (the
    # zero-latency gate). ``straggler_pairs``/``dropped_pairs`` index
    # into the pair lists; straggler pairs still TRAIN (their rows are
    # harvested into the executor's stale buffer) but their ``scores``
    # entries are zeroed so the weight builders exclude them from eq 1.
    straggler_pairs: List[int] = field(default_factory=list)
    dropped_pairs: List[int] = field(default_factory=list)
    # per-model fold orders: {model: (prior aggregation mass,
    # [FoldEntry, ...])} — blended into the bank at launch, BEFORE this
    # round's dispatch, so training and eval see post-fold params
    folds: Dict[int, Tuple[float, List[FoldEntry]]] = \
        field(default_factory=dict)
    # expired buffer keys (dispatch_round, model, device) to discard
    fold_drops: List[Tuple[int, int, int]] = field(default_factory=list)
    fold_next: bool = False          # round t+1 folds (speculation guard)
    round_time: float = 0.0          # virtual wait to the quorum deadline
    sync_time: float = 0.0           # virtual wait a full barrier would pay

    def pairs(self) -> List[Tuple[int, int]]:
        return list(zip(self.pair_model, self.pair_device))

    def changed_models(self) -> List[int]:
        """Models whose params change at this launch (aggregation or
        stale-update fold) — the eval-cache staleness set."""
        return sorted(set(self.agg_models) | set(self.folds))

    def semisync_work(self) -> bool:
        """Whether this round needs the buffered dispatch: straggler rows
        to harvest, or an on-time cohort too thin to aggregate at all (a
        zero-latency round never does)."""
        return bool(self.straggler_pairs) or (
            bool(self.pair_model) and not self.agg_models)


def gather_pairs(state: ScoreState, registry: ModelRegistry,
                 participating: np.ndarray
                 ) -> Tuple[List[int], List[int], List[int], int]:
    """(participating & holder) pairs in live-model-id order, plus the
    transport count (2 transfers per holder: up + down)."""
    agg_models: List[int] = []
    pair_model: List[int] = []
    pair_device: List[int] = []
    transfers = 0
    for m in registry.live_ids():
        holders = state.active[:, m] & participating
        if not holders.any():
            continue
        d_ids = np.nonzero(holders)[0]
        agg_models.append(m)
        pair_model.extend([m] * len(d_ids))
        pair_device.extend(int(d) for d in d_ids)
        transfers += 2 * len(d_ids)
    return agg_models, pair_model, pair_device, transfers


@dataclass
class _Pending:
    """One straggler update in flight: dispatched at ``dispatch_round``
    with undiscounted eq-1 weight ``weight``, arriving (virtual clock)
    at ``arrival``."""
    dispatch_round: int
    model: int
    device: int
    weight: float
    arrival: float


class SemiSyncCoordinator:
    """Host-side semi-synchronous round resolution, shared by FedCD's
    :class:`RoundPlanner` and the FedAvg control plane. Owns the virtual
    clock, the straggler carry-over buffer and each model's aggregation
    MASS — the Σc of the weights behind its current params, which makes
    the stale fold a pure eq-1 extension: folding update v with
    discounted weight c̃ into a model of mass M yields
    ``(M·w + c̃·v) / (M + c̃)``, the average eq 1 would have produced had
    v arrived on time with weight c̃.

    ``resolve`` mutates a built plan in place: per-pair arrivals come
    from the straggler model's per-device latency vector, the round's
    deadline is the quorum-fraction arrival, late pairs are weight-
    zeroed (on a COPY of the scores matrix — every weight builder reads
    ``plan.scores`` and nothing else) and buffered, dropped pairs are
    weight-zeroed and forgotten, and buffered updates whose arrival
    precedes this round's start fold in (or expire past
    ``max_staleness`` / model death). Every decision is a function of
    (round, device id) alone, so every engine resolves the same
    trajectory."""

    def __init__(self, straggler, n_devices: int):
        self.model = straggler
        self.n_devices = n_devices
        self.clock = 0.0
        self.pending: List[_Pending] = []
        self.mass: Dict[int, float] = {}
        self.stats = SemiSyncStats()

    def on_clones(self, cloned: List[Tuple[int, int]]) -> None:
        """A clone's params start as its parent's: carry the mass."""
        for parent, clone in cloned:
            if parent in self.mass:
                self.mass[clone] = self.mass[parent]

    # -- checkpoint state ---------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The coordinator's complete logical state (JSON-safe): the
        virtual clock, every in-flight straggler, each model's
        aggregation mass and the accounting stats."""
        return {
            "clock": self.clock,
            "pending": [[p.dispatch_round, p.model, p.device,
                         p.weight, p.arrival] for p in self.pending],
            "mass": {str(m): v for m, v in self.mass.items()},
            "stats": self.stats.as_dict(),
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        self.clock = float(state["clock"])
        self.pending = [_Pending(int(r), int(m), int(d), float(w),
                                 float(a))
                        for r, m, d, w, a in state["pending"]]
        self.mass = {int(m): float(v) for m, v in state["mass"].items()}
        st = state["stats"]
        self.stats = SemiSyncStats(
            rounds=st["rounds"], dispatched=st["dispatched"],
            ontime=st["ontime"], stragglers=st["stragglers"],
            dropouts=st["dropouts"], folded=st["folded"],
            expired=st["expired"],
            staleness_hist={int(k): v
                            for k, v in st["staleness_hist"].items()},
            t_semisync=st["t_semisync"], t_sync=st["t_sync"])

    def _fold_ready(self, plan: RoundPlan, live: Set[int]) -> None:
        st = self.stats
        ready = [p for p in self.pending if p.arrival <= self.clock]
        self.pending = [p for p in self.pending
                        if p.arrival > self.clock]
        entries: Dict[int, List[FoldEntry]] = {}
        for p in ready:
            tau = plan.round - p.dispatch_round
            if p.model not in live or tau > self.model.max_staleness:
                plan.fold_drops.append(
                    (p.dispatch_round, p.model, p.device))
                st.expired += 1
                continue
            entries.setdefault(p.model, []).append(FoldEntry(
                model=p.model, device=p.device,
                dispatch_round=p.dispatch_round, staleness=tau,
                weight=p.weight * self.model.gamma ** tau))
            st.staleness_hist[tau] = st.staleness_hist.get(tau, 0) + 1
            st.folded += 1
        for m, es in entries.items():
            prior = self.mass.get(m, 0.0)
            plan.folds[m] = (prior, es)
            self.mass[m] = prior + sum(e.weight for e in es)

    def resolve(self, plan: RoundPlan, live: List[int]) -> None:
        st = self.stats
        st.rounds += 1
        self._fold_ready(plan, set(live))

        lat, dropped = self.model.resolve(plan.round, self.n_devices)
        b = len(plan.pair_model)
        st.dispatched += b
        arrival = [self.clock + float(lat[d]) for d in plan.pair_device]
        arriving = [k for k in range(b)
                    if not dropped[plan.pair_device[k]]]
        if arriving:
            quota = max(1, math.ceil(self.model.quorum * len(arriving)))
            deadline = sorted(arrival[k] for k in arriving)[quota - 1]
            plan.sync_time = max(arrival[k] for k in arriving) - self.clock
        else:
            deadline = self.clock
        for k in range(b):
            m, d = plan.pair_model[k], plan.pair_device[k]
            if dropped[d]:
                plan.dropped_pairs.append(k)
            elif arrival[k] > deadline:
                plan.straggler_pairs.append(k)
                self.pending.append(_Pending(
                    dispatch_round=plan.round, model=m, device=d,
                    weight=float(plan.scores[d, m]),
                    arrival=arrival[k]))
        st.dropouts += len(plan.dropped_pairs)
        st.stragglers += len(plan.straggler_pairs)
        st.ontime += b - len(plan.dropped_pairs) - len(plan.straggler_pairs)

        if plan.straggler_pairs or plan.dropped_pairs:
            # weight-zero the late/lost pairs on a COPY — ``scores`` is
            # shared control-plane state — and shrink the agg set to the
            # models that still have an on-time contribution (a model
            # with none keeps its params, like a model with no work)
            plan.scores = plan.scores.copy()
            for k in plan.straggler_pairs + plan.dropped_pairs:
                plan.scores[plan.pair_device[k], plan.pair_model[k]] = 0.0
            late = set(plan.straggler_pairs) | set(plan.dropped_pairs)
            with_ontime = {plan.pair_model[k] for k in range(b)
                           if k not in late}
            plan.agg_models = [m for m in plan.agg_models
                               if m in with_ontime]
        for m in plan.agg_models:
            # aggregation REPLACES the row: mass resets to this round's
            # on-time Σc (folds above already updated theirs — the
            # executor folds first, then aggregates, same order)
            pairs_m = [k for k in range(b) if plan.pair_model[k] == m]
            self.mass[m] = float(sum(
                plan.scores[plan.pair_device[k], m] for k in pairs_m))

        plan.round_time = deadline - self.clock
        st.t_semisync += plan.round_time
        st.t_sync += plan.sync_time
        self.clock = deadline
        plan.fold_next = any(p.arrival <= self.clock
                             for p in self.pending)


class RoundPlanner:
    """Builds :class:`RoundPlan`s from the score state + registry + one
    sampled cohort. Pure host bookkeeping; consumes no RNG.

    ``sparse_eval``: density crossover in [0, 1]. When set and the
    active (model, device) matrix over the stale rows is sparser than
    the crossover, the plan scores only holders' splits (one accuracy
    per active pair) instead of the dense (stale, N) matrix.

    ``straggler``: a :class:`~repro_torch.data.scenarios.StragglerModel`
    turns every plan semi-synchronous (quorum deadline, weight-zeroed
    late pairs, stale-update folds). ``n_devices``: the full device-id
    space (churn grows it past ``cfg.n_devices``)."""

    def __init__(self, cfg: FedCDConfig,
                 sparse_eval: Optional[float] = None,
                 straggler: Any = None, n_devices: Optional[int] = None):
        self.cfg = cfg
        self.sparse_eval = sparse_eval
        self.sparse_rounds = 0           # rounds planned holder-only
        self.semisync = (SemiSyncCoordinator(
            straggler, n_devices or cfg.n_devices)
            if straggler is not None else None)

    def on_clones(self, cloned: List[Tuple[int, int]]) -> None:
        if self.semisync is not None:
            self.semisync.on_clones(cloned)

    @staticmethod
    def _eval_sets(live: List[int], changed: Set[int],
                   hints: Optional[EvalHints]
                   ) -> Tuple[List[int], List[int]]:
        """Stale = params change this round (aggregation or stale-update
        fold) or never scored."""
        if hints is None:
            return list(live), []
        live_set = set(live)
        val_stale = [m for m in live
                     if m in changed or m not in hints.val_cached]
        test_needed = [m for m in hints.pred_rows if m in live_set]
        test_stale = [m for m in test_needed
                      if m in changed or m not in hints.test_cached]
        return val_stale, test_stale

    def _sparse_val(self, plan: RoundPlan, state: ScoreState) -> None:
        """Decide dense vs holder-only val scoring for the stale rows."""
        if self.sparse_eval is None or not plan.val_stale:
            return
        n = state.active.shape[0]
        active = sum(int(state.active[:, m].sum()) for m in plan.val_stale)
        density = active / (len(plan.val_stale) * n)
        if density >= self.sparse_eval:
            return
        plan.sparse_val = True
        self.sparse_rounds += 1
        for m in plan.val_stale:
            for d in np.nonzero(state.active[:, m])[0]:
                plan.val_pair_model.append(m)
                plan.val_pair_device.append(int(d))

    def build(self, t: int, sample: Tuple[np.ndarray, np.ndarray],
              scores: np.ndarray, state: ScoreState,
              registry: ModelRegistry,
              hints: Optional[EvalHints] = None,
              churn: Optional[Tuple[List[int], List[int]]] = None,
              churn_next: bool = False) -> RoundPlan:
        """``churn``: the (joined ids, left ids) applied at this round's
        start; ``churn_next``: whether round t+1 has scheduled device
        lifecycle events (read by the speculation guard)."""
        participating, perms = sample
        agg_models, pair_model, pair_device, transfers = gather_pairs(
            state, registry, participating)
        live = registry.live_ids()
        joins, leaves = churn if churn is not None else ([], [])
        plan = RoundPlan(
            round=t, participating=participating, perms=perms,
            scores=scores, live=live, agg_models=agg_models,
            pair_model=pair_model, pair_device=pair_device,
            transfers=transfers, val_stale=[], test_stale=[],
            clone_milestone=t in self.cfg.milestones,
            device_joins=list(joins), device_leaves=list(leaves),
            churn_next=churn_next)
        if self.semisync is not None:
            # may replace scores with a weight-zeroed copy, shrink the
            # agg set and attach folds — BEFORE eval staleness, which
            # keys on the set of models whose params change
            self.semisync.resolve(plan, live)
        plan.val_stale, plan.test_stale = self._eval_sets(
            live, set(plan.changed_models()), hints)
        self._sparse_val(plan, state)
        return plan

    def build_speculative(self, t: int,
                          sample: Tuple[np.ndarray, np.ndarray],
                          state: ScoreState, registry: ModelRegistry
                          ) -> RoundPlan:
        """Round ``t``'s TRAINING work order guessed from the
        pre-lifecycle state (the prefetched sample is exact; the pair
        set speculates that round t-1's readback deletes and clones
        nothing). Consumes no RNG. Only the pair fields are meaningful:
        weights, stale eval rows and transport are resolved against the
        true plan at dispatch."""
        participating, perms = sample
        agg_models, pair_model, pair_device, transfers = gather_pairs(
            state, registry, participating)
        return RoundPlan(
            round=t, participating=participating, perms=perms,
            scores=scores_like(state), live=[],
            agg_models=agg_models, pair_model=pair_model,
            pair_device=pair_device, transfers=transfers,
            val_stale=[], test_stale=[],
            clone_milestone=t in self.cfg.milestones, speculative=True)


def scores_like(state: ScoreState) -> np.ndarray:
    return np.zeros((state.history.shape[0], state.history.shape[1]),
                    np.float32)
