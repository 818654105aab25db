"""Host-side round planning: the control-plane half of a FedCD round
(port of ``repro/core/plan.py``, the dense synchronous part).

A :class:`RoundPlan` is everything the host decides about one round
before any device work is dispatched: the sampled cohort, the gathered
``(participating & holder)`` work pairs, which eval rows are stale, the
transport count, and the pending lifecycle intent (cloning on milestone
rounds). Plans reference models by id; with one bank shard the id is
the bank row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

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
    clone_milestone: bool = False    # pending lifecycle intent

    def pairs(self) -> List[Tuple[int, int]]:
        return list(zip(self.pair_model, self.pair_device))

    def changed_models(self) -> List[int]:
        """Models whose params change at this launch — the eval-cache
        staleness set."""
        return sorted(set(self.agg_models))


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


class RoundPlanner:
    """Builds :class:`RoundPlan`s from the score state + registry + one
    sampled cohort. Pure host bookkeeping; consumes no RNG."""

    def __init__(self, cfg: FedCDConfig):
        self.cfg = cfg

    @staticmethod
    def _eval_sets(live: List[int], changed: Set[int],
                   hints: Optional[EvalHints]
                   ) -> Tuple[List[int], List[int]]:
        """Stale = params change this round or never scored."""
        if hints is None:
            return list(live), []
        live_set = set(live)
        val_stale = [m for m in live
                     if m in changed or m not in hints.val_cached]
        test_needed = [m for m in hints.pred_rows if m in live_set]
        test_stale = [m for m in test_needed
                      if m in changed or m not in hints.test_cached]
        return val_stale, test_stale

    def build(self, t: int, sample: Tuple[np.ndarray, np.ndarray],
              scores: np.ndarray, state: ScoreState,
              registry: ModelRegistry,
              hints: Optional[EvalHints] = None) -> RoundPlan:
        participating, perms = sample
        agg_models, pair_model, pair_device, transfers = gather_pairs(
            state, registry, participating)
        live = registry.live_ids()
        plan = RoundPlan(
            round=t, participating=participating, perms=perms,
            scores=scores, live=live, agg_models=agg_models,
            pair_model=pair_model, pair_device=pair_device,
            transfers=transfers, val_stale=[], test_stale=[],
            clone_milestone=t in self.cfg.milestones)
        plan.val_stale, plan.test_stale = self._eval_sets(
            live, set(plan.changed_models()), hints)
        return plan
