"""FedCD cloning and deletion, paper Algorithm 1 + eq 4 (port of
``repro/core/lifecycle.py``; host-side numpy).

* eq 4 criterion ``max(c_i) - c_m_i >= σ(c_i)`` (population σ over the
  device's active-model scores), applied per device, but a device always
  keeps its top-2 models while it has ≥2 (the paper's stated invariant;
  the σ-rule alone does not preserve it).
* After round ``late_delete_round``: a device with exactly two active
  models drops the lower-scoring one if its score ≤ the threshold.
* Server GC: a model held by no device is deleted from the server.

Cloning at milestones: every live model is cloned; the clone's per-device
score is seeded to ``1 - c_parent`` (+ optional noise).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config import FedCDConfig
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.scores import (ScoreState, normalized_scores,
                                     seed_clone_history)


def eq4_deletion_mask(c: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Literal eq 4 per device: delete m where max(c) - c_m >= σ(c).

    c (N, M_cap) normalized scores; σ over active models only. Returns
    (N, M_cap) bool — True = delete. Devices with <3 active models are
    untouched here."""
    n_active = active.sum(axis=1)
    mask = np.zeros_like(active)
    for i in range(c.shape[0]):
        if n_active[i] < 3:
            continue
        ci = c[i, active[i]]
        sigma = ci.std()
        mx = ci.max()
        cand = active[i] & ((mx - c[i]) >= sigma) & (c[i] < mx)
        # stated invariant: keep top-2
        order = np.argsort(-np.where(active[i], c[i], -np.inf))
        cand[order[:2]] = False
        mask[i] = cand
    return mask


def late_deletion_mask(c: np.ndarray, active: np.ndarray,
                       threshold: float) -> np.ndarray:
    """Late rule: with exactly two active models, drop the lower one if
    its score ≤ threshold."""
    mask = np.zeros_like(active)
    two = active.sum(axis=1) == 2
    for i in np.nonzero(two)[0]:
        ids = np.nonzero(active[i])[0]
        lo = ids[np.argmin(c[i, ids])]
        hi = ids[np.argmax(c[i, ids])]
        if lo != hi and c[i, lo] <= threshold:
            mask[i, lo] = True
    return mask


def apply_deletions(state: ScoreState, registry: ModelRegistry,
                    round_: int, cfg: FedCDConfig
                    ) -> Tuple[ScoreState, List[int]]:
    """Run device-side deletions + server GC. Returns (state, killed ids)."""
    s = state.copy()
    c = normalized_scores(s)
    mask = eq4_deletion_mask(c, s.active)
    if round_ > cfg.late_delete_round:
        mask |= late_deletion_mask(c, s.active, cfg.late_delete_threshold)
    s.active &= ~mask
    s.history = np.where(s.active[:, :, None], s.history, np.nan)
    killed = []
    for m in registry.live_ids():
        if not s.active[:, m].any():
            registry.kill(m, round_)
            s.alive[m] = False
            killed.append(m)
    return s, killed


def clone_at_milestone(state: ScoreState, registry: ModelRegistry,
                       round_: int, cfg: FedCDConfig,
                       rng: Optional[np.random.Generator] = None,
                       clone_params_fn=lambda p: p
                       ) -> Tuple[ScoreState, List[Tuple[int, int]]]:
    """Clone every live model (Algorithm 1 milestone block).

    ``clone_params_fn`` maps parent params -> clone params (identity by
    default; quantize-then-dequantize when transport compression is on).
    ``rng`` drives the clone-score noise — the servers pass a dedicated
    lifecycle stream. Returns (state, [(parent, clone), ...])."""
    s = state.copy()
    pairs: List[Tuple[int, int]] = []
    for parent in registry.live_ids():
        clone = registry.clone(parent, round_,
                               clone_params_fn(registry.params[parent]))
        if clone is None:
            break   # at m_cap — the paper's exponential worst case is capped
        s = seed_clone_history(s, parent, clone, cfg.score_noise, rng)
        pairs.append((parent, clone))
    return s, pairs
