"""FedCD model scoring, paper eq 2-3 (port of ``repro/core/scores.py``;
host-side numpy).

Per device ``i`` and model ``m``, the raw score is the mean of the last
``ℓ`` rounds' validation accuracies (eq 2); the reported score ``c`` is
normalized over the device's *active* models (eq 3).

State arrays:
  history   (N, M_cap, ℓ)  rolling validation accuracies, NaN = unfilled
  active    (N, M_cap)     device i currently holds model m
  alive     (M_cap,)       model exists on the central server
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ScoreState:
    history: np.ndarray          # (N, M_cap, ell) float64, NaN = empty
    active: np.ndarray           # (N, M_cap) bool
    alive: np.ndarray            # (M_cap,) bool
    ell: int

    @property
    def n_devices(self) -> int:
        return self.history.shape[0]

    @property
    def m_cap(self) -> int:
        return self.history.shape[1]

    def copy(self) -> "ScoreState":
        return ScoreState(self.history.copy(), self.active.copy(),
                          self.alive.copy(), self.ell)


def init_scores(n_devices: int, m_cap: int, ell: int = 3) -> ScoreState:
    history = np.full((n_devices, m_cap, ell), np.nan)
    active = np.zeros((n_devices, m_cap), bool)
    alive = np.zeros((m_cap,), bool)
    active[:, 0] = True   # "Initialize all scores c = 1" — one global model
    alive[0] = True
    return ScoreState(history, active, alive, ell)


def push_accuracies(state: ScoreState, accs: np.ndarray,
                    device_mask: Optional[np.ndarray] = None) -> ScoreState:
    """Shift in this round's validation accuracies (eq 2 window).

    accs (N, M_cap); entries for inactive models are ignored. With
    ``device_mask`` only those devices update their history."""
    s = state.copy()
    upd = s.active.copy()
    if device_mask is not None:
        upd &= device_mask[:, None]
    rolled = np.roll(s.history, -1, axis=2)
    rolled[:, :, -1] = accs
    s.history = np.where(upd[:, :, None], rolled, s.history)
    return s


def raw_scores(state: ScoreState) -> np.ndarray:
    """eq 2: s_m_i = mean of filled history (1.0 where nothing filled yet,
    matching the paper's init of all scores to 1)."""
    filled = ~np.isnan(state.history)
    count = filled.sum(axis=2)
    total = np.where(filled, state.history, 0.0).sum(axis=2)
    s = np.where(count > 0, total / np.maximum(count, 1), 1.0)
    return np.where(state.active, s, 0.0)


def normalized_scores(state: ScoreState) -> np.ndarray:
    """eq 3: c_m_i = s_m_i / Σ_m' s_m'_i over the device's active models."""
    s = raw_scores(state)
    denom = s.sum(axis=1, keepdims=True)
    return np.where(denom > 0, s / np.maximum(denom, 1e-12), 0.0)


def seed_clone_history(state: ScoreState, parent: int, clone: int,
                       noise: float = 0.0,
                       rng: Optional[np.random.Generator] = None
                       ) -> ScoreState:
    """A clone receives score 1 - c_parent per device, 'with some
    randomization': its rolling window is seeded with that value so eq 2
    reproduces it next round and it self-corrects within ℓ rounds."""
    s = state.copy()
    c = normalized_scores(state)
    val = 1.0 - c[:, parent]
    if noise and rng is not None:
        val = np.clip(val + rng.normal(0, noise, val.shape), 0.0, 1.0)
    holders = state.active[:, parent]
    s.history[:, clone, :] = np.where(holders[:, None], val[:, None], np.nan)
    s.active[:, clone] = holders
    s.alive[clone] = True
    return s
