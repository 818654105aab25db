"""Non-IID archetype partitioners (port of ``repro/data/partition.py``;
pure numpy, byte-identical arrays for a seed).

*Hierarchical* (paper §3.2): 2 meta-archetypes (labels 0-4 / 5-9) × 5
archetypes each. A device of archetype a with bias b has b·n examples of
label a and (1-b)/4·n of each other label in its meta-archetype;
b ~ Unif(0.6, 0.7) by default.

*Hypergeometric* (paper §3.3): 6 archetypes; archetype k's label
distribution is the HG(110, K_k, 10) pmf over the 10 labels, renormalized.

*Dirichlet(α)*: every device draws q ~ Dir(α · 1) (per-class
concentration α).
"""
from __future__ import annotations

from dataclasses import dataclass
from math import comb
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import N_CLASSES, sample_images

HG_N = 110
HG_KS = (5, 25, 45, 65, 85, 105)
HG_DRAWS = 10


@dataclass
class DeviceData:
    archetype: int
    train: Tuple[np.ndarray, np.ndarray]
    val: Tuple[np.ndarray, np.ndarray]
    test: Tuple[np.ndarray, np.ndarray]


def hierarchical_probs(archetype: int, bias: float) -> np.ndarray:
    """Label distribution for one archetype in the hierarchical setup."""
    meta = archetype // 5
    labels = np.arange(5) + 5 * meta
    p = np.zeros(N_CLASSES)
    p[labels] = (1.0 - bias) / 4.0
    p[archetype] = bias
    return p / p.sum()


def hypergeometric_probs(archetype: int) -> np.ndarray:
    """Paper Fig 3: HG(110, K_a, 10) pmf over the 10 labels, renormalized."""
    K = HG_KS[archetype]
    pmf = np.array([
        comb(K, x) * comb(HG_N - K, HG_DRAWS - x) / comb(HG_N, HG_DRAWS)
        if 0 <= x <= min(HG_DRAWS, K) and HG_DRAWS - x <= HG_N - K else 0.0
        for x in range(N_CLASSES)
    ])
    s = pmf.sum()
    if s <= 0:
        raise ValueError(f"archetype {archetype}: empty label distribution")
    return pmf / s


def make_device(rng: np.random.Generator, archetype: int, probs: np.ndarray,
                n_train: int, n_val: int, n_test: int,
                noise: float = 2.0) -> DeviceData:
    def split(n):
        labels = rng.choice(N_CLASSES, size=n, p=probs).astype(np.int32)
        return sample_images(rng, labels, noise=noise), labels
    return DeviceData(archetype, split(n_train), split(n_val), split(n_test))


def hierarchical_devices(seed: int = 0, devices_per_archetype: int = 3,
                         bias_range: Tuple[float, float] = (0.6, 0.7),
                         n_train: int = 512, n_val: int = 128,
                         n_test: int = 128, noise: float = 2.0,
                         bias: Optional[float] = None) -> List[DeviceData]:
    """30 devices: 3 per archetype × 10 archetypes (paper §3.2)."""
    rng = np.random.default_rng(seed)
    out = []
    for a in range(10):
        for _ in range(devices_per_archetype):
            b = bias if bias is not None else rng.uniform(*bias_range)
            out.append(make_device(rng, a, hierarchical_probs(a, b),
                                   n_train, n_val, n_test, noise))
    return out


def hypergeometric_devices(seed: int = 0, devices_per_archetype: int = 5,
                           n_train: int = 512, n_val: int = 128,
                           n_test: int = 128,
                           noise: float = 2.0) -> List[DeviceData]:
    """30 devices: 5 per archetype × 6 archetypes (paper §3.3)."""
    rng = np.random.default_rng(seed)
    out = []
    for a in range(len(HG_KS)):
        for _ in range(devices_per_archetype):
            out.append(make_device(rng, a, hypergeometric_probs(a),
                                   n_train, n_val, n_test, noise))
    return out


def dirichlet_probs(rng: np.random.Generator, alpha: float,
                    prior: Optional[np.ndarray] = None) -> np.ndarray:
    """One device's label distribution: q ~ Dir(α · p · N_CLASSES), i.e.
    per-class concentration α under the default uniform ``prior``."""
    p = (np.full(N_CLASSES, 1.0 / N_CLASSES) if prior is None
         else np.asarray(prior, float) / np.asarray(prior, float).sum())
    return rng.dirichlet(alpha * p * N_CLASSES)


def dirichlet_devices(seed: int = 0, n_devices: int = 30,
                      alpha: float = 0.5, n_train: int = 512,
                      n_val: int = 128, n_test: int = 128,
                      noise: float = 2.0) -> List[DeviceData]:
    """N devices, each with its own Dir(α)-drawn label marginal; a
    device's ``archetype`` records its modal label."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_devices):
        probs = dirichlet_probs(rng, alpha)
        out.append(make_device(rng, int(np.argmax(probs)), probs,
                               n_train, n_val, n_test, noise))
    return out


def stack_devices(devices: List[DeviceData]):
    """Stack per-device splits into (N, n, ...) arrays."""
    def stack(split_idx):
        xs = np.stack([getattr(d, split_idx)[0] for d in devices])
        ys = np.stack([getattr(d, split_idx)[1] for d in devices])
        return xs, ys
    return {k: stack(k) for k in ("train", "val", "test")}
