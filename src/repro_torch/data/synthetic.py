"""Synthetic CIFAR-10-like dataset (port of ``repro/data/synthetic.py``;
pure numpy, byte-identical arrays for a seed).

Class-conditional images: each label is a distinct smooth spatial pattern
(mixture of per-class frequency/phase templates) plus noise. Shapes match
CIFAR-10: 32x32x3 (HWC), 10 classes.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np

N_CLASSES = 10
IMAGE = 32


def _class_template(label: int) -> np.ndarray:
    """Deterministic smooth template per class: a base pattern shared by
    all classes (so they are mutually confusable) plus a class-specific
    component."""
    base_rng = np.random.default_rng(999)
    r = np.random.default_rng(1234 + label)
    yy, xx = np.meshgrid(np.linspace(0, 1, IMAGE), np.linspace(0, 1, IMAGE),
                         indexing="ij")

    def field(rr, n, lo, hi):
        img = np.zeros((IMAGE, IMAGE, 3), np.float32)
        for c in range(3):
            for _ in range(n):
                fy, fx = rr.uniform(lo, hi, 2)
                ph = rr.uniform(0, 2 * np.pi)
                amp = rr.uniform(0.4, 1.0)
                img[..., c] += amp * np.sin(2 * np.pi * (fy * yy + fx * xx)
                                            + ph)
        return img

    shared = field(base_rng, 3, 1, 4)
    own = field(r, 3, 2, 8)
    img = 0.75 * shared + 0.45 * own
    return img / np.abs(img).max()


@lru_cache(maxsize=1)
def class_templates() -> np.ndarray:
    """(N_CLASSES, 32, 32, 3) templates; cached, never mutated."""
    out = np.stack([_class_template(k) for k in range(N_CLASSES)])
    out.setflags(write=False)
    return out


def sample_images(rng: np.random.Generator, labels: np.ndarray,
                  noise: float = 0.35) -> np.ndarray:
    t = class_templates()[labels]
    jitter = rng.normal(0, noise, t.shape).astype(np.float32)
    gain = rng.uniform(0.7, 1.3, (len(labels), 1, 1, 1)).astype(np.float32)
    return (t * gain + jitter).astype(np.float32)


def make_split(rng: np.random.Generator, n: int,
               label_probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    labels = rng.choice(N_CLASSES, size=n, p=label_probs).astype(np.int32)
    return sample_images(rng, labels), labels


def make_global_dataset(seed: int = 0, scale: float = 1.0
                        ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """CIFAR-10-shaped global splits (paper 3.1: 40k/10k/10k)."""
    rng = np.random.default_rng(seed)
    uniform = np.full(N_CLASSES, 1.0 / N_CLASSES)
    return {
        "train": make_split(rng, int(40_000 * scale), uniform),
        "val": make_split(rng, int(10_000 * scale), uniform),
        "test": make_split(rng, int(10_000 * scale), uniform),
    }
