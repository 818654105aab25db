"""Frozen copies of the input generators the cells draw from the seed.

Copied from ``repro_torch/data/synthetic.py``, ``data/partition.py``
(the hierarchical partition, paper section 3.2) and
``federated/simulation.py`` (``make_perms``, ``draw_round_sample``), so
that a later change to the program cannot change what the benchmark
feeds it. Pure numpy: the same seed gives byte-identical arrays.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

N_CLASSES = 10
IMAGE = 32


def _class_template(label: int) -> np.ndarray:
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
    out = np.stack([_class_template(k) for k in range(N_CLASSES)])
    out.setflags(write=False)
    return out


def sample_images(rng: np.random.Generator, labels: np.ndarray,
                  noise: float) -> np.ndarray:
    t = class_templates()[labels]
    jitter = rng.normal(0, noise, t.shape).astype(np.float32)
    gain = rng.uniform(0.7, 1.3, (len(labels), 1, 1, 1)).astype(np.float32)
    return (t * gain + jitter).astype(np.float32)


def hierarchical_probs(archetype: int, bias: float) -> np.ndarray:
    meta = archetype // 5
    labels = np.arange(5) + 5 * meta
    p = np.zeros(N_CLASSES)
    p[labels] = (1.0 - bias) / 4.0
    p[archetype] = bias
    return p / p.sum()


def hierarchical_population(seed: int, devices_per_archetype: int,
                            bias_range: Tuple[float, float], n_train: int,
                            n_val: int, n_test: int, noise: float
                            ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """10 archetypes x ``devices_per_archetype`` devices, stacked:
    {"train": (xs (N, n, 32, 32, 3) float32, ys (N, n) int32), "val",
    "test"}."""
    rng = np.random.default_rng(seed)
    splits: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {
        "train": [], "val": [], "test": []}
    for a in range(N_CLASSES):
        for _ in range(devices_per_archetype):
            probs = hierarchical_probs(a, rng.uniform(*bias_range))
            for name, n in (("train", n_train), ("val", n_val),
                            ("test", n_test)):
                labels = rng.choice(N_CLASSES, size=n,
                                    p=probs).astype(np.int32)
                splits[name].append((sample_images(rng, labels, noise),
                                     labels))
    return {k: (np.stack([x for x, _ in v]), np.stack([y for _, y in v]))
            for k, v in splits.items()}


def make_perms(rng: np.random.Generator, n_devices: int, n_examples: int,
               batch_size: int, epochs: int) -> np.ndarray:
    """(N, epochs * steps, batch) minibatch indices of one round."""
    steps = max(n_examples // batch_size, 1)
    flat = np.broadcast_to(np.arange(n_examples, dtype=np.int32),
                           (n_devices * epochs, n_examples))
    perms = rng.permuted(flat, axis=1)
    perms = perms.reshape(n_devices, epochs, n_examples)
    return perms[:, :, :steps * batch_size].reshape(
        n_devices, epochs * steps, batch_size)


def draw_round_sample(rng: np.random.Generator, n_devices: int,
                      devices_per_round: int, n_examples: int,
                      batch_size: int, epochs: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One round's participation mask and minibatch indices: the k-th
    call on ``default_rng(seed)`` is round k's sample."""
    participating = np.zeros(n_devices, bool)
    participating[rng.choice(n_devices, devices_per_round,
                             replace=False)] = True
    return participating, make_perms(rng, n_devices, n_examples,
                                     batch_size, epochs)


def round_samples(seed: int, rounds: int, n_devices: int,
                  devices_per_round: int, n_examples: int, batch_size: int,
                  epochs: int) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Rounds 1..``rounds``' samples of a population whose sampling
    stream is ``default_rng(seed)`` (the FedCD and FedAvg servers draw
    one sample a round, and nothing else, from that stream)."""
    rng = np.random.default_rng(seed)
    return {t: draw_round_sample(rng, n_devices, devices_per_round,
                                 n_examples, batch_size, epochs)
            for t in range(1, rounds + 1)}
