"""Plain reference of the stages of a mode-A round (FedCD, paper
Algorithm 1, and FedAvg) for the CNN cells.

Written from the paper and the port's documented semantics, in plain
PyTorch and numpy: the 10-layer CNN (``F.conv2d``), eq 1 as a weighted
mean, the blockwise int8 transport round trip (128 values a block,
round half to even), per-device accuracies, eq 2-3 scores, eq 4 and the
late deletion rule, and milestone cloning. ``check_fl`` takes the
gradients by autograd and runs the stages in float64. It imports
nothing of the program and takes none of its kernels.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
LIFE_STREAM = 0xFEDCD
BLOCK = 128


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 off (the cells' precision), or TF32 on
    (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def cnn_forward(p: Params, x: torch.Tensor, channels: List[int]
                ) -> torch.Tensor:
    """x (B, 32, 32, 3) NHWC -> logits; conv kernels HWIO, dense (in,
    out), a 2x2 max pool after every second conv, the flatten in HWC
    order."""
    h = x.permute(0, 3, 1, 2)
    for i in range(len(channels)):
        h = F.relu(F.conv2d(h, p[f"conv.{i}"].permute(3, 2, 0, 1),
                            p[f"conv_b.{i}"], padding=1))
        if i % 2 == 1:
            h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ p["fc1"] + p["fc1_b"])
    return h @ p["fc2"] + p["fc2_b"]


def roundtrip(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Blockwise symmetric quantize-then-dequantize of a leaf flattened
    in memory order: s = max|block| / qmax, q = round(x / s)."""
    qmax = float((1 << (bits - 1)) - 1)
    flat = x.reshape(-1).float()
    n = flat.numel()
    pad = (-n) % BLOCK
    blocks = torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    s = torch.clamp(amax / torch.full_like(amax, qmax), min=1e-12)
    q = torch.clamp(torch.round(blocks / s), -qmax, qmax)
    return (q * s).reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def weighted_mean(trees: List[Params], w: np.ndarray) -> Params:
    """Eq 1: sum_k w_k theta_k / sum_k w_k, in the trees' dtype."""
    first = next(iter(trees[0].values()))
    wt = torch.as_tensor(np.asarray(w), dtype=first.dtype,
                         device=first.device)
    denom = torch.clamp(wt.sum(), min=1e-12)
    return {k: sum(wt[i] * t[k] for i, t in enumerate(trees)) / denom
            for k in trees[0]}


@torch.no_grad()
def accuracy_bounds(p: Params, xs: torch.Tensor, ys: torch.Tensor,
                    channels: List[int], tie: float, chunk: int = 4096
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, hi), each (N,): the share of argmax hits of one model on
    every device's split, where a prediction whose two largest logits
    lie within ``tie`` times the largest logit's magnitude may go either
    way (lo counts it as a miss, hi as a hit if the label is one of the
    two)."""
    n_dev, n = ys.shape
    flat_x = xs.reshape((n_dev * n,) + tuple(xs.shape[2:]))
    logits = torch.cat([cnn_forward(p, flat_x[i:i + chunk], channels)
                        for i in range(0, n_dev * n, chunk)])
    y = ys.reshape(-1).long()
    top2 = torch.topk(logits, 2, dim=-1)
    hit = torch.argmax(logits, -1) == y
    near = (top2.values[:, 0] - top2.values[:, 1]
            <= tie * top2.values[:, 0].abs().clamp(min=1e-12))
    in_two = (top2.indices == y[:, None]).any(-1)
    lo = (hit & ~near).double().reshape(n_dev, n).mean(dim=1)
    hi = (hit | (near & in_two)).double().reshape(n_dev, n).mean(dim=1)
    return lo.cpu().numpy(), hi.cpu().numpy()


# -- the control plane, eq 2-4 and cloning --------------------------------

@dataclass
class Scores:
    history: np.ndarray      # (N, M_cap, ell), NaN = empty
    active: np.ndarray       # (N, M_cap) bool
    alive: np.ndarray        # (M_cap,) bool

    def copy(self) -> "Scores":
        return Scores(self.history.copy(), self.active.copy(),
                      self.alive.copy())


def normalized(s: Scores) -> np.ndarray:
    filled = ~np.isnan(s.history)
    count = filled.sum(axis=2)
    total = np.where(filled, s.history, 0.0).sum(axis=2)
    raw = np.where(count > 0, total / np.maximum(count, 1), 1.0)
    raw = np.where(s.active, raw, 0.0)
    denom = raw.sum(axis=1, keepdims=True)
    return np.where(denom > 0, raw / np.maximum(denom, 1e-12), 0.0)


def push(s: Scores, accs: np.ndarray) -> Scores:
    out = s.copy()
    rolled = np.roll(out.history, -1, axis=2)
    rolled[:, :, -1] = accs
    out.history = np.where(out.active[:, :, None], rolled, out.history)
    return out


def deletions(s: Scores, t: int, late_round: int, late_threshold: float
              ) -> Tuple[Scores, List[int]]:
    """Eq 4 per device with three or more active models (keeping its top
    two), the late rule for devices with exactly two after
    ``late_round``, then every model that no device holds dies."""
    out = s.copy()
    c = normalized(s)
    drop = np.zeros_like(s.active)
    for i in range(c.shape[0]):
        act = s.active[i]
        k = int(act.sum())
        if k >= 3:
            ci = c[i, act]
            cand = act & ((ci.max() - c[i]) >= ci.std()) & (c[i] < ci.max())
            top = np.argsort(-np.where(act, c[i], -np.inf))[:2]
            cand[top] = False
            drop[i] = cand
        elif k == 2 and t > late_round:
            ids = np.nonzero(act)[0]
            lo, hi = ids[np.argmin(c[i, ids])], ids[np.argmax(c[i, ids])]
            if lo != hi and c[i, lo] <= late_threshold:
                drop[i, lo] = True
    out.active &= ~drop
    out.history = np.where(out.active[:, :, None], out.history, np.nan)
    killed = [m for m in np.nonzero(out.alive)[0]
              if not out.active[:, m].any()]
    out.alive[killed] = False
    return out, [int(m) for m in killed]


def clone_all(s: Scores, live: List[int], next_id: int, m_cap: int,
              noise: float, rng: np.random.Generator
              ) -> Tuple[Scores, List[Tuple[int, int]]]:
    """Every live model gets a clone (ids in order, up to ``m_cap``);
    the clone's score window on the parent's holders is seeded with
    1 - c_parent plus N(0, noise), clipped to [0, 1]."""
    out = s.copy()
    pairs = []
    for parent in live:
        if next_id >= m_cap:
            break
        c = normalized(out)
        val = 1.0 - c[:, parent]
        if noise:
            val = np.clip(val + rng.normal(0, noise, val.shape), 0.0, 1.0)
        holders = out.active[:, parent]
        out.history[:, next_id, :] = np.where(holders[:, None],
                                              val[:, None], np.nan)
        out.active[:, next_id] = holders
        out.alive[next_id] = True
        pairs.append((parent, next_id))
        next_id += 1
    return out, pairs


def life_rng(seed: int, clones_before: int, n_devices: int,
             noise: float) -> np.random.Generator:
    """The clone-noise stream, advanced past the clones of earlier
    milestones (one draw of N normals each)."""
    rng = np.random.default_rng([seed, LIFE_STREAM])
    if noise:
        for _ in range(clones_before):
            rng.normal(0, noise, n_devices)
    return rng


def preferred_test(params: Dict[int, Params], s: Scores, data,
                   channels: List[int], tie: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, hi) of each device's test accuracy on its highest-scoring
    active model (``accuracy_bounds``)."""
    c = normalized(s)
    pref = np.argmax(np.where(s.active, c, -1.0), axis=1)
    lo, hi = np.zeros(pref.shape[0]), np.zeros(pref.shape[0])
    xs, ys = data["test"]
    for m in np.unique(pref):
        rows = np.nonzero(pref == m)[0]
        if int(m) in params:
            idx = torch.as_tensor(rows, device=xs.device)
            lo[rows], hi[rows] = accuracy_bounds(params[int(m)], xs[idx],
                                                 ys[idx], channels, tie)
    return lo, hi
