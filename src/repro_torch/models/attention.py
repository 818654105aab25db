"""GQA attention with qk-norm and sliding windows, full-sequence paths
(port of ``repro/models/attention.py:37-165``; the KV caches, prefill and
decode are the serving plane's and come with it).

Two execution paths, as the reference's:

* ``naive``   — materializes (S, T) scores; used for short sequences.
* ``chunked`` — online softmax over KV blocks of ``KV_BLOCK``, O(S *
  block) memory; selected above ``CHUNKED_THRESHOLD`` positions.

The math is the reference's in plain torch: float32 scores (products of
the compute-dtype q and k, taken in float32), an explicit causal/window
mask, float32 softmax, and the probabilities multiplied with float32 v
before the output is cast back. ``scaled_dot_product_attention`` is not
used: flash attention rounds the probabilities to bfloat16 before the PV
product, and the reference does not.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.models.common import (Params, apply_rope, init_rmsnorm,
                                       normal_init, prefixed, rmsnorm,
                                       subtree)

NEG_INF = -1e30
CHUNKED_THRESHOLD = 2048
KV_BLOCK = 1024


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def init_attention(generator: torch.Generator, cfg: ArchConfig, dtype,
                   device=None) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    p: Params = {
        "wk": normal_init(generator, (d, Kv * hd), dtype, device=device),
        "wo": normal_init(generator, (H * hd, d), dtype, device=device),
        "wq": normal_init(generator, (d, H * hd), dtype, device=device),
        "wv": normal_init(generator, (d, Kv * hd), dtype, device=device),
    }
    if cfg.qk_norm:
        p.update(prefixed("k_norm", init_rmsnorm(hd, dtype, device)))
        p.update(prefixed("q_norm", init_rmsnorm(hd, dtype, device)))
    return p


# ---------------------------------------------------------------------------
# Core math
# ---------------------------------------------------------------------------
def _project_qkv(params: Params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = torch.matmul(x, params["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = torch.matmul(x, params["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = torch.matmul(x, params["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(subtree(params, "q_norm"), q, cfg.norm_eps)
        k = rmsnorm(subtree(params, "k_norm"), k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def _inv_sqrt_divisor(hd: int, device) -> torch.Tensor:
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not IEEE division
    return torch.full((), math.sqrt(float(hd)), dtype=torch.float32,
                      device=device)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,hd), k (B,T,Kv,hd) -> float32 scores (B,Kv,G,S,T)."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qg = q.reshape(B, S, Kv, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    return s / _inv_sqrt_divisor(hd, q.device)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,Kv,G,S,T), v (B,T,Kv,hd) -> float32 (B,S,H,hd)."""
    B, Kv, G, S, _ = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, Kv * G, v.shape[-1])


def _naive_attention(q, k, v, q_positions, kv_positions, window: int
                     ) -> torch.Tensor:
    scores = _gqa_scores(q, k)
    mask = kv_positions[None, :] <= q_positions[:, None]
    if window:
        mask = mask & (kv_positions[None, :] > q_positions[:, None] - window)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v).to(v.dtype)


def _chunked_attention(q, k, v, q_positions, kv_positions, window: int,
                       kv_block: int = KV_BLOCK) -> torch.Tensor:
    """Online softmax over KV blocks. Memory O(S * kv_block) instead of
    O(S^2)."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    pad = (-T) % kv_block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-1)
    n_blocks = k.shape[1] // kv_block
    Kv = k.shape[2]
    G = H // Kv
    qg = q.reshape(B, S, Kv, G, hd).float()
    div = _inv_sqrt_divisor(hd, q.device)
    neg = torch.full((), NEG_INF, device=q.device)
    acc = torch.zeros((B, Kv, G, S, v.shape[-1]), device=q.device)
    m = torch.full((B, Kv, G, S), NEG_INF, device=q.device)
    denom = torch.zeros((B, Kv, G, S), device=q.device)
    for i in range(n_blocks):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        kb, vb, pb = k[:, blk], v[:, blk], kv_positions[blk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kb.float()) / div
        valid = (pb[None, :] <= q_positions[:, None]) & (pb[None, :] >= 0)
        if window:
            valid = valid & (pb[None, :] > q_positions[:, None] - window)
        s = torch.where(valid[None, None, None], s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        acc = acc * scale[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, vb.float())
        denom = denom * scale + torch.sum(p, dim=-1)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(
        B, S, H, v.shape[-1]).to(v.dtype)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------
def attention_forward(params: Params, cfg: ArchConfig, x: torch.Tensor,
                      positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Full-sequence (train/prefill) self-attention. x (B,S,d)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    if S > CHUNKED_THRESHOLD:
        out = _chunked_attention(q, k, v, positions, positions,
                                 cfg.sliding_window)
    else:
        out = _naive_attention(q, k, v, positions, positions,
                               cfg.sliding_window)
    B_, S_, H, hd = out.shape
    return torch.matmul(out.reshape(B_, S_, H * hd), params["wo"])
