"""GQA attention with qk-norm, sliding windows and ring-buffer KV caches
(port of ``repro/models/attention.py``, whole).

Three execution paths, as the reference's:

* ``naive``   — materializes (S, T) scores; used for short sequences.
* ``chunked`` — online softmax over KV blocks of ``KV_BLOCK``, O(S *
  block) memory; selected above ``CHUNKED_THRESHOLD`` positions.
* ``decode`` / ``prefill`` — one token, or a chunk of ``S`` tokens,
  against a (ring-buffer) cache.

Cache layout, the reference's: ``{"index": (), "k": (B, C, Kv, hd),
"pos": (C,) absolute position per slot (-1 = empty), "v": (B, C, Kv,
hd)}``, ``index`` and ``pos`` int32. For sliding-window decode, ``C ==
window`` and writes wrap. The reference drops a prefill's padded lanes
with a ``mode="drop"`` scatter; here every write goes to a cache grown
by one spare slot ``C``, which takes the dropped lanes and is cut off
after the write, so no index is ever out of range.

The math is the reference's in plain torch: float32 scores (products of
the compute-dtype q and k, taken in float32), an explicit causal/window
mask, float32 softmax, and the probabilities multiplied with float32 v
before the output is cast back. ``scaled_dot_product_attention`` is not
used: flash attention rounds the probabilities to bfloat16 before the PV
product, and the reference does not.

On a tensor-parallel mesh (``attention_forward_mesh``) the heads split
over the model cells: ``wq`` / ``wk`` / ``wv`` are column pieces, each
cell runs its own query and KV heads through the same float32 math, and
``wo`` is a row piece whose partial outputs are summed in cell order.
That needs the heads and the KV heads to divide over the cells; else the
block runs whole on the data shard's home cell. The cache paths
(``attention_prefill`` / ``attention_decode``) split the same way on the
mesh (``transformer.lm_decode(mesh=...)``): each cell runs them on its
share of the heads, against its own KV heads of the cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.launch.sharding import heads_split
from repro_torch.launch.tensor_parallel import (MeshRun, on_cell,
                                                splits_on)
from repro_torch.models.common import (Params, apply_rope, init_rmsnorm,
                                       normal_init, prefixed, rmsnorm,
                                       subtree)
from repro_torch.sharding_hints import constrain

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
    # keep heads on the model axis through the reshape
    q = constrain(q, ("dp", None, "tp", None))
    k = constrain(k, ("dp", None, "tp", None))
    v = constrain(v, ("dp", None, "tp", None))
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
# Public entry points
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


def heads_per_cell(cfg: ArchConfig, tp: int) -> ArchConfig:
    """``cfg`` with one cell's share of the heads (the head size kept)."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               head_dim=cfg.resolved_head_dim())


HEAD_SPLIT = ("wk", "wo", "wq", "wv")


def attention_splits(params, cfg: ArchConfig, tp: int) -> bool:
    """Whether the heads split over ``tp`` model cells: ``wq`` / ``wk``
    / ``wv`` column pieces, ``wo`` a row piece, and the heads and KV
    heads dividing."""
    return (all(splits_on(params[k], 1) for k in ("wq", "wk", "wv"))
            and splits_on(params["wo"], 0) and heads_split(cfg, tp))


def attention_forward_mesh(params, cfg: ArchConfig, x: torch.Tensor,
                           positions: Optional[torch.Tensor], run: MeshRun,
                           sd: int) -> torch.Tensor:
    """:func:`attention_forward` of data shard ``sd``'s rows ``x`` (on
    its home cell) with the heads split over the model cells (module
    docstring)."""
    tp = run.tp
    if not attention_splits(params, cfg, tp):
        return attention_forward(run.whole(params, sd), cfg, x, positions)
    sub = heads_per_cell(cfg, tp)
    parts = []
    for sm in range(tp):
        dev = run.device(sm, sd)
        with on_cell(sm, sd):
            pos = None if positions is None else positions.to(dev)
            parts.append(attention_forward(
                run.cell(params, sm, sd, HEAD_SPLIT), sub, x.to(dev), pos))
    return run.reduce(parts, sd)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  window: int = 0, device=None) -> Params:
    C = min(max_len, window) if window else max_len
    Kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    return {
        "index": torch.zeros((), dtype=torch.int32, device=device),
        "k": torch.zeros((batch, C, Kv, hd), dtype=dtype, device=device),
        "pos": torch.full((C,), -1, dtype=torch.int32, device=device),
        "v": torch.zeros((batch, C, Kv, hd), dtype=dtype, device=device),
    }


def write_slots(cache: torch.Tensor, slots: torch.Tensor,
                values: torch.Tensor, dim: int) -> torch.Tensor:
    """``cache`` with ``values`` written at ``slots`` along ``dim``, where
    a slot equal to ``cache.shape[dim]`` drops its lane (the reference's
    ``.at[slots].set(values, mode="drop")`` for slots ``<= C``). Out of
    place, so that it runs under ``torch.func.vmap`` with batched values
    and an unbatched ``cache``."""
    spare = cache.narrow(dim, 0, 1)
    grown = torch.cat([cache, spare], dim=dim).index_copy(
        dim, slots.long(), values.to(cache.dtype))
    return grown.narrow(dim, 0, cache.shape[dim])


def attention_prefill(params: Params, cfg: ArchConfig, x: torch.Tensor,
                      cache: Params, window: int = 0,
                      n_valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """Multi-token cache-filling prefill: append ``S`` tokens to the
    cache in ONE attended forward. x (B,S,d).

    The chunk attends to [cache slots, in-chunk keys] before the chunk is
    written (writing first would clobber, under a ring buffer, history
    slots an early query of the chunk still sees); requires ``S <= C``
    under a window. ``n_valid`` marks a right-padded chunk: tokens at
    offsets ``>= n_valid`` neither enter any query's view nor get written,
    and the index advances by ``n_valid`` only."""
    B, S, _ = x.shape
    dev = x.device
    idx = cache["index"]
    offs = torch.arange(S, dtype=torch.int32, device=dev)
    positions = idx + offs
    n_adv = torch.as_tensor(S if n_valid is None else n_valid,
                            dtype=torch.int32, device=dev)
    real = offs < n_adv
    q, k, v = _project_qkv(params, cfg, x, positions)
    C = cache["k"].shape[1]
    kv_pos = torch.cat([cache["pos"],
                        torch.where(real, positions, -1).to(torch.int32)])
    scores = _gqa_scores(q, torch.cat([cache["k"], k], dim=1))
    valid = (kv_pos[None, :] >= 0) & (kv_pos[None, :] <= positions[:, None])
    if window:
        valid = valid & (kv_pos[None, :] > positions[:, None] - window)
    scores = torch.where(valid[None, None, None], scores,
                         torch.full((), NEG_INF, device=dev))
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, torch.cat([cache["v"], v], dim=1)).to(x.dtype)
    H, hd = out.shape[2], out.shape[3]
    y = torch.matmul(out.reshape(B, S, H * hd), params["wo"])
    slots = positions % C if window else positions
    slots = torch.where(real & (slots < C), slots, C)   # C: dropped
    return y, {"index": idx + n_adv,
               "k": write_slots(cache["k"], slots, k, 1),
               "pos": write_slots(cache["pos"], slots, positions, 0),
               "v": write_slots(cache["v"], slots, v, 1)}


def rollback_keep(C: int, S: int, index: torch.Tensor, n_keep,
                  window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache slots a verify chunk of ``S`` tokens written from the
    (smallest) ``index`` keeps after ``n_keep`` accepted tokens, as a
    ``(C,)`` mask, and ``n_keep`` as an int32 tensor."""
    if S > C:
        raise ValueError(f"verify chunk {S} exceeds cache slots {C}")
    dev = index.device
    offs = torch.arange(S, dtype=torch.int32, device=dev)
    positions = torch.min(index).to(torch.int32) + offs
    slots = positions % C if window else positions
    slots = torch.where(slots < C, slots, C)
    n_keep = torch.as_tensor(n_keep, dtype=torch.int32, device=dev)
    keep = write_slots(torch.zeros((C,), dtype=torch.bool, device=dev),
                       slots, offs < n_keep, 0)
    return keep, n_keep


def attention_rollback(old: Params, full: Params, n_keep, S: int,
                       window: int = 0) -> Params:
    """Roll a speculative-verify chunk back to its first ``n_keep``
    tokens. ``full`` is the cache after ``attention_prefill`` of an
    ``S``-token chunk over ``old`` with ``n_valid=S``; the result is
    bitwise the cache the same prefill with ``n_valid=n_keep`` leaves
    (K/V do not depend on ``n_valid``, only the write mask and the index
    do). Rejected positions' slots revert to ``old``; leading stacked
    axes (layers, shared-attention sites) broadcast through."""
    keep, n_keep = rollback_keep(old["k"].shape[-3], S, old["index"],
                                 n_keep, window)
    return {
        "index": old["index"] + n_keep,
        "k": torch.where(keep[:, None, None], full["k"], old["k"]),
        "pos": torch.where(keep, full["pos"], old["pos"]),
        "v": torch.where(keep[:, None, None], full["v"], old["v"]),
    }


def attention_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                     cache: Params, window: int = 0
                     ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x (B,1,d); cache as from ``init_kv_cache``. The
    slot is ``index % C`` under a window, else ``min(index, C - 1)`` (the
    reference's clamped ``dynamic_update_slice``)."""
    B = x.shape[0]
    idx = cache["index"]
    positions = idx[None].to(torch.int32)
    q, k, v = _project_qkv(params, cfg, x, positions)
    C = cache["k"].shape[1]
    slot = (idx % C if window else torch.clamp(idx, max=C - 1)).long()[None]
    knew = cache["k"].index_copy(1, slot, k.to(cache["k"].dtype))
    vnew = cache["v"].index_copy(1, slot, v.to(cache["v"].dtype))
    pnew = cache["pos"].index_copy(0, slot, positions)
    scores = _gqa_scores(q, knew)                        # (B,Kv,G,1,C)
    valid = (pnew >= 0) & (pnew <= idx)
    if window:
        valid = valid & (pnew > idx - window)
    scores = torch.where(valid[None, None, None, None], scores,
                         torch.full((), NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, vnew).to(x.dtype)
    H, hd = out.shape[2], out.shape[3]
    y = torch.matmul(out.reshape(B, 1, H * hd), params["wo"])
    return y, {"index": idx + 1, "k": knew, "pos": pnew, "v": vnew}
