"""DeepSeek-V3 Multi-head Latent Attention (arXiv:2412.19437; port of
``repro/models/mla.py``).

Train/prefill: decompress the KV latent and run standard MHA over
(nope+rope)-dim keys and v_head_dim values, through the port's
``attention._naive_attention`` / ``_chunked_attention`` (which divide the
float32 scores by ``sqrt(nope + rope)``).

Cache paths: *absorbed* form — the KV up-projections are folded into the
query and output paths so the cache holds only the compressed latent
``c_kv (B, C, kv_lora_rank)`` plus the shared ``k_rope (B, C,
rope_dim)``. There the scores and the latent readout are float32
products (the reference's ``preferred_element_type=float32``: float32
operands here) and the scores are MULTIPLIED by ``1/sqrt(nope + rope)``,
as the reference's. A cache is a flat dict ``{"c_kv", "k_rope", "pos",
"index"}``; the scatters the reference drops out of bounds write to one
extra slot here, which is cut off (``attention.write_slots``).

On a tensor-parallel mesh (``mla_forward_mesh``) the heads split over
the model cells: ``wq_b`` / ``wk_b`` / ``wv_b`` are column pieces and
``wo`` a row piece, as GQA's; the latent projections (``wq_a``,
``wkv_a`` and their norms) are gathered and computed whole on each cell.
The absorbed cache paths split the same way on the mesh
(``transformer.lm_decode(mesh=...)``): each cell attends its heads to
the whole latent cache of its rows and writes the chunk's latents into
its own copy, so every cell of a data shard holds the same latents.
The reference's ``sharding_hints.constrain`` calls sit at its points.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.launch.tensor_parallel import (MeshRun, on_cell,
                                                splits_on)
from repro_torch.models.attention import (CHUNKED_THRESHOLD, NEG_INF,
                                          _chunked_attention,
                                          _naive_attention, rollback_keep,
                                          write_slots)
from repro_torch.models.common import (Params, apply_rope, init_rmsnorm,
                                       normal_init, prefixed, rmsnorm,
                                       subtree)
from repro_torch.sharding_hints import constrain


def init_mla(generator: torch.Generator, cfg: ArchConfig, dtype,
             device=None) -> Params:
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    p: Params = {
        "wq_a": normal_init(generator, (d, m.q_lora_rank), dtype,
                            device=device),
        "wq_b": normal_init(generator, (m.q_lora_rank, H * qk), dtype,
                            device=device),
        "wkv_a": normal_init(generator,
                             (d, m.kv_lora_rank + m.qk_rope_dim), dtype,
                             device=device),
        "wk_b": normal_init(generator, (m.kv_lora_rank, H * m.qk_nope_dim),
                            dtype, device=device),
        "wv_b": normal_init(generator, (m.kv_lora_rank, H * m.v_head_dim),
                            dtype, device=device),
        "wo": normal_init(generator, (H * m.v_head_dim, d), dtype,
                          device=device),
        **prefixed("q_norm", init_rmsnorm(m.q_lora_rank, dtype, device)),
        **prefixed("kv_norm", init_rmsnorm(m.kv_lora_rank, dtype, device)),
    }
    return dict(sorted(p.items()))


def _queries(params: Params, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (q_nope (B,S,H,nope), q_rope (B,S,H,rope))."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    cq = rmsnorm(subtree(params, "q_norm"), torch.matmul(x, params["wq_a"]),
                 cfg.norm_eps)
    q = torch.matmul(cq, params["wq_b"]).reshape(
        B, S, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    q_nope = constrain(q_nope, ("dp", None, "tp", None))
    q_rope = constrain(q_rope, ("dp", None, "tp", None))
    return q_nope, q_rope


def _latents(params: Params, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (c_kv (B,S,r) normalized, k_rope (B,S,1,rope) roped)."""
    m = cfg.mla
    kv = torch.matmul(x, params["wkv_a"])
    c_kv = rmsnorm(subtree(params, "kv_norm"), kv[..., :m.kv_lora_rank],
                   cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]  # single shared head
    return c_kv, apply_rope(k_rope, positions, cfg.rope_theta)


def mla_forward(params: Params, cfg: ArchConfig, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(params, cfg, x, positions)
    c_kv, k_rope = _latents(params, cfg, x, positions)
    k_nope = torch.matmul(c_kv, params["wk_b"]).reshape(
        B, S, H, m.qk_nope_dim)
    v = torch.matmul(c_kv, params["wv_b"]).reshape(B, S, H, m.v_head_dim)
    k_nope = constrain(k_nope, ("dp", None, "tp", None))
    v = constrain(v, ("dp", None, "tp", None))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    attn = _chunked_attention if S > CHUNKED_THRESHOLD else _naive_attention
    out = attn(q, k, v, positions, positions, cfg.sliding_window)
    return torch.matmul(out.reshape(B, S, H * m.v_head_dim), params["wo"])


MLA_HEAD_SPLIT = ("wk_b", "wo", "wq_b", "wv_b")


def mla_splits(params, cfg: ArchConfig, tp: int) -> bool:
    """Whether the heads split over ``tp`` model cells (module
    docstring)."""
    return (all(splits_on(params[k], 1) for k in ("wk_b", "wq_b", "wv_b"))
            and splits_on(params["wo"], 0) and cfg.n_heads % tp == 0)


def mla_per_cell(cfg: ArchConfig, tp: int) -> ArchConfig:
    """``cfg`` with one cell's share of the heads."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp)


def mla_forward_mesh(params, cfg: ArchConfig, x: torch.Tensor,
                     positions: Optional[torch.Tensor], run: MeshRun,
                     sd: int) -> torch.Tensor:
    """:func:`mla_forward` of data shard ``sd``'s rows ``x`` with the
    heads split over the model cells (module docstring)."""
    tp = run.tp
    if not mla_splits(params, cfg, tp):
        return mla_forward(run.whole(params, sd), cfg, x, positions)
    sub = mla_per_cell(cfg, tp)
    parts = []
    for sm in range(tp):
        dev = run.device(sm, sd)
        with on_cell(sm, sd):
            pos = None if positions is None else positions.to(dev)
            parts.append(mla_forward(
                run.cell(params, sm, sd, MLA_HEAD_SPLIT), sub, x.to(dev),
                pos))
    return run.reduce(parts, sd)


# ---------------------------------------------------------------------------
# Latent cache (absorbed form)
# ---------------------------------------------------------------------------
def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   window: int = 0, device=None) -> Params:
    m = cfg.mla
    C = min(max_len, window) if window else max_len
    return {
        "c_kv": torch.zeros((batch, C, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
        "k_rope": torch.zeros((batch, C, m.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos": torch.full((C,), -1, dtype=torch.int32, device=device),
    }


def _scale(cfg: ArchConfig, device) -> torch.Tensor:
    """``1/sqrt(nope + rope)`` in float32 (the reference's multiplier)."""
    m = cfg.mla
    return 1.0 / torch.sqrt(torch.full(
        (), float(m.qk_nope_dim + m.qk_rope_dim), device=device))


def _absorbed(params: Params, cfg: ArchConfig, q_nope, q_rope, ckv_all,
              krope_all, valid, out_dtype) -> torch.Tensor:
    """Attend the queries (B,S,H,·) to the latents (B,T,·) under
    ``valid`` (S,T) and project out: (B,S,d)."""
    m, H = cfg.mla, cfg.n_heads
    B, S = q_nope.shape[:2]
    wk_b = params["wk_b"].reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    q_eff = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)
    s_nope = torch.einsum("bshr,btr->bhst", q_eff.float(), ckv_all.float())
    s_rope = torch.einsum("bshe,bte->bhst", q_rope.float(),
                          krope_all.float())
    scores = (s_nope + s_rope) * _scale(cfg, q_nope.device)
    scores = torch.where(valid[None, None], scores,
                         torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bhst,btr->bshr", probs,
                       ckv_all.float()).to(out_dtype)
    wv_b = params["wv_b"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", lat, wv_b)
    return torch.matmul(out.reshape(B, S, H * m.v_head_dim), params["wo"])


def mla_prefill(params: Params, cfg: ArchConfig, x: torch.Tensor,
                cache: Params, window: int = 0,
                n_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
    """Absorbed multi-token cache-filling prefill. x (B,S,d).

    Attends each chunk token to [cache, chunk] before the chunk is
    scattered into the cache (scatter-then-attend is wrong under a ring
    buffer); ``n_valid`` tokens of the chunk are real, the padded tail is
    neither attended to nor written."""
    B, S, _ = x.shape
    dev = x.device
    idx = cache["index"]
    offs = torch.arange(S, dtype=torch.int32, device=dev)
    positions = idx + offs
    n_adv = torch.as_tensor(S if n_valid is None else n_valid,
                            dtype=torch.int32, device=dev)
    real = offs < n_adv
    q_nope, q_rope = _queries(params, cfg, x, positions)      # (B,S,H,·)
    c_kv, k_rope = _latents(params, cfg, x, positions)        # (B,S,r),(B,S,1,e)
    C = cache["c_kv"].shape[1]
    ckv_all = torch.cat([cache["c_kv"], c_kv], dim=1)
    krope_all = torch.cat([cache["k_rope"], k_rope[:, :, 0, :]], dim=1)
    pos_all = torch.cat([cache["pos"],
                         torch.where(real, positions, -1).to(torch.int32)])
    valid = (pos_all[None, :] >= 0) & (pos_all[None, :] <= positions[:, None])
    if window:
        valid = valid & (pos_all[None, :] > positions[:, None] - window)
    y = _absorbed(params, cfg, q_nope, q_rope, ckv_all, krope_all, valid,
                  x.dtype)
    slots = positions % C if window else positions
    slots = torch.where(real & (slots < C), slots, C)          # C: dropped
    return y, {"c_kv": write_slots(cache["c_kv"], slots, c_kv, 1),
               "index": idx + n_adv,
               "k_rope": write_slots(cache["k_rope"], slots,
                                     k_rope[:, :, 0, :], 1),
               "pos": write_slots(cache["pos"], slots, positions, 0)}


def mla_rollback(old: Params, full: Params, n_keep, S: int,
                 window: int = 0) -> Params:
    """Latent-cache analogue of the reference's
    ``attention.attention_rollback``: revert a verify chunk's rejected
    slots (bitwise equal to ``mla_prefill`` with ``n_valid=n_keep``).
    Leading stacked axes broadcast through."""
    keep, n_keep = rollback_keep(old["c_kv"].shape[-2], S, old["index"],
                                 n_keep, window)
    return {
        "c_kv": torch.where(keep[:, None], full["c_kv"], old["c_kv"]),
        "index": old["index"] + n_keep,
        "k_rope": torch.where(keep[:, None], full["k_rope"], old["k_rope"]),
        "pos": torch.where(keep, full["pos"], old["pos"]),
    }


def mla_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
               cache: Params, window: int = 0
               ) -> Tuple[torch.Tensor, Params]:
    """Absorbed one-token decode. x (B,1,d)."""
    idx = cache["index"]
    positions = idx[None].to(torch.int32)
    q_nope, q_rope = _queries(params, cfg, x, positions)      # (B,1,H,·)
    c_kv, k_rope = _latents(params, cfg, x, positions)        # (B,1,r),(B,1,1,e)
    C = cache["c_kv"].shape[1]
    slot = (idx % C if window else torch.clamp(idx, max=C - 1)).long()
    ckv_new = cache["c_kv"].index_copy(1, slot[None],
                                       c_kv.to(cache["c_kv"].dtype))
    krope_new = cache["k_rope"].index_copy(
        1, slot[None], k_rope[:, :, 0, :].to(cache["k_rope"].dtype))
    pos_new = cache["pos"].index_copy(0, slot[None], positions)
    valid = (pos_new >= 0) & (pos_new <= idx)
    if window:
        valid = valid & (pos_new > idx - window)
    y = _absorbed(params, cfg, q_nope, q_rope, ckv_new, krope_new,
                  valid[None], x.dtype)
    return y, {"c_kv": ckv_new, "index": idx + 1, "k_rope": krope_new,
               "pos": pos_new}
