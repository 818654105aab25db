"""Whisper-style encoder–decoder backbone (arXiv:2212.04356; port of
``repro/models/encdec.py``, whole).

The conv/mel frontend is a STUB (``frontends.py``): the encoder consumes
pre-computed frame embeddings (B, source_len, d_model). As the
reference's, self-attention takes RoPE in place of Whisper's absolute
position embeddings, so the backbone shares the decoder-only machinery.

Params, the reference's tree flattened: ``enc_blocks.*`` (n_enc, ...)
and ``dec_blocks.*`` (n_layers, ...) stacked, ``embed``, ``enc_norm``,
``final_norm`` and an untied ``lm_head``, every leaf in ``param_dtype``.
A stacked leaf may also be given as a sequence of per-layer tensors
(``launch.steps`` takes one gradient per layer). ``remat`` recomputes
each layer in the backward pass (``common.remat_call``: ``True`` /
``"full"`` or ``"dots"``), which the reference's ``encdec_forward``
does not take: it changes no value.

Decode: a self-attention KV cache (``self.*``, stacked per layer, the
layout of ``attention.init_kv_cache``) and the cross-attention K/V
computed once from the encoder output (``cross.k`` / ``cross.v``,
``(n_layers, B, source_len, Kv, hd)``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.common import (Params, apply_mlp, canonical,
                                       dtype_of, embed, init_embedding,
                                       init_mlp, init_rmsnorm, normal_init,
                                       prefixed, remat_call, rmsnorm,
                                       subtree)


def _cross_attention(params: Params, cfg: ArchConfig, x: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q from x (B,S,d); precomputed k/v (B,T,Kv,hd). Bidirectional."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = torch.matmul(x, params["wq"]).reshape(B, S, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(subtree(params, "q_norm"), q, cfg.norm_eps)
    probs = torch.softmax(attn._gqa_scores(q, k), dim=-1)
    out = attn._gqa_out(probs, v).to(x.dtype)
    return torch.matmul(out.reshape(B, S, cfg.n_heads * hd), params["wo"])


def _cross_kv(params: Params, cfg: ArchConfig, enc: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, _ = enc.shape
    hd = cfg.resolved_head_dim()
    k = torch.matmul(enc, params["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = torch.matmul(enc, params["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rmsnorm(subtree(params, "k_norm"), k, cfg.norm_eps)
    return k, v


def _init_enc_block(generator: torch.Generator, cfg: ArchConfig, dtype,
                    device=None) -> Params:
    d = cfg.d_model
    return {**prefixed("attn", attn.init_attention(generator, cfg, dtype,
                                                   device)),
            **prefixed("mlp", init_mlp(generator, d, cfg.d_ff, dtype,
                                       device)),
            **prefixed("norm1", init_rmsnorm(d, dtype, device)),
            **prefixed("norm2", init_rmsnorm(d, dtype, device))}


def _init_dec_block(generator: torch.Generator, cfg: ArchConfig, dtype,
                    device=None) -> Params:
    d = cfg.d_model
    return {**prefixed("cross_attn", attn.init_attention(generator, cfg,
                                                         dtype, device)),
            **prefixed("mlp", init_mlp(generator, d, cfg.d_ff, dtype,
                                       device)),
            **prefixed("norm1", init_rmsnorm(d, dtype, device)),
            **prefixed("norm2", init_rmsnorm(d, dtype, device)),
            **prefixed("norm_x", init_rmsnorm(d, dtype, device)),
            **prefixed("self_attn", attn.init_attention(generator, cfg,
                                                        dtype, device))}


def init_encdec(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random params of ``cfg`` (names, shapes and dtypes the
    reference's ``init_encdec``; values drawn from ``generator``)."""
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    p: Params = prefixed("embed", init_embedding(generator, cfg.vocab_size,
                                                 d, dtype, device))
    p.update(prefixed("enc_blocks", tf._stack_init(
        generator, cfg.encdec.n_enc_layers,
        lambda g: _init_enc_block(g, cfg, dtype, device))))
    p.update(prefixed("enc_norm", init_rmsnorm(d, dtype, device)))
    p.update(prefixed("dec_blocks", tf._stack_init(
        generator, cfg.n_layers,
        lambda g: _init_dec_block(g, cfg, dtype, device))))
    p.update(prefixed("final_norm", init_rmsnorm(d, dtype, device)))
    if not cfg.tie_embeddings:
        p["lm_head"] = normal_init(generator, (d, cfg.vocab_size), dtype,
                                   device=device)
    return canonical(p)


def _bidir_attention(params: Params, cfg: ArchConfig, x: torch.Tensor
                     ) -> torch.Tensor:
    """Encoder self-attention (RoPE, no mask)."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = attn._project_qkv(params, cfg, x, positions)
    probs = torch.softmax(attn._gqa_scores(q, k), dim=-1)
    out = attn._gqa_out(probs, v).to(x.dtype)
    H, hd = out.shape[2], out.shape[3]
    return torch.matmul(out.reshape(B, S, H * hd), params["wo"])


def _run(layers, body, x: torch.Tensor, remat) -> torch.Tensor:
    for layer in layers:
        x = remat_call(body, remat, layer, x)
    return x


def encode(cfg: ArchConfig, params: Dict[str, tf.Leaf], frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frames (B, source_len, d_model) from the stub frontend."""
    eps = cfg.norm_eps

    def body(bp, x):
        x = x + _bidir_attention(subtree(bp, "attn"), cfg,
                                 rmsnorm(subtree(bp, "norm1"), x, eps))
        return x + apply_mlp(subtree(bp, "mlp"),
                             rmsnorm(subtree(bp, "norm2"), x, eps))

    x = frames.to(dtype_of(cfg.compute_dtype))
    x = _run(tf.layer_params(subtree(params, "enc_blocks")), body, x, remat)
    return rmsnorm(subtree(params, "enc_norm"), x, eps)


def encdec_forward(cfg: ArchConfig, params: Dict[str, tf.Leaf],
                   frames: torch.Tensor, tokens: torch.Tensor,
                   remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decode over the full target. Returns (logits
    float32, hidden)."""
    eps = cfg.norm_eps
    enc = encode(cfg, params, frames, remat)
    x = embed(subtree(params, "embed"), tokens).to(
        dtype_of(cfg.compute_dtype))
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)

    def body(bp, x):
        x = x + attn.attention_forward(
            subtree(bp, "self_attn"), cfg,
            rmsnorm(subtree(bp, "norm1"), x, eps), positions)
        ca = subtree(bp, "cross_attn")
        k, v = _cross_kv(ca, cfg, enc)
        x = x + _cross_attention(ca, cfg,
                                 rmsnorm(subtree(bp, "norm_x"), x, eps), k, v)
        return x + apply_mlp(subtree(bp, "mlp"),
                             rmsnorm(subtree(bp, "norm2"), x, eps))

    x = _run(tf.layer_params(subtree(params, "dec_blocks")), body, x, remat)
    return tf._logits(cfg, params, x), x


def init_encdec_caches(cfg: ArchConfig, params: Params,
                       frames: torch.Tensor, max_len: int,
                       window: int = 0) -> Params:
    """Decode caches: the self-attention KV cache and the cross K/V of
    every decoder layer."""
    enc = encode(cfg, params, frames)
    cross = [dict(zip(("k", "v"), _cross_kv(subtree(bp, "cross_attn"),
                                           cfg, enc)))
             for bp in tf.layer_params(subtree(params, "dec_blocks"))]
    one = attn.init_kv_cache(cfg, frames.shape[0], max_len,
                             dtype_of(cfg.compute_dtype), window,
                             device=frames.device)
    self_cache = {k: v.expand((cfg.n_layers,) + v.shape).clone()
                  for k, v in one.items()}
    return canonical({**prefixed("cross", tf.stack_layers(cross)),
                      **prefixed("self", self_cache)})


def encdec_decode(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  caches: Params, window: int = 0
                  ) -> Tuple[torch.Tensor, Params]:
    """One decode step. tokens (B,1) -> (logits (B,1,V) float32,
    caches); the cross K/V pass through."""
    eps = cfg.norm_eps
    x = embed(subtree(params, "embed"), tokens).to(
        dtype_of(cfg.compute_dtype))
    self_c, cross = subtree(caches, "self"), subtree(caches, "cross")
    new_self = []
    for i, bp in enumerate(tf.layer_params(subtree(params, "dec_blocks"))):
        a, sc = attn.attention_decode(
            subtree(bp, "self_attn"), cfg,
            rmsnorm(subtree(bp, "norm1"), x, eps),
            {k: v[i] for k, v in self_c.items()}, window)
        new_self.append(sc)
        x = x + a
        x = x + _cross_attention(subtree(bp, "cross_attn"), cfg,
                                 rmsnorm(subtree(bp, "norm_x"), x, eps),
                                 cross["k"][i], cross["v"][i])
        x = x + apply_mlp(subtree(bp, "mlp"),
                          rmsnorm(subtree(bp, "norm2"), x, eps))
    return tf._logits(cfg, params, x), canonical(
        {**prefixed("cross", cross),
         **prefixed("self", tf.stack_layers(new_self))})
