"""Decoder-only LM assembly for the attention families (port of the
training half of ``repro/models/transformer.py``: ``_init_block`` and
``_apply_block`` for ``ATTN_MLP``, ``ATTN_MOE``, ``MLA_MLP`` and
``MLA_MOE``, ``segments``, ``_stack_init``, ``init_lm``, ``lm_forward``
and ``mtp_logits`` for the non-hybrid layouts).

Layers are grouped into *segments* of identical block kind, and each
segment's params are STACKED along a leading layer axis, as the
reference's: ``segments.0.attn.wq`` has shape ``(n_layers, d, H*hd)``,
``segments.1.moe.w_gate`` ``(n_layers, E, d, f)``. Flat names are the
reference's pytree paths with ``.`` for ``/``, so the converter, the
param bank and the checkpoints map leaf to leaf. The reference scans a
segment with ``lax.scan``; here it is a Python loop over the layer axis,
each layer optionally recomputed in the backward pass (``remat``:
``torch.utils.checkpoint`` per layer). DeepSeek's MTP head (``mtp.*``)
is one block of the layout's last kind, not stacked.

A segment leaf may also be given as a sequence of per-layer tensors
(``launch.steps`` does so, to take one gradient per layer instead of a
stacked one). The Mamba2 / xLSTM blocks and the hybrid assembly are
ROADMAP item 13b.2, the encoder-decoder model 13b.3, a tensor-parallel
mesh 13b.4; the KV caches, prefill and decode are item 14.

API:
  init_lm(cfg, generator, device)            -> params
  lm_forward(cfg, params, tokens|embeds,...) -> (logits, hidden, aux)
  mtp_logits(cfg, params, hidden, next_tokens) -> logits
"""
from __future__ import annotations

from itertools import groupby
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import config as C
from repro_torch.config import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (Params, apply_mlp, canonical,
                                       dtype_of, embed, init_embedding,
                                       init_mlp, init_rmsnorm, normal_init,
                                       prefixed, rmsnorm, subtree, unembed)

Leaf = Union[torch.Tensor, Sequence[torch.Tensor]]

ATTENTION_KINDS = (C.ATTN_MLP, C.ATTN_MOE, C.MLA_MLP, C.MLA_MOE)
MESH_13B4 = "a tensor-parallel mesh is not ported yet (ROADMAP item 13b.4)"


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError unless ``cfg`` is a decoder-only stack of
    attention blocks (GQA or MLA, MLP or MoE; an MTP head allowed)."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid assembly is not ported yet (ROADMAP "
            "item 13b.2)")
    if cfg.family == "audio" or cfg.encdec.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model is not ported yet "
            "(ROADMAP item 13b.3)")
    kinds = sorted(set(cfg.layout()) - set(ATTENTION_KINDS))
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: block kind(s) {kinds} are not ported yet "
            "(ROADMAP item 13b.2)")


def param_dtype(cfg: ArchConfig, name: str) -> torch.dtype:
    """The dtype of leaf ``name`` of ``init_lm(cfg)``: a MoE router is
    float32 in every model, every other leaf the arch's param dtype."""
    if name.endswith("moe.router"):
        return torch.float32
    return dtype_of(cfg.param_dtype)


# ---------------------------------------------------------------------------
# Single-block init / apply
# ---------------------------------------------------------------------------
def _require_ported(kind: str) -> None:
    if kind not in ATTENTION_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP item 13b.2)")


def _init_block(generator: torch.Generator, cfg: ArchConfig, kind: str,
                dtype, device=None) -> Params:
    _require_ported(kind)
    d = cfg.d_model
    if kind in (C.MLA_MLP, C.MLA_MOE):
        a = mla_mod.init_mla(generator, cfg, dtype, device)
    else:
        a = attn.init_attention(generator, cfg, dtype, device)
    if kind in (C.ATTN_MOE, C.MLA_MOE):
        ffn = prefixed("moe", moe_mod.init_moe(generator, cfg, dtype,
                                               device))
    else:
        ff = (cfg.moe.dense_ff or cfg.d_ff) if kind == C.MLA_MLP else cfg.d_ff
        ffn = prefixed("mlp", init_mlp(generator, d, ff, dtype, device))
    return {**prefixed("attn", a), **ffn,
            **prefixed("norm1", init_rmsnorm(d, dtype, device)),
            **prefixed("norm2", init_rmsnorm(d, dtype, device))}


def _apply_block(params: Params, cfg: ArchConfig, kind: str,
                 x: torch.Tensor, positions: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block. Returns (x, aux_loss)."""
    _require_ported(kind)
    aux = torch.zeros((), device=x.device)
    h = rmsnorm(subtree(params, "norm1"), x, cfg.norm_eps)
    if kind in (C.MLA_MLP, C.MLA_MOE):
        a = mla_mod.mla_forward(subtree(params, "attn"), cfg, h, positions)
    else:
        a = attn.attention_forward(subtree(params, "attn"), cfg, h,
                                   positions)
    x = x + a
    h = rmsnorm(subtree(params, "norm2"), x, cfg.norm_eps)
    if kind in (C.ATTN_MOE, C.MLA_MOE):
        f, aux = moe_mod.apply_moe(subtree(params, "moe"), cfg, h)
    else:
        f = apply_mlp(subtree(params, "mlp"), h)
    return x + f, aux


# ---------------------------------------------------------------------------
# Segments (runs of identical layer kind -> one stacked param group each)
# ---------------------------------------------------------------------------
def segments(cfg: ArchConfig) -> List[Tuple[str, int]]:
    return [(k, len(list(g))) for k, g in groupby(cfg.layout())]


def _stack_init(generator: torch.Generator, n: int,
                init_one: Callable[[torch.Generator], Params]) -> Params:
    layers = [init_one(generator) for _ in range(n)]
    return {k: torch.stack([p[k] for p in layers]) for k in layers[0]}


# ---------------------------------------------------------------------------
# Top-level LM
# ---------------------------------------------------------------------------
def init_lm(cfg: ArchConfig, generator: torch.Generator,
            device: Optional[torch.device] = None) -> Params:
    """Random params of ``cfg`` (names, shapes and dtypes the
    reference's ``init_lm``; values drawn from ``generator``)."""
    check_supported(cfg)
    dtype = dtype_of(cfg.param_dtype)
    p: Params = prefixed("embed", init_embedding(
        generator, cfg.vocab_size, cfg.d_model, dtype, device))
    for i, (kind, n) in enumerate(segments(cfg)):
        p.update(prefixed(f"segments.{i}", _stack_init(
            generator, n,
            lambda g, kind=kind: _init_block(g, cfg, kind, dtype, device))))
    p.update(prefixed("final_norm", init_rmsnorm(cfg.d_model, dtype,
                                                 device)))
    if not cfg.tie_embeddings:
        p["lm_head"] = normal_init(generator, (cfg.d_model, cfg.vocab_size),
                                   dtype, device=device)
    if cfg.mtp:
        p["mtp.proj"] = normal_init(generator, (2 * cfg.d_model, cfg.d_model),
                                    dtype, device=device)
        p.update(prefixed("mtp.norm", init_rmsnorm(cfg.d_model, dtype,
                                                   device)))
        p.update(prefixed("mtp.block", _init_block(
            generator, cfg, cfg.layout()[-1], dtype, device)))
    return canonical(p)


def _layers(leaf: Leaf) -> Sequence[torch.Tensor]:
    return leaf.unbind(0) if isinstance(leaf, torch.Tensor) else leaf


def _scan_segment(stacked: Dict[str, Leaf], cfg: ArchConfig, kind: str,
                  x: torch.Tensor, positions, remat
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    per_layer = {k: _layers(v) for k, v in stacked.items()}
    n = len(next(iter(per_layer.values())))
    aux = torch.zeros((), device=x.device)
    for i in range(n):
        layer = {k: v[i] for k, v in per_layer.items()}

        def body(h, layer=layer):
            return _apply_block(layer, cfg, kind, h, positions)

        if remat:
            x, a = checkpoint(body, x, use_reentrant=False)
        else:
            x, a = body(x)
        aux = aux + a
    return x, aux


def _logits(cfg: ArchConfig, params: Params, h: torch.Tensor
            ) -> torch.Tensor:
    h = rmsnorm(subtree(params, "final_norm"), h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(subtree(params, "embed"), h)
    return torch.matmul(h.float(), params["lm_head"].float())


def lm_forward(cfg: ArchConfig, params: Dict[str, Leaf],
               tokens: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None,
               mesh=None, dp_axes: Tuple[str, ...] = ("data",),
               remat: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (logits float32, final_hidden, aux_loss)."""
    if mesh is not None:
        raise NotImplementedError(MESH_13B4)
    check_supported(cfg)
    x = embed(subtree(params, "embed"), tokens) if embeds is None else embeds
    x = x.to(dtype_of(cfg.compute_dtype))
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    aux = torch.zeros((), device=x.device)
    for i, (kind, _n) in enumerate(segments(cfg)):
        x, a = _scan_segment(subtree(params, f"segments.{i}"), cfg, kind, x,
                             positions, remat)
        aux = aux + a
    return _logits(cfg, params, x), x, aux


def mtp_logits(cfg: ArchConfig, params: Dict[str, Leaf],
               hidden: torch.Tensor, next_tokens: torch.Tensor, mesh=None,
               dp_axes: Tuple[str, ...] = ("data",)) -> torch.Tensor:
    """DeepSeek MTP depth-1 head: predict token t+2 from (h_t,
    emb(t+1)). The block's aux loss is discarded, as the reference's."""
    if mesh is not None:
        raise NotImplementedError(MESH_13B4)
    m = subtree(params, "mtp")
    e = embed(subtree(params, "embed"), next_tokens).to(hidden.dtype)
    h = torch.cat([rmsnorm(subtree(m, "norm"), hidden, cfg.norm_eps), e],
                  dim=-1)
    h = torch.matmul(h, m["proj"])
    h, _ = _apply_block(subtree(m, "block"), cfg, cfg.layout()[-1], h, None)
    return _logits(cfg, params, h)
