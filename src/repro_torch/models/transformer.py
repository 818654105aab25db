"""Decoder-only LM assembly for the dense GQA family (port of the
training half of ``repro/models/transformer.py``: ``_init_block`` and
``_apply_block`` for ``ATTN_MLP``, ``segments``, ``_stack_init``,
``init_lm`` and ``lm_forward`` for the non-hybrid layouts).

Layers are grouped into *segments* of identical block kind, and each
segment's params are STACKED along a leading layer axis, as the
reference's: ``segments.0.attn.wq`` has shape ``(n_layers, d, H*hd)``.
Flat names are the reference's pytree paths with ``.`` for ``/``, so
the converter, the param bank and the checkpoints map leaf to leaf. The
reference scans a segment with ``lax.scan``; here it is a Python loop
over the layer axis, each layer optionally recomputed in the backward
pass (``remat``: ``torch.utils.checkpoint`` per layer).

A segment leaf may also be given as a sequence of per-layer tensors
(``launch.steps`` does so, to take one gradient per layer instead of a
stacked one). Block kinds other than ``ATTN_MLP`` (MLA, MoE, Mamba2,
xLSTM), the hybrid and encoder-decoder assemblies and the MTP head are
ROADMAP item 13b; the KV caches, prefill and decode are item 14.

API:
  init_lm(cfg, generator, device)            -> params
  lm_forward(cfg, params, tokens|embeds,...) -> (logits, hidden, aux)
"""
from __future__ import annotations

from itertools import groupby
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import config as C
from repro_torch.config import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (Params, apply_mlp, dtype_of, embed,
                                       init_embedding, init_mlp,
                                       init_rmsnorm, normal_init, prefixed,
                                       rmsnorm, subtree, unembed)

Leaf = Union[torch.Tensor, Sequence[torch.Tensor]]

ITEM_13B = ("is not ported yet (ROADMAP item 13b: MLA, MoE, Mamba2, "
            "xLSTM, encoder-decoder and hybrid assemblies, the MTP head)")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError unless ``cfg`` is a dense GQA
    (``ATTN_MLP``) decoder-only stack without an MTP head."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid assembly {ITEM_13B}")
    if cfg.family == "audio" or cfg.encdec.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model {ITEM_13B}")
    if cfg.mtp:
        raise NotImplementedError(f"{cfg.name}: the MTP head {ITEM_13B}")
    kinds = sorted(set(cfg.layout()) - {C.ATTN_MLP})
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: block kind(s) {kinds} {ITEM_13B}")


def canonical(params: Params) -> Params:
    """``params`` in the reference's pytree leaf order (dict keys sorted,
    list items by index)."""
    def key(name: str):
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                     for p in name.split("."))
    return {k: params[k] for k in sorted(params, key=key)}


# ---------------------------------------------------------------------------
# Single-block init / apply
# ---------------------------------------------------------------------------
def _init_block(generator: torch.Generator, cfg: ArchConfig, kind: str,
                dtype, device=None) -> Params:
    d = cfg.d_model
    if kind == C.ATTN_MLP:
        return {**prefixed("norm1", init_rmsnorm(d, dtype, device)),
                **prefixed("attn", attn.init_attention(generator, cfg, dtype,
                                                       device)),
                **prefixed("norm2", init_rmsnorm(d, dtype, device)),
                **prefixed("mlp", init_mlp(generator, d, cfg.d_ff, dtype,
                                           device))}
    raise NotImplementedError(f"block kind {kind!r} {ITEM_13B}")


def _apply_block(params: Params, cfg: ArchConfig, kind: str,
                 x: torch.Tensor, positions: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block. Returns (x, aux_loss)."""
    if kind != C.ATTN_MLP:
        raise NotImplementedError(f"block kind {kind!r} {ITEM_13B}")
    aux = torch.zeros((), device=x.device)
    h = rmsnorm(subtree(params, "norm1"), x, cfg.norm_eps)
    x = x + attn.attention_forward(subtree(params, "attn"), cfg, h,
                                   positions)
    h = rmsnorm(subtree(params, "norm2"), x, cfg.norm_eps)
    return x + apply_mlp(subtree(params, "mlp"), h), aux


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
        raise NotImplementedError(
            "a tensor-parallel mesh is not ported yet (ROADMAP item 13b)")
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
