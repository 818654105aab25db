"""Decoder-only LM assembly (port of the training half of
``repro/models/transformer.py``: ``_init_block`` and ``_apply_block``
for every decoder block kind — ``ATTN_MLP``, ``ATTN_MOE``, ``MLA_MLP``,
``MLA_MOE``, ``MAMBA2``, ``MLSTM``, ``SLSTM`` — ``segments``,
``_stack_init``, the Zamba2 shared block (``_init_shared_block``,
``_init_site_lora``, ``_shared_block_params``, the full-sequence branch
of ``_apply_shared_block``), ``init_lm``, ``lm_forward`` and
``mtp_logits``).

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

Zamba2's hybrid layout has its own assembly: ``mamba_groups.*`` stacks
``(n_sites, every, ...)`` Mamba2 blocks, ``mamba_tail.*`` ``(n_tail,
...)`` more; one ``shared.*`` attention+MLP block, not stacked, runs
after each site's group on ``concat(hidden, x0)`` (``x0`` the embedding
after the compute-dtype cast), with the site's LoRA deltas
(``lora.*``, ``(n_sites, ...)``) added to its weights. As the
reference's, the hybrid path takes no ``remat``.

A stacked leaf may also be given as a sequence of per-layer tensors
(``launch.steps`` does so, to take one gradient per layer instead of a
stacked one): ``mamba_groups.*`` as ``n_sites * every`` tensors in
memory order, the others one per row (``stacked_depth``). The
encoder-decoder model is ROADMAP item 13b.3, a tensor-parallel mesh
13b.4; the KV and recurrent caches, prefill and decode of the assembly
are item 14.

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
from repro_torch.models import mamba2 as mb
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.common import (Params, apply_mlp, canonical,
                                       dtype_of, embed, init_embedding,
                                       init_mlp, init_rmsnorm, normal_init,
                                       prefixed, rmsnorm, subtree, unembed)

Leaf = Union[torch.Tensor, Sequence[torch.Tensor]]

ATTENTION_KINDS = (C.ATTN_MLP, C.ATTN_MOE, C.MLA_MLP, C.MLA_MOE)
RECURRENT_KINDS = (C.MAMBA2, C.MLSTM, C.SLSTM)
MESH_13B4 = "a tensor-parallel mesh is not ported yet (ROADMAP item 13b.4)"
CACHE_14 = ("the shared block's KV cache and prefill are the serving "
            "plane's, not ported yet (ROADMAP item 14)")
# leaves that are float32 in every model (a bfloat16 one included)
FLOAT32_LEAVES = ("moe.router", "core.A_log", "core.D", "core.dt_bias",
                  "core.f_bias")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for the encoder-decoder model (ROADMAP
    item 13b.3); every decoder-only layout is ported."""
    if cfg.family == "audio" or cfg.encdec.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model is not ported yet "
            "(ROADMAP item 13b.3)")


def param_dtype(cfg: ArchConfig, name: str) -> torch.dtype:
    """The dtype of leaf ``name`` of ``init_lm(cfg)``: a MoE router,
    Mamba2's ``A_log`` / ``D`` / ``dt_bias`` and xLSTM's ``f_bias`` are
    float32 in every model, every other leaf the arch's param dtype."""
    if name.endswith(FLOAT32_LEAVES):
        return torch.float32
    return dtype_of(cfg.param_dtype)


def stacked_depth(name: str) -> int:
    """How many leading axes of leaf ``name`` of ``init_lm`` index
    layers: 2 for ``mamba_groups.*`` (site, layer), 1 for
    ``segments.*``, ``mamba_tail.*`` and ``lora.*`` (one row each), 0
    for a leaf used whole."""
    if name.startswith("mamba_groups."):
        return 2
    return int(name.startswith(("segments.", "mamba_tail.", "lora.")))


def layer_views(leaf: torch.Tensor, depth: int) -> List[torch.Tensor]:
    """A stacked leaf's per-layer VIEWS in memory order (writes to them
    write the leaf); ``[leaf]`` at depth 0."""
    if not depth:
        return [leaf]
    return list(leaf.view(-1, *leaf.shape[depth:]).unbind(0))


# ---------------------------------------------------------------------------
# Single-block init / apply
# ---------------------------------------------------------------------------
def _init_block(generator: torch.Generator, cfg: ArchConfig, kind: str,
                dtype, device=None) -> Params:
    d = cfg.d_model
    if kind in RECURRENT_KINDS:
        init_core = {C.MAMBA2: mb.init_mamba2, C.MLSTM: xl.init_mlstm,
                     C.SLSTM: xl.init_slstm}[kind]
        return {**prefixed("core", init_core(generator, cfg, dtype,
                                             device)),
                **prefixed("norm", init_rmsnorm(d, dtype, device))}
    if kind not in ATTENTION_KINDS:
        raise ValueError(kind)
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
    aux = torch.zeros((), device=x.device)
    if kind in RECURRENT_KINDS:
        forward = {C.MAMBA2: mb.mamba2_forward, C.MLSTM: xl.mlstm_forward,
                   C.SLSTM: xl.slstm_forward}[kind]
        h = rmsnorm(subtree(params, "norm"), x, cfg.norm_eps)
        return x + forward(subtree(params, "core"), cfg, h), aux
    if kind not in ATTENTION_KINDS:
        raise ValueError(kind)
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
# Zamba2-style shared attention block
# ---------------------------------------------------------------------------
def _init_shared_block(generator: torch.Generator, cfg: ArchConfig, dtype,
                       device=None) -> Params:
    d = cfg.d_model
    return {"w_concat": normal_init(generator, (2 * d, d), dtype,
                                    device=device),
            **prefixed("norm1", init_rmsnorm(d, dtype, device)),
            **prefixed("attn", attn.init_attention(generator, cfg, dtype,
                                                   device)),
            **prefixed("norm2", init_rmsnorm(d, dtype, device)),
            **prefixed("mlp", init_mlp(generator, d, cfg.d_ff, dtype,
                                       device))}


def _init_site_lora(generator: torch.Generator, cfg: ArchConfig, dtype,
                    device=None) -> Params:
    r = cfg.shared_attn_lora_rank
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim()

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"qa": normal_init(generator, (d, r), dtype, device=device),
            "qb": zeros((r, H * hd)),
            "oa": normal_init(generator, (H * hd, r), dtype, device=device),
            "ob": zeros((r, d)),
            "ca": normal_init(generator, (2 * d, r), dtype, device=device),
            "cb": zeros((r, d))}


def _shared_block_params(shared: Params, lora: Params) -> Params:
    """Materialize per-site weights = shared + LoRA deltas."""
    p = dict(shared)
    p["w_concat"] = shared["w_concat"] + lora["ca"] @ lora["cb"]
    p["attn.wq"] = shared["attn.wq"] + lora["qa"] @ lora["qb"]
    p["attn.wo"] = shared["attn.wo"] + lora["oa"] @ lora["ob"]
    return p


def _apply_shared_block(p: Params, cfg: ArchConfig, x: torch.Tensor,
                        x0: torch.Tensor, positions, cache=None, window=0,
                        prefill=False, n_valid=None):
    """Zamba2 shared block: concat(hidden, embeds) -> proj -> attn+mlp.
    Only the full-sequence branch is ported (``cache=None``)."""
    if cache is not None or prefill:
        raise NotImplementedError(CACHE_14)
    hcat = torch.cat([x, x0], dim=-1)
    h = torch.matmul(hcat, p["w_concat"])
    hn = rmsnorm(subtree(p, "norm1"), h, cfg.norm_eps)
    a = attn.attention_forward(subtree(p, "attn"), cfg, hn, positions)
    h = h + a
    f = apply_mlp(subtree(p, "mlp"), rmsnorm(subtree(p, "norm2"), h,
                                             cfg.norm_eps))
    return x + h + f, None


def hybrid_sites(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(sites, Mamba2 layers a site, tail layers) of a hybrid layout."""
    every = cfg.shared_attn_every
    n_sites = cfg.n_layers // every
    return n_sites, every, cfg.n_layers - n_sites * every


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

    def mamba(g):
        return _init_block(g, cfg, C.MAMBA2, dtype, device)

    if cfg.family == "hybrid":
        n_sites, every, n_tail = hybrid_sites(cfg)
        p.update(prefixed("mamba_groups", _stack_init(
            generator, n_sites,
            lambda g: _stack_init(g, every, mamba))))
        if n_tail:
            p.update(prefixed("mamba_tail", _stack_init(generator, n_tail,
                                                        mamba)))
        p.update(prefixed("shared", _init_shared_block(generator, cfg,
                                                       dtype, device)))
        if cfg.shared_attn_lora_rank:
            p.update(prefixed("lora", _stack_init(
                generator, n_sites,
                lambda g: _init_site_lora(g, cfg, dtype, device))))
    else:
        for i, (kind, n) in enumerate(segments(cfg)):
            p.update(prefixed(f"segments.{i}", _stack_init(
                generator, n,
                lambda g, kind=kind: _init_block(g, cfg, kind, dtype,
                                                 device))))
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


def _layers(leaf: Leaf, depth: int = 1) -> Sequence[torch.Tensor]:
    return layer_views(leaf, depth) if isinstance(leaf, torch.Tensor) \
        else leaf


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


def _hybrid_forward(cfg: ArchConfig, params: Dict[str, Leaf],
                    x: torch.Tensor, positions) -> torch.Tensor:
    """Zamba2: each site's Mamba2 group, then the shared block with the
    site's LoRA on ``concat(hidden, x0)``; then the tail."""
    x0 = x
    n_sites, every, _ = hybrid_sites(cfg)
    groups = {k: _layers(v, 2)
              for k, v in subtree(params, "mamba_groups").items()}
    shared, lora = subtree(params, "shared"), subtree(params, "lora")
    for s in range(n_sites):
        for j in range(every):
            layer = {k: v[s * every + j] for k, v in groups.items()}
            x, _ = _apply_block(layer, cfg, C.MAMBA2, x, positions)
        sp = (_shared_block_params(shared, {k: v[s]
                                            for k, v in lora.items()})
              if lora else shared)
        x, _ = _apply_shared_block(sp, cfg, x, x0, positions)
    tail = subtree(params, "mamba_tail")
    if tail:
        x, _ = _scan_segment(tail, cfg, C.MAMBA2, x, positions, False)
    return x


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
    if cfg.family == "hybrid":
        x = _hybrid_forward(cfg, params, x, positions)
    else:
        for i, (kind, _n) in enumerate(segments(cfg)):
            x, a = _scan_segment(subtree(params, f"segments.{i}"), cfg,
                                 kind, x, positions, remat)
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
