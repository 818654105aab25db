"""Decoder-only LM assembly (port of ``repro/models/transformer.py``,
whole but its mesh: ``_init_block``, ``_apply_block``, ``_init_block_cache``,
``_decode_block`` and ``_prefill_block`` for every decoder block kind —
``ATTN_MLP``, ``ATTN_MOE``, ``MLA_MLP``, ``MLA_MOE``, ``MAMBA2``,
``MLSTM``, ``SLSTM`` — ``segments``, ``_stack_init``, the Zamba2 shared
block, ``init_lm``, ``lm_forward``, ``mtp_logits``, and the decode path:
``init_lm_caches``, ``lm_decode``, ``lm_prefill``, ``lm_cache_rollback``,
``lm_spec_verify`` and ``lm_spec_propose``).

Layers are grouped into *segments* of identical block kind, and each
segment's params are STACKED along a leading layer axis, as the
reference's: ``segments.0.attn.wq`` has shape ``(n_layers, d, H*hd)``,
``segments.1.moe.w_gate`` ``(n_layers, E, d, f)``. Flat names are the
reference's pytree paths with ``.`` for ``/``, so the converter, the
param bank and the checkpoints map leaf to leaf. The reference scans a
segment with ``lax.scan``; here it is a Python loop over the layer axis,
each layer optionally recomputed in the backward pass (``remat``, one
``torch.utils.checkpoint`` a layer: ``True`` / ``"full"`` recomputes
everything, ``"dots"`` everything but the outputs of products without
batch dims, the reference's ``dots_with_no_batch_dims_saveable``;
``common.remat_call``). DeepSeek's MTP head (``mtp.*``)
is one block of the layout's last kind, not stacked. An audio config
builds and runs the decoder-only stack, ignoring ``encdec``, as the
reference's ``init_lm`` / ``lm_forward`` do (the encoder-decoder model
is ``encdec.py``).

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
memory order, the others one per row (``stacked_depth``).

``lm_forward(mesh=...)`` and ``mtp_logits(mesh=...)`` run on a
tensor-parallel :class:`~repro_torch.launch.mesh.LaunchMesh`
(``launch/tensor_parallel.py``): every leaf is laid out by the LM specs
of ``launch/sharding.py`` (a whole tensor is split here; a sharded leaf,
the LM bank's, is used as it lies), the batch rows split over the data
cells, and the attention heads (GQA and MLA), the SwiGLU MLP, the MoE
experts and the vocabulary split over the model cells. Every other
op — the recurrent blocks, the hybrid's shared block and LoRA, MLA's
latent projections, the MTP projection — gathers the leaves its spec
cuts across and runs whole. The values are the one-device forward's but
for MoE capacity with ``data > 1``, which follows the reference's mesh
run (``moe.py``).

The decode path takes the same ``mesh=`` (``lm_prefill``, ``lm_decode``,
``lm_spec_verify``, ``lm_spec_propose``; ``lm_cache_rollback`` follows
its caches' layout). Each cell runs the one-device cache step on its
share, with the same split rules: a GQA or MLA block's heads against its
own KV heads of the cache (MLA: against the whole latent cache of its
rows, which every cell of a data shard writes alike), the MLP, experts
and vocabulary as the forward; the recurrent blocks and the hybrid's
shared block run whole on each data shard's home cell. The caches are
laid out by ``launch.sharding.cache_shardings``: a :class:`Sharded`
cache is used as it lies and returned sharded; whole caches (a serving
pool's) are cut per cell on entry and returned whole on cell ``(0, 0)``.
Params laid out by the ``decode_2d`` policy run as they lie: a leaf split
over ``model`` combined with the data axes is gathered whole where it is
used (``launch/tensor_parallel.py``), the attention weights keep their
``train`` specs and split the heads. A mesh with a ``pod`` axis runs the
same cells over its flat data-parallel index (``dp_axes=("pod",
"data")``). Every per-cell share runs under
``tensor_parallel.on_cell``, which the dry run's accounting reads.

Caches are flat dicts of the reference's cache tree, stacked per
segment like the params: ``0.k`` ``(n_layers, B, C, Kv, hd)``, ``0.pos``
``(n_layers, C)``, ``0.index`` ``(n_layers,)`` for an attention segment
(``attention.init_kv_cache``'s leaves, MLA's ``c_kv`` / ``k_rope``), the
recurrent states of ``mamba2`` / ``xlstm`` for the others; the hybrid's
``groups.*`` ``(n_sites, every, ...)``, ``shared.*`` ``(n_sites, ...)``
and ``tail.*``. Every cache function returns new tensors and leaves its
input caches as they were. A speculative verify's per-step recurrent
states mirror the cache keys with a time axis after the layer axes.

API:
  init_lm(cfg, generator, device)              -> params
  lm_forward(cfg, params, tokens|embeds,...)   -> (logits, hidden, aux)
  mtp_logits(cfg, params, hidden, next_tokens) -> logits
  init_lm_caches(cfg, batch, max_len, ...)     -> caches
  lm_decode(cfg, params, tokens, caches,...)   -> (logits, caches)
  lm_prefill(cfg, params, tokens, caches,...)  -> (logits, caches[, states])
"""
from __future__ import annotations

from itertools import groupby
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch
from repro_torch import config as C
from repro_torch.config import ArchConfig
from repro_torch.launch.mesh import dp_size
from repro_torch.launch.sharding import cache_shardings, leaf_sharding
from repro_torch.launch.tensor_parallel import MeshRun, Sharded, on_cell
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as mb
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.common import (Params, apply_mlp, apply_mlp_mesh,
                                       canonical, dtype_of, embed,
                                       embed_mesh, init_embedding, init_mlp,
                                       init_rmsnorm, lm_head_mesh,
                                       normal_init, prefixed, remat_call,
                                       rmsnorm, subtree, unembed,
                                       unembed_mesh)
from repro_torch.sharding_hints import constrain

Leaf = Union[torch.Tensor, Sharded, Sequence[torch.Tensor],
             Sequence[Sharded]]

ATTENTION_KINDS = (C.ATTN_MLP, C.ATTN_MOE, C.MLA_MLP, C.MLA_MOE)
RECURRENT_KINDS = (C.MAMBA2, C.MLSTM, C.SLSTM)
# leaves that are float32 in every model (a bfloat16 one included)
FLOAT32_LEAVES = ("moe.router", "core.A_log", "core.D", "core.dt_bias",
                  "core.f_bias")


def param_dtype(cfg: ArchConfig, name: str) -> torch.dtype:
    """The dtype of leaf ``name`` of ``init_lm(cfg)``: a MoE router,
    Mamba2's ``A_log`` / ``D`` / ``dt_bias`` and xLSTM's ``f_bias`` are
    float32 in every model, every other leaf the arch's param dtype."""
    if name.endswith(FLOAT32_LEAVES):
        return torch.float32
    return dtype_of(cfg.param_dtype)


def stacked_depth(name: str) -> int:
    """How many leading axes of leaf ``name`` of ``init_lm`` (or
    ``encdec.init_encdec``) index layers: 2 for ``mamba_groups.*`` (site,
    layer), 1 for ``segments.*``, ``mamba_tail.*``, ``lora.*``,
    ``enc_blocks.*`` and ``dec_blocks.*`` (one row each), 0 for a leaf
    used whole."""
    if name.startswith("mamba_groups."):
        return 2
    return int(name.startswith(("segments.", "mamba_tail.", "lora.",
                                "enc_blocks.", "dec_blocks.")))


def layer_views(leaf: torch.Tensor, depth: int) -> List[torch.Tensor]:
    """A stacked leaf's per-layer VIEWS in memory order (writes to them
    write the leaf); ``[leaf]`` at depth 0."""
    if not depth:
        return [leaf]
    return list(leaf.view(-1, *leaf.shape[depth:]).unbind(0))


def _layers(leaf: Leaf, depth: int = 1) -> Sequence[torch.Tensor]:
    if isinstance(leaf, torch.Tensor):
        return layer_views(leaf, depth)
    if isinstance(leaf, Sharded):
        return leaf.layers(depth)
    return leaf


def layer_params(stacked: Dict[str, Leaf], depth: int = 1
                 ) -> List[Params]:
    """A stacked group's (params' or caches') per-layer dicts of views,
    in memory order."""
    per = {k: _layers(v, depth) for k, v in stacked.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def stack_layers(layers: Sequence[Params], *shape: int) -> Params:
    """Per-layer dicts -> one dict of leaves stacked on a leading layer
    axis, or on the axes ``shape`` (in memory order) where given."""
    shape = shape or (len(layers),)
    out = {}
    for k, v in layers[0].items():
        vs = [c[k] for c in layers]
        out[k] = (Sharded.stack(vs, *shape) if isinstance(v, Sharded) else
                  torch.stack(vs).reshape(*shape, *v.shape))
    return out


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
        h = constrain(h, ("dp", None, None))
        f, aux = moe_mod.apply_moe(subtree(params, "moe"), cfg, h)
        f = constrain(f, ("dp", None, None))
    else:
        f = apply_mlp(subtree(params, "mlp"), h)
    return x + f, aux


def _apply_block_mesh(params: Dict[str, Sharded], cfg: ArchConfig,
                      kind: str, xs: List[torch.Tensor], positions,
                      run: MeshRun
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``_apply_block`` over the data shards' rows ``xs`` (each on its
    home cell), split over the model cells (module docstring)."""
    aux = torch.zeros((), device=run.home(0))
    if kind in RECURRENT_KINDS:
        out = []
        for sd, x in enumerate(xs):
            with on_cell(0, sd):
                out.append(_apply_block(run.whole(params, sd), cfg, kind, x,
                                        _at(positions, x))[0])
        return out, aux
    if kind not in ATTENTION_KINDS:
        raise ValueError(kind)
    mla = kind in (C.MLA_MLP, C.MLA_MOE)
    forward = mla_mod.mla_forward_mesh if mla else attn.attention_forward_mesh
    xs, hs = list(xs), []
    for sd, x in enumerate(xs):
        with on_cell(0, sd):
            h = rmsnorm(run.whole(subtree(params, "norm1"), sd), x,
                        cfg.norm_eps)
            xs[sd] = x + forward(subtree(params, "attn"), cfg, h,
                                 _at(positions, x), run, sd)
            hs.append(rmsnorm(run.whole(subtree(params, "norm2"), sd),
                              xs[sd], cfg.norm_eps))
    if kind in (C.ATTN_MOE, C.MLA_MOE):
        fs, aux = moe_mod.apply_moe_mesh(subtree(params, "moe"), cfg, hs,
                                         run)
    else:
        fs = [apply_mlp_mesh(subtree(params, "mlp"), h, run, sd)
              for sd, h in enumerate(hs)]
    return _residual(xs, fs), aux


def _residual(xs: List[torch.Tensor], fs: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Each data shard's ``x + f`` on its home cell."""
    out = []
    for sd, (x, f) in enumerate(zip(xs, fs)):
        with on_cell(0, sd):
            out.append(x + f)
    return out


def _at(positions: Optional[torch.Tensor], x: torch.Tensor):
    return None if positions is None else positions.to(x.device)


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
    """Zamba2 shared block: concat(hidden, embeds) -> proj -> attn+mlp;
    against ``cache`` a one-token decode, or with ``prefill`` a chunk."""
    hcat = torch.cat([x, x0], dim=-1)
    h = torch.matmul(hcat, p["w_concat"])
    hn = rmsnorm(subtree(p, "norm1"), h, cfg.norm_eps)
    ap = subtree(p, "attn")
    if cache is None:
        a = attn.attention_forward(ap, cfg, hn, positions)
    elif prefill:
        a, cache = attn.attention_prefill(ap, cfg, hn, cache, window,
                                          n_valid)
    else:
        a, cache = attn.attention_decode(ap, cfg, hn, cache, window)
    h = h + a
    f = apply_mlp(subtree(p, "mlp"), rmsnorm(subtree(p, "norm2"), h,
                                             cfg.norm_eps))
    return x + h + f, cache


def _site_params(params: Dict[str, Leaf], s: int) -> Params:
    """The shared block's weights at site ``s`` (with its LoRA deltas)."""
    shared, lora = subtree(params, "shared"), subtree(params, "lora")
    if not lora:
        return shared
    return _shared_block_params(shared, layer_params(lora)[s])


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


def _scan_segment(stacked: Dict[str, Leaf], cfg: ArchConfig, kind: str,
                  x: torch.Tensor, positions, remat
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), device=x.device)
    for layer in layer_params(stacked):

        def body(h, layer=layer):
            h = constrain(h, ("dp", None, None))
            y, a = _apply_block(layer, cfg, kind, h, positions)
            return constrain(y, ("dp", None, None)), a

        x, a = remat_call(body, remat, x)
        aux = aux + a
    return x, aux


def _hybrid_forward(cfg: ArchConfig, params: Dict[str, Leaf],
                    x: torch.Tensor, positions) -> torch.Tensor:
    """Zamba2: each site's Mamba2 group, then the shared block with the
    site's LoRA on ``concat(hidden, x0)``; then the tail."""
    x0 = x
    n_sites, every, _ = hybrid_sites(cfg)
    groups = layer_params(subtree(params, "mamba_groups"), 2)
    for s in range(n_sites):
        for layer in groups[s * every:(s + 1) * every]:
            x, _ = _apply_block(layer, cfg, C.MAMBA2, x, positions)
        x, _ = _apply_shared_block(_site_params(params, s), cfg, x, x0,
                                   positions)
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
               remat: Union[bool, str] = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (logits float32, final_hidden, aux_loss). With a ``mesh``
    (module docstring) the logits, hidden and aux come back whole on cell
    ``(0, 0)``."""
    if mesh is not None:
        return _mesh_forward(cfg, params, tokens, embeds, positions,
                             MeshRun(mesh, dp_axes), remat)
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
        return _mesh_mtp_logits(cfg, params, hidden, next_tokens,
                                MeshRun(mesh, dp_axes))
    m = subtree(params, "mtp")
    e = embed(subtree(params, "embed"), next_tokens).to(hidden.dtype)
    h = torch.cat([rmsnorm(subtree(m, "norm"), hidden, cfg.norm_eps), e],
                  dim=-1)
    h = torch.matmul(h, m["proj"])
    h, _ = _apply_block(subtree(m, "block"), cfg, cfg.layout()[-1], h, None)
    return _logits(cfg, params, h)


# ---------------------------------------------------------------------------
# Tensor-parallel mesh (module docstring)
# ---------------------------------------------------------------------------
def shard_params(cfg: ArchConfig, params: Dict[str, Leaf], mesh
                 ) -> Dict[str, Leaf]:
    """Every leaf laid out on ``mesh`` by its LM spec: a whole tensor
    (stacked leaves included) split into pieces (views where a piece
    stays on its device; differentiable), per-layer tensors one by one;
    sharded leaves as they are, whatever their policy."""
    out: Dict[str, Leaf] = {}
    for k, v in params.items():
        if isinstance(v, Sharded) or (
                not isinstance(v, torch.Tensor) and isinstance(v[0],
                                                               Sharded)):
            out[k] = v
        elif isinstance(v, torch.Tensor):
            spec = leaf_sharding(cfg, k, tuple(v.shape), mesh).spec
            out[k] = Sharded.place(v, mesh, spec)
        else:
            depth = stacked_depth(k)
            spec = leaf_sharding(cfg, k, (1,) * depth + tuple(v[0].shape),
                                 mesh).spec[depth:]
            out[k] = [Sharded.place(t, mesh, spec) for t in v]
    return out


def _embed_mesh(cfg: ArchConfig, sp, tokens, embeds, run: MeshRun
                ) -> List[torch.Tensor]:
    if embeds is not None:
        xs = run.split_batch(embeds)
    else:
        xs = [embed_mesh(sp["embed.table"], t, run, sd)
              for sd, t in enumerate(run.split_batch(tokens))]
    out = []
    for sd, x in enumerate(xs):
        with on_cell(0, sd):
            out.append(x.to(dtype_of(cfg.compute_dtype)))
    return out


def _logits_mesh(cfg: ArchConfig, sp, xs: List[torch.Tensor], run: MeshRun
                 ) -> torch.Tensor:
    out = []
    for sd, x in enumerate(xs):
        with on_cell(0, sd):
            h = rmsnorm(run.whole(subtree(sp, "final_norm"), sd), x,
                        cfg.norm_eps)
            out.append(unembed_mesh(sp["embed.table"], h, run, sd)
                       if cfg.tie_embeddings else
                       lm_head_mesh(sp["lm_head"], h, run, sd))
    return run.join(out)


def _hybrid_forward_mesh(cfg: ArchConfig, sp, xs: List[torch.Tensor],
                         positions, run: MeshRun) -> List[torch.Tensor]:
    """:func:`_hybrid_forward` on a mesh: the Mamba2 layers and the
    shared block (with the site's LoRA) gathered and run whole on each
    data shard's home cell."""
    x0s = xs
    n_sites, every, _ = hybrid_sites(cfg)
    groups = layer_params(subtree(sp, "mamba_groups"), 2)
    shared = subtree(sp, "shared")
    loras = layer_params(subtree(sp, "lora")) if subtree(sp, "lora") \
        else None
    for s in range(n_sites):
        for layer in groups[s * every:(s + 1) * every]:
            xs, _ = _apply_block_mesh(layer, cfg, C.MAMBA2, xs, positions,
                                      run)
        out = []
        for sd, (x, x0) in enumerate(zip(xs, x0s)):
            with on_cell(0, sd):
                p = run.whole(shared, sd)
                if loras is not None:
                    p = _shared_block_params(p, run.whole(loras[s], sd))
                out.append(_apply_shared_block(p, cfg, x, x0,
                                               _at(positions, x))[0])
        xs = out
    for layer in layer_params(subtree(sp, "mamba_tail")) \
            if subtree(sp, "mamba_tail") else []:
        xs, _ = _apply_block_mesh(layer, cfg, C.MAMBA2, xs, positions, run)
    return xs


def _mesh_forward(cfg: ArchConfig, params, tokens, embeds, positions,
                  run: MeshRun, remat):
    sp = shard_params(cfg, params, run.mesh)
    xs = _embed_mesh(cfg, sp, tokens, embeds, run)
    if positions is None:
        positions = torch.arange(xs[0].shape[1], dtype=torch.int32,
                                 device=run.home(0))
    aux = torch.zeros((), device=run.home(0))
    if cfg.family == "hybrid":
        xs = _hybrid_forward_mesh(cfg, sp, xs, positions, run)
    else:
        for i, (kind, _n) in enumerate(segments(cfg)):
            for layer in layer_params(subtree(sp, f"segments.{i}")):

                def body(*hs, layer=layer, kind=kind):
                    ys, a = _apply_block_mesh(layer, cfg, kind, list(hs),
                                              positions, run)
                    return (*ys, a)

                *xs, a = remat_call(body, remat, *xs)
                aux = aux + a
    return _logits_mesh(cfg, sp, xs, run), run.join(xs), aux


def _mesh_mtp_logits(cfg: ArchConfig, params, hidden, next_tokens,
                     run: MeshRun) -> torch.Tensor:
    sp = shard_params(cfg, params, run.mesh)
    m = subtree(sp, "mtp")
    hs = []
    for sd, (h, t) in enumerate(zip(run.split_batch(hidden),
                                    run.split_batch(next_tokens))):
        w = run.whole({k: v for k, v in m.items()
                       if k.startswith("norm.") or k == "proj"}, sd)
        e = embed_mesh(sp["embed.table"], t, run, sd)
        with on_cell(0, sd):
            hc = torch.cat([rmsnorm(subtree(w, "norm"), h, cfg.norm_eps),
                            e.to(h.dtype)], dim=-1)
            hs.append(torch.matmul(hc, w["proj"]))
    hs, _ = _apply_block_mesh(subtree(m, "block"), cfg, cfg.layout()[-1],
                              hs, None, run)
    return _logits_mesh(cfg, sp, hs, run)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------
def _init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      dtype, window: int, device=None) -> Params:
    if kind in (C.ATTN_MLP, C.ATTN_MOE):
        return attn.init_kv_cache(cfg, batch, max_len, dtype, window, device)
    if kind in (C.MLA_MLP, C.MLA_MOE):
        return mla_mod.init_mla_cache(cfg, batch, max_len, dtype, window,
                                      device)
    init = {C.MAMBA2: mb.init_mamba2_cache, C.MLSTM: xl.init_mlstm_cache,
            C.SLSTM: xl.init_slstm_cache}.get(kind)
    if init is None:
        raise ValueError(kind)
    return init(cfg, batch, dtype, device)


def _ffn(params: Params, cfg: ArchConfig, kind: str, x: torch.Tensor
         ) -> torch.Tensor:
    """An attention block's second half: x + MLP or MoE (aux dropped)."""
    h = rmsnorm(subtree(params, "norm2"), x, cfg.norm_eps)
    if kind in (C.ATTN_MOE, C.MLA_MOE):
        return x + moe_mod.apply_moe(subtree(params, "moe"), cfg, h)[0]
    return x + apply_mlp(subtree(params, "mlp"), h)


def _decode_block(params: Params, cfg: ArchConfig, kind: str,
                  x: torch.Tensor, cache: Params, window: int
                  ) -> Tuple[torch.Tensor, Params]:
    if kind in RECURRENT_KINDS:
        decode = {C.MAMBA2: mb.mamba2_decode, C.MLSTM: xl.mlstm_decode,
                  C.SLSTM: xl.slstm_decode}[kind]
        h = rmsnorm(subtree(params, "norm"), x, cfg.norm_eps)
        y, cache = decode(subtree(params, "core"), cfg, h, cache)
        return x + y, cache
    if kind not in ATTENTION_KINDS:
        raise ValueError(kind)
    h = rmsnorm(subtree(params, "norm1"), x, cfg.norm_eps)
    decode = (mla_mod.mla_decode if kind in (C.MLA_MLP, C.MLA_MOE)
              else attn.attention_decode)
    a, cache = decode(subtree(params, "attn"), cfg, h, cache, window)
    return _ffn(params, cfg, kind, x + a), cache


def _prefill_block(params: Params, cfg: ArchConfig, kind: str,
                   x: torch.Tensor, cache: Params, window: int, n_valid,
                   collect: bool = False
                   ) -> Tuple[torch.Tensor, Params, Params]:
    """Cache-filling chunk forward: append S tokens in one pass. x
    (B,S,d). Returns (x, cache, states): with ``collect`` (the
    speculative verify) a recurrent kind's states after each step,
    stacked on a leading time axis; ``{}`` otherwise and for attention
    kinds, whose rollback merges old and full caches by slot."""
    if kind in ATTENTION_KINDS:
        h = rmsnorm(subtree(params, "norm1"), x, cfg.norm_eps)
        prefill = (mla_mod.mla_prefill if kind in (C.MLA_MLP, C.MLA_MOE)
                   else attn.attention_prefill)
        a, cache = prefill(subtree(params, "attn"), cfg, h, cache, window,
                           n_valid)
        return _ffn(params, cfg, kind, x + a), cache, {}
    # recurrent kinds: one-token decodes over time, each state update
    # gated so a padded tail token never advances the recurrence
    S = x.shape[1]
    nv = torch.as_tensor(S if n_valid is None else n_valid,
                         dtype=torch.int32, device=x.device)
    ys, steps = [], []
    for t in range(S):
        y, new = _decode_block(params, cfg, kind, x[:, t:t + 1], cache,
                               window)
        live = nv > t
        cache = {k: torch.where(live, new[k], cache[k]) for k in new}
        ys.append(y)
        if collect:
            steps.append(cache)
    return (torch.cat(ys, dim=1), cache,
            stack_layers(steps) if collect else {})


def _stack_cache(one: Params, *shape: int) -> Params:
    return {k: v.expand(*shape, *v.shape).clone() for k, v in one.items()}


def init_lm_caches(cfg: ArchConfig, batch: int, max_len: int,
                   window: int = 0, device=None) -> Params:
    """Empty caches of every layer (compute dtype; ``index`` / ``pos``
    int32)."""
    dtype = dtype_of(cfg.compute_dtype)

    def one(kind, w=window):
        return _init_block_cache(cfg, kind, batch, max_len, dtype, w,
                                 device)

    if cfg.family == "hybrid":
        n_sites, every, n_tail = hybrid_sites(cfg)
        caches = {**prefixed("groups", _stack_cache(one(C.MAMBA2), n_sites,
                                                    every)),
                  **prefixed("shared", _stack_cache(
                      one(C.ATTN_MLP, window or cfg.sliding_window),
                      n_sites))}
        if n_tail:
            caches.update(prefixed("tail", _stack_cache(one(C.MAMBA2),
                                                        n_tail)))
        return canonical(caches)
    return canonical({k: v for i, (kind, n) in enumerate(segments(cfg))
                      for k, v in prefixed(str(i), _stack_cache(
                          one(kind), n)).items()})


BlockFn = Callable[[Params, str, torch.Tensor, Params],
                   Tuple[torch.Tensor, Params, Params]]


def _run_group(block: BlockFn, kind: str, x: torch.Tensor,
               layers: Sequence[Params], caches: Sequence[Params]):
    new, states = [], []
    for lp, lc in zip(layers, caches):
        x, nc, st = block(lp, kind, x, lc)
        new.append(nc)
        states.append(st)
    return x, new, states


def _cached_pass(cfg: ArchConfig, params: Dict[str, Leaf], x, caches,
                 block: BlockFn, shared_fn) -> Tuple[Any, Params, Params]:
    """Every layer over ``x`` against its cache: ``block(lp, kind, x,
    lc) -> (x, cache, states)`` a layer, ``shared_fn(s, x, x0, cache)
    -> (x, cache)`` at hybrid site ``s``. Returns (x, caches, states),
    both flat and stacked as the caches. On a mesh ``x`` is the data
    shards' rows and the caches are :class:`Sharded`."""
    new: Params = {}
    states: Params = {}

    def keep(prefix, caches_, states_, *shape):
        new.update(prefixed(prefix, stack_layers(caches_, *shape)))
        if states_[0]:
            states.update(prefixed(prefix, stack_layers(states_, *shape)))

    if cfg.family == "hybrid":
        x0 = x
        n_sites, every, n_tail = hybrid_sites(cfg)
        groups = layer_params(subtree(params, "mamba_groups"), 2)
        gcaches = layer_params(subtree(caches, "groups"), 2)
        scaches = layer_params(subtree(caches, "shared"))
        gnew, gstates, snew = [], [], []
        for s in range(n_sites):
            sl = slice(s * every, (s + 1) * every)
            x, nc, st = _run_group(block, C.MAMBA2, x, groups[sl],
                                   gcaches[sl])
            gnew += nc
            gstates += st
            x, sc = shared_fn(s, x, x0, scaches[s])
            snew.append(sc)
        keep("groups", gnew, gstates, n_sites, every)
        new.update(prefixed("shared", stack_layers(snew)))
        if n_tail:
            x, nc, st = _run_group(
                block, C.MAMBA2, x,
                layer_params(subtree(params, "mamba_tail")),
                layer_params(subtree(caches, "tail")))
            keep("tail", nc, st)
        return x, canonical(new), canonical(states)
    for i, (kind, _n) in enumerate(segments(cfg)):
        x, nc, st = _run_group(
            block, kind, x, layer_params(subtree(params, f"segments.{i}")),
            layer_params(subtree(caches, str(i))))
        keep(str(i), nc, st)
    return x, canonical(new), canonical(states)


def _cached(cfg: ArchConfig, params: Dict[str, Leaf], tokens, embeds,
            caches: Params, window: int, n_valid, prefill: bool,
            collect: bool, mesh, dp_axes) -> Tuple[torch.Tensor, Params,
                                                  Params]:
    """``lm_prefill`` (``prefill``) or ``lm_decode``: (logits, caches,
    states)."""
    if mesh is not None:
        return _cached_mesh(cfg, params, tokens, embeds, caches, window,
                            n_valid, prefill, collect, MeshRun(mesh, dp_axes))
    x = embed(subtree(params, "embed"), tokens) if embeds is None else embeds
    x = x.to(dtype_of(cfg.compute_dtype))
    w_shared = window or cfg.sliding_window

    def block(lp, kind, h, lc):
        if prefill:
            return _prefill_block(lp, cfg, kind, h, lc, window, n_valid,
                                  collect=collect)
        return (*_decode_block(lp, cfg, kind, h, lc, window), {})

    def shared_fn(s, h, x0, sc):
        return _apply_shared_block(_site_params(params, s), cfg, h, x0,
                                   None, cache=sc, window=w_shared,
                                   prefill=prefill, n_valid=n_valid)

    x, caches, states = _cached_pass(cfg, params, x, caches, block,
                                     shared_fn)
    return _logits(cfg, params, x), caches, states


def lm_decode(cfg: ArchConfig, params: Dict[str, Leaf],
              tokens: torch.Tensor, caches: Params, window: int = 0,
              embeds: Optional[torch.Tensor] = None, mesh=None,
              dp_axes: Tuple[str, ...] = ("data",)
              ) -> Tuple[torch.Tensor, Params]:
    """One decode step. tokens (B,1) -> (logits (B,1,V) float32,
    caches). With a ``mesh`` see the module docstring."""
    logits, caches, _ = _cached(cfg, params, tokens, embeds, caches, window,
                                None, False, False, mesh, dp_axes)
    return logits, caches


def lm_prefill(cfg: ArchConfig, params: Dict[str, Leaf],
               tokens: torch.Tensor, caches: Params, window: int = 0,
               n_valid: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None, mesh=None,
               dp_axes: Tuple[str, ...] = ("data",),
               collect_states: bool = False):
    """Chunked cache-filling prefill: append ``S`` tokens to every layer
    cache in one pass. tokens (B,S) -> (logits (B,S,V) float32, caches).

    ``n_valid`` (an int or a 0-d tensor, read on the device) marks how
    many leading tokens of a padded final chunk are real: attention lanes
    past it are not written, recurrent updates are gated off.
    ``collect_states=True`` returns ``(logits, caches, states)``, the
    per-step recurrent states ``lm_cache_rollback`` selects from."""
    logits, caches, states = _cached(cfg, params, tokens, embeds, caches,
                                     window, n_valid, True, collect_states,
                                     mesh, dp_axes)
    if collect_states:
        return logits, caches, states
    return logits, caches


# ---------------------------------------------------------------------------
# The decode path on a tensor-parallel mesh (module docstring)
# ---------------------------------------------------------------------------
def _cell(caches: Dict[str, Sharded], sm: int, sd: int) -> Params:
    """Cell ``(sm, sd)``'s pieces of a layer's caches."""
    return {k: v.piece(sm, sd) for k, v in caches.items()}


def _laid_out(like: Dict[str, Sharded], values: Dict[int, Params],
              lead: Tuple[int, ...] = ()) -> Dict[str, Sharded]:
    """Caches computed on some cells (by cell index) laid out as
    ``like``'s leaves, with new leading axes ``lead`` (a verify's time
    axis)."""
    return {k: Sharded.from_cells(
        v.mesh, (None,) * len(lead) + tuple(v.spec), (*lead, *v.shape),
        {c: r[k] for c, r in values.items()}) for k, v in like.items()}


def _mesh_caches(cfg: ArchConfig, caches: Params, run: MeshRun
                 ) -> Dict[str, Sharded]:
    """``caches`` laid out by ``cache_shardings``: a whole tensor cut per
    cell, a sharded leaf as it lies."""
    specs = cache_shardings(cfg, caches, run.mesh, run.dp_axes)
    return {k: v if isinstance(v, Sharded) else
            Sharded.place(v, run.mesh, specs[k].spec)
            for k, v in caches.items()}


def _mesh_block(lp: Dict[str, Sharded], cfg: ArchConfig, kind: str,
                xs: List[torch.Tensor], lc: Dict[str, Sharded],
                run: MeshRun, window: int, n_valid, prefill: bool,
                collect: bool):
    """One layer of a cached pass over the data shards' rows ``xs``
    against its caches ``lc``, split as ``_apply_block_mesh``. Returns
    (xs, caches, states) as ``_prefill_block``."""
    D = dp_size(run.mesh)
    xs, vals, sts = list(xs), {}, {}
    if kind in RECURRENT_KINDS:
        for sd, x in enumerate(xs):
            with on_cell(0, sd):
                p, c = run.whole(lp, sd), _cell(lc, 0, sd)
                if prefill:
                    xs[sd], vals[sd], sts[sd] = _prefill_block(
                        p, cfg, kind, x, c, window, n_valid, collect)
                else:
                    xs[sd], vals[sd] = _decode_block(p, cfg, kind, x, c,
                                                     window)
        states = _laid_out(lc, sts, (xs[0].shape[1],)) if collect else {}
        return xs, _laid_out(lc, vals), states
    if kind not in ATTENTION_KINDS:
        raise ValueError(kind)
    ap = subtree(lp, "attn")
    if kind in (C.MLA_MLP, C.MLA_MOE):
        split = mla_mod.mla_splits(ap, cfg, run.tp)
        sub, keys = mla_mod.mla_per_cell(cfg, run.tp), mla_mod.MLA_HEAD_SPLIT
        step = mla_mod.mla_prefill if prefill else mla_mod.mla_decode
    else:
        split = attn.attention_splits(ap, cfg, run.tp)
        sub, keys = attn.heads_per_cell(cfg, run.tp), attn.HEAD_SPLIT
        step = attn.attention_prefill if prefill else attn.attention_decode
    extra = (window, n_valid) if prefill else (window,)
    hs = []
    for sd, x in enumerate(xs):
        with on_cell(0, sd):
            h = rmsnorm(run.whole(subtree(lp, "norm1"), sd), x,
                        cfg.norm_eps)
            if split:
                parts = []
                for sm in range(run.tp):
                    with on_cell(sm, sd):
                        a, vals[sm * D + sd] = step(
                            run.cell(ap, sm, sd, keys), sub,
                            h.to(run.device(sm, sd)), _cell(lc, sm, sd),
                            *extra)
                    parts.append(a)
                a = run.reduce(parts, sd)
            else:
                a, vals[sd] = step(run.whole(ap, sd), cfg, h,
                                   _cell(lc, 0, sd), *extra)
            xs[sd] = x + a
            hs.append(rmsnorm(run.whole(subtree(lp, "norm2"), sd), xs[sd],
                              cfg.norm_eps))
    if kind in (C.ATTN_MOE, C.MLA_MOE):
        fs = moe_mod.apply_moe_mesh(subtree(lp, "moe"), cfg, hs, run)[0]
    else:
        fs = [apply_mlp_mesh(subtree(lp, "mlp"), h, run, sd)
              for sd, h in enumerate(hs)]
    return _residual(xs, fs), _laid_out(lc, vals), {}


def _cached_mesh(cfg: ArchConfig, params, tokens, embeds, caches: Params,
                 window: int, n_valid, prefill: bool, collect: bool,
                 run: MeshRun):
    sp = shard_params(cfg, params, run.mesh)
    xs = _embed_mesh(cfg, sp, tokens, embeds, run)
    whole = not any(isinstance(v, Sharded) for v in caches.values())
    cs = _mesh_caches(cfg, caches, run)
    w_shared = window or cfg.sliding_window
    loras = (layer_params(subtree(sp, "lora")) if subtree(sp, "lora")
             else None)

    def block(lp, kind, hs, lc):
        return _mesh_block(lp, cfg, kind, hs, lc, run, window, n_valid,
                           prefill, collect)

    def shared_fn(s, hs, x0s, sc):
        vals, out = {}, []
        for sd, (x, x0) in enumerate(zip(hs, x0s)):
            with on_cell(0, sd):
                p = run.whole(subtree(sp, "shared"), sd)
                if loras is not None:
                    p = _shared_block_params(p, run.whole(loras[s], sd))
                y, vals[sd] = _apply_shared_block(
                    p, cfg, x, x0, None, cache=_cell(sc, 0, sd),
                    window=w_shared, prefill=prefill, n_valid=n_valid)
            out.append(y)
        return out, _laid_out(sc, vals)

    xs, cs, states = _cached_pass(cfg, sp, xs, cs, block, shared_fn)
    if whole:
        home = run.home(0)
        cs = {k: v.full(home) for k, v in cs.items()}
        states = {k: v.full(home) for k, v in states.items()}
    return _logits_mesh(cfg, sp, xs, run), cs, states


# ---------------------------------------------------------------------------
# Speculative decoding (DESIGN.md §16)
# ---------------------------------------------------------------------------
def lm_cache_rollback(cfg: ArchConfig, old: Params, full: Params,
                      states: Params, n_keep, S: int, window: int = 0
                      ) -> Params:
    """Roll a verify chunk's caches back to its first ``n_keep`` tokens
    (``n_keep >= 1``). ``old`` is the cache before the verify prefill,
    ``full`` / ``states`` the cache and per-step states after it
    (``lm_prefill(..., collect_states=True)`` over ``S`` tokens).
    Attention caches merge old and full per slot (bitwise a prefill with
    ``n_valid=n_keep``); recurrent caches take the state after step
    ``n_keep``. Sharded caches (a mesh's) roll back cell by cell and
    keep their layout."""
    if any(isinstance(v, Sharded) for v in old.values()):
        vals = {}
        for c in range(next(iter(old.values())).mesh.size):
            vals[c] = lm_cache_rollback(
                cfg, *({k: v.pieces[c] for k, v in t.items()}
                       for t in (old, full, states)), n_keep, S, window)
        return _laid_out(old, vals)

    def part(prefix, kind, w=window, time_axis=1):
        o, f = subtree(old, prefix), subtree(full, prefix)
        if kind in (C.ATTN_MLP, C.ATTN_MOE):
            r = attn.attention_rollback(o, f, n_keep, S, w)
        elif kind in (C.MLA_MLP, C.MLA_MOE):
            r = mla_mod.mla_rollback(o, f, n_keep, S, w)
        elif kind == C.MAMBA2:
            r = mb.mamba2_rollback(subtree(states, prefix), n_keep,
                                   time_axis)
        else:
            r = xl.xlstm_rollback(subtree(states, prefix), n_keep,
                                  time_axis)
        return prefixed(prefix, r)

    if cfg.family == "hybrid":
        out = {**part("groups", C.MAMBA2, time_axis=2),
               **part("shared", C.ATTN_MLP, window or cfg.sliding_window)}
        if subtree(old, "tail"):
            out.update(part("tail", C.MAMBA2))
        return canonical(out)
    return canonical({k: v for i, (kind, _n) in enumerate(segments(cfg))
                      for k, v in part(str(i), kind).items()})


def lm_spec_verify(cfg: ArchConfig, params: Dict[str, Leaf],
                   tokens: torch.Tensor, draft: torch.Tensor,
                   caches: Params, window: int = 0, sample_fn=None,
                   mesh=None, dp_axes: Tuple[str, ...] = ("data",)):
    """Verify a speculative chunk in ONE chunked forward.

    ``tokens`` (B, S=k+1) is ``[cur, d_1..d_k]``, ``draft`` (B, k) is
    ``[d_1..d_k]``. The target prefills the chunk, takes its own choice
    at every position (argmax, or ``sample_fn(logits) -> (B, S)``), and
    accepts the longest matching prefix of the draft. Returns ``(out
    (B,S) int32, n_keep, caches)``: ``n_keep = 1 + accepted`` (the batch
    min; a 0-d int32 tensor, not read on the host) chunk tokens consumed
    by the rolled-back caches."""
    S = tokens.shape[1]
    logits, full, states = lm_prefill(cfg, params, tokens, caches,
                                      window=window, mesh=mesh,
                                      dp_axes=dp_axes, collect_states=True)
    out = torch.argmax(logits, dim=-1) if sample_fn is None \
        else sample_fn(logits)
    out = out.to(torch.int32)
    ok = (draft == out[:, :-1]).to(torch.int32)
    acc = torch.sum(torch.cumprod(ok, dim=1), dim=1)
    n_keep = (1 + torch.min(acc)).to(torch.int32)
    return out, n_keep, lm_cache_rollback(cfg, caches, full, states, n_keep,
                                          S, window)


def lm_spec_propose(cfg: ArchConfig, params: Dict[str, Leaf],
                    prev_tokens: torch.Tensor, prev_keep,
                    cur: torch.Tensor, k: int, caches: Params,
                    window: int = 0, mesh=None,
                    dp_axes: Tuple[str, ...] = ("data",)):
    """Draft side, one call a spec round: commit the previous round's
    chunk ``prev_tokens`` (B, S) with ``n_valid=prev_keep`` (0: a no-op,
    for the first round), then greedily decode ``k`` proposals from
    ``cur`` (B, 1). Returns ``(proposals (B, k) int32, caches)``, the
    caches after the commit only."""
    _, caches = lm_prefill(cfg, params, prev_tokens, caches, window=window,
                           n_valid=prev_keep, mesh=mesh, dp_axes=dp_axes)
    tok, cs, props = cur, caches, []
    for _ in range(k):
        lg, cs = lm_decode(cfg, params, tok, cs, window=window, mesh=mesh,
                           dp_axes=dp_axes)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        props.append(tok)
    return torch.cat(props, dim=1), caches
