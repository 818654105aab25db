"""Shared building blocks: norms, RoPE, embeddings, SwiGLU MLP, inits,
losses (port of ``repro/models/common.py``).

Params are flat ``{name: tensor}`` dicts whose keys follow the
reference's pytree leaf order (``conv.3`` is ``params["conv"][3]``
there, ``attn.q_norm.scale`` is ``params["attn"]["q_norm"]["scale"]``),
so that ``convert.params_from_jax`` maps leaf to leaf. The ``init_*``
functions build such dicts; the apply functions are plain functions on
tensors.

Dtypes follow the reference: norms and RoPE compute in float32 and cast
back; a product the reference asks for with
``preferred_element_type=float32`` (the tied unembedding) takes float32
operands here, since ``torch.matmul`` of bfloat16 operands returns
bfloat16. Every other product keeps the operands' dtype.

On a tensor-parallel mesh (``launch/tensor_parallel.py``) the embedding,
the tied unembedding / ``lm_head`` and the SwiGLU MLP run split over the
model cells (``embed_mesh``, ``unembed_mesh``, ``lm_head_mesh``,
``apply_mlp_mesh``): each cell computes its vocabulary block or its
columns of ``d_ff`` with the same math, where the leaf's spec splits it
that way; otherwise the op runs whole on the data shard's home cell.

``remat_call`` is the per-layer recompute policy the LM and the
encoder-decoder model share.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.launch.tensor_parallel import (MeshRun, all_gather, on_cell,
                                                splits_on)

Params = Dict[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# products without batch dims: the outputs ``"dots"`` keeps
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(fn: Callable, remat: Union[bool, str], *args):
    """``fn(*args)``, recomputed in the backward pass by ``remat``:
    ``False`` not at all; ``True`` / ``"full"`` everything (one
    ``torch.utils.checkpoint``); ``"dots"`` everything but the outputs of
    products without batch dims (``aten.mm`` / ``addmm``, not the
    attention's ``bmm``), the reference's
    ``dots_with_no_batch_dims_saveable``."""
    if not remat:
        return fn(*args)
    if remat is True or remat == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat {remat!r}: expected False, True, 'full' or "
                     "'dots'")


def prefixed(prefix: str, params: Params) -> Params:
    """``params`` with every name under ``prefix.`` (a sub-tree)."""
    return {f"{prefix}.{k}": v for k, v in params.items()}


def canonical(params: Params) -> Params:
    """``params`` in the reference's pytree leaf order (dict keys sorted,
    list items by index)."""
    def key(name: str):
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                     for p in name.split("."))
    return {k: params[k] for k in sorted(params, key=key)}


def subtree(params: Params, prefix: str) -> Params:
    """The leaves under ``prefix.``, with the prefix taken off."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items()
            if k.startswith(prefix + ".")}


def normal_init(generator: torch.Generator, shape, dtype=torch.float32,
                stddev: float = 0.02,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """N(0, stddev²) draws from ``generator``, on the generator's device
    (a CPU generator gives the same params on every device). Not the
    reference's ``jax.random`` bits: parity tests load the reference's
    params. On ``meta`` (the dry run's abstract params) nothing is drawn:
    the tensor has the shape and dtype and no values."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * stddev
    return x.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_rmsnorm(dim: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def init_layernorm(dim: int, dtype, device=None) -> Params:
    return {"bias": torch.zeros((dim,), dtype=dtype, device=device),
            "scale": torch.ones((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (interleaved pairs, as the reference)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension (``rot =
    fraction*hd``, rounded down to even)."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    ex = torch.arange(0, rot, 2, dtype=torch.float32, device=device)
    ex = ex / torch.full((), float(rot), device=device)
    # the float32 power, correctly rounded (through float64), is the
    # reference's bit for bit
    p = torch.pow(torch.full((), theta, dtype=torch.float64, device=device),
                  ex.double()).float()
    return 1.0 / p


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """Rotate the leading ``fraction`` of the last dim: pairs
    ``(x[..., 2i], x[..., 2i+1])`` turn by ``positions * inv[i]``.

    x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).
    """
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, fraction, device=x.device)
    rot = inv.shape[0] * 2
    angles = positions[..., :, None].float() * inv        # (..., S, rot/2)
    cos = torch.cos(angles)[..., :, None, :]               # (..., S, 1, rot/2)
    sin = torch.sin(angles)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([yr, xp], dim=-1) if rot < hd else yr


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embedding(generator: torch.Generator, vocab: int, dim: int, dtype,
                   device=None) -> Params:
    return {"table": normal_init(generator, (vocab, dim), dtype,
                                 device=device)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not indexing: its CUDA backward sums the gradients of
    # a repeated token in a fixed order (indexing's accumulates with
    # atomics), so a step is bit-reproducible on the card
    return torch.nn.functional.embedding(tokens.long(), params["table"])


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table.T, float32 (the reference's
    ``preferred_element_type=float32``)."""
    return torch.matmul(x.float(), params["table"].float().t())


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype,
             device=None) -> Params:
    return {
        "w_down": normal_init(generator, (d_ff, d_model), dtype,
                              device=device),
        "w_gate": normal_init(generator, (d_model, d_ff), dtype,
                              device=device),
        "w_up": normal_init(generator, (d_model, d_ff), dtype,
                            device=device),
    }


def apply_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    return torch.matmul(torch.nn.functional.silu(g) * u, params["w_down"])


# ---------------------------------------------------------------------------
# Split over the model cells of a mesh
# ---------------------------------------------------------------------------
def embed_mesh(table, tokens: torch.Tensor, run: MeshRun, sd: int
               ) -> torch.Tensor:
    """Vocab-parallel lookup of data shard ``sd``'s ``tokens``: each cell
    looks up the ids of its vocabulary block (``F.embedding``), the other
    positions are zero, and the cells are summed, exactly (one cell
    contributes per id)."""
    if not splits_on(table, 0):
        return embed(run.whole({"table": table}, sd), tokens)
    n = table.shape[0] // run.tp
    parts = []
    for sm in range(run.tp):
        dev = run.device(sm, sd)
        with on_cell(sm, sd):
            ids = tokens.to(dev).long() - sm * n
            ok = (ids >= 0) & (ids < n)
            e = torch.nn.functional.embedding(
                torch.where(ok, ids, torch.zeros((), dtype=ids.dtype,
                                                 device=dev)),
                table.local(sm, sd))
            parts.append(torch.where(ok[..., None], e,
                                     torch.zeros((), dtype=e.dtype,
                                                 device=dev)))
    return run.reduce(parts, sd)


def _vocab_blocks(parts, run: MeshRun, sd: int) -> torch.Tensor:
    with on_cell(0, sd):
        return all_gather(parts, -1, run.home(sd))


def _per_cell(fn: Callable, run: MeshRun, sd: int) -> list:
    """``fn(sm)`` for each model cell of data shard ``sd``, each under
    its cell."""
    out = []
    for sm in range(run.tp):
        with on_cell(sm, sd):
            out.append(fn(sm))
    return out


def unembed_mesh(table, x: torch.Tensor, run: MeshRun, sd: int
                 ) -> torch.Tensor:
    """Tied unembedding: each cell's float32 logits of its vocabulary
    block, concatenated into the full logits on the home cell."""
    if not splits_on(table, 0):
        return unembed(run.whole({"table": table}, sd), x)
    return _vocab_blocks(_per_cell(
        lambda sm: unembed({"table": table.local(sm, sd)},
                           x.to(run.device(sm, sd))), run, sd), run, sd)


def lm_head_mesh(head, x: torch.Tensor, run: MeshRun, sd: int
                 ) -> torch.Tensor:
    """Untied head ``(d, V)``, its vocabulary columns split as
    :func:`unembed_mesh`'s rows."""
    if not splits_on(head, 1):
        w = run.whole({"w": head}, sd)["w"]
        return torch.matmul(x.float(), w.float())
    return _vocab_blocks(_per_cell(
        lambda sm: torch.matmul(x.to(run.device(sm, sd)).float(),
                                head.local(sm, sd).float()), run, sd),
        run, sd)


def apply_mlp_mesh(params, x: torch.Tensor, run: MeshRun, sd: int
                   ) -> torch.Tensor:
    """SwiGLU split by ``d_ff`` (Megatron): ``w_gate`` / ``w_up`` column
    pieces and ``w_down`` row pieces on each cell; the cells' partial
    outputs summed in cell order."""
    if not (splits_on(params["w_gate"], 1) and splits_on(params["w_up"], 1)
            and splits_on(params["w_down"], 0)):
        return apply_mlp(run.whole(params, sd), x)
    keys = ("w_down", "w_gate", "w_up")
    return run.reduce(_per_cell(
        lambda sm: apply_mlp(run.cell(params, sm, sd, keys),
                             x.to(run.device(sm, sd))), run, sd), sd)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean CE. logits (..., V) float; labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Float32 share of argmax hits (ties go to the first index, as
    ``jnp.argmax``)."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


def tree_cast(tree: Params, dtype) -> Params:
    return {k: v.to(dtype) for k, v in tree.items()}


def tree_size(tree: Any) -> int:
    return sum(math.prod(v.shape) for v in tree.values())
