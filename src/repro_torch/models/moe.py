"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch
(port of ``repro/models/moe.py``, the single-shard path).

* Routing (softmax top-k, Switch load-balance aux loss) is float32: the
  ``router`` leaf is float32 even in a bfloat16 model, and the logits
  take float32 operands.
* Dispatch scatters token *indices* into per-expert capacity buffers of
  ``capacity(T)`` slots and gathers the tokens once; pairs past an
  expert's capacity are dropped (combine weight zero), the Switch/GShard
  discipline.
* The experts' SwiGLU runs in the compute dtype as batched products; the
  combine is float32 and cast back, and the shared expert (if any) is
  added after the cast.

Ordering, so that a step is bit-reproducible on the card: the top-k is a
stable descending sort (the lower expert index first on ties, as
``lax.top_k``); a pair's rank within its expert follows pair order
``t*k + j`` (a stable sort, as the reference's ``argsort``); the gathers
go through ``F.embedding``, whose backward sums a repeated row in a fixed
order; and the combine gathers each (token, choice) pair's output and
adds a token's k pairs in choice order. No scatter-add sits on the path,
and every write is out of place (``index_put``), so the block runs under
``torch.func.vmap`` (the serving gateway's lanes).

On a mesh (``apply_moe(..., mesh=...)``, and ``apply_moe_mesh`` inside
the tensor-parallel forward) the experts split over the model cells, as
the reference's ``shard_map`` branch: cell ``(sm, sd)`` owns experts
``e0 = sm * E / ep`` onward (the data pieces of their weights gathered
first), recomputes the routing of data shard ``sd``'s tokens, and takes
capacity from the tokens of one data shard, ``capacity(max(1, B*S //
dp))``; each cell's partial combine (in choice order, in the compute
dtype) is summed over the model cells in cell order, and ``aux`` is
averaged over the data shards. So with ``data > 1`` the capacity drops
follow the reference's mesh run, not its one-device run. When the tokens
do not split over dp (or the experts do not split over the model axis)
the single-shard path runs whole, as the reference's fallback.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.launch.tensor_parallel import (MeshRun, on_cell,
                                                splits_on)
from repro_torch.models.common import (Params, apply_mlp, apply_mlp_mesh,
                                       init_mlp, normal_init, prefixed,
                                       subtree)


def init_moe(generator: torch.Generator, cfg: ArchConfig, dtype,
             device=None) -> Params:
    m, d = cfg.moe, cfg.d_model
    p: Params = {
        "router": normal_init(generator, (d, m.n_experts), torch.float32,
                              stddev=0.006, device=device),
        "w_down": normal_init(generator, (m.n_experts, m.expert_ff, d),
                              dtype, device=device),
        "w_gate": normal_init(generator, (m.n_experts, d, m.expert_ff),
                              dtype, device=device),
        "w_up": normal_init(generator, (m.n_experts, d, m.expert_ff), dtype,
                            device=device),
    }
    if m.n_shared:
        p.update(prefixed("shared", init_mlp(
            generator, d, m.n_shared * m.expert_ff, dtype, device)))
    return p


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(8, c + (-c) % 8)


def _route(params: Params, cfg: ArchConfig, xf: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (ids (T,k) int64, weights (T,k) float32, aux_loss scalar)."""
    m = cfg.moe
    logits = torch.matmul(xf.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, ids = wts[:, :m.top_k], ids[:, :m.top_k]
    wts = wts / torch.clamp(torch.sum(wts, dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    pe = torch.mean(probs, dim=0)                           # (E,)
    fe = torch.mean(F.one_hot(ids[:, 0], m.n_experts).float(), dim=0)
    aux = m.n_experts * torch.sum(fe * pe) * m.aux_coef
    return ids, wts, aux


def _expert_shard(xf: torch.Tensor, ids: torch.Tensor, wts: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, *, e0: int, cap: int,
                  compute_dtype) -> torch.Tensor:
    """Experts ``e0 .. e0 + E_loc`` over the tokens xf (T,d)."""
    T, d = xf.shape
    E_loc = w_gate.shape[0]
    k = ids.shape[1]
    Tk = T * k
    dev = xf.device
    pairs = torch.arange(Tk, device=dev)
    pair_expert = ids.reshape(Tk).long()
    pair_token = pairs // k
    pair_w = wts.reshape(Tk)

    local = (pair_expert >= e0) & (pair_expert < e0 + E_loc)
    le = torch.where(local, pair_expert - e0, E_loc)    # E_loc = spill bucket
    # a pair's rank within its expert, in pair order (searchsorted, not
    # bincount: that reads its size back to the host on the card)
    le_sorted, order = torch.sort(le, stable=True)
    starts = torch.searchsorted(le_sorted,
                                torch.arange(E_loc + 1, device=dev))
    rank = torch.zeros_like(le).index_put((order,),
                                          pairs - starts[le_sorted])

    valid = local & (rank < cap)
    sentinel = E_loc * cap                    # one slot past the buffers
    slot = torch.where(valid, le * cap + rank, sentinel)

    # index buffer: which token sits in each capacity slot (empty slots
    # hold token 0 with weight 0, as the reference's); the sentinel slot
    # takes every dropped pair and is cut off
    tok_buf = torch.zeros(sentinel + 1, dtype=torch.long,
                          device=dev).index_put((slot,), pair_token)
    tok_buf = tok_buf[:sentinel]

    ebuf = F.embedding(tok_buf, xf).reshape(E_loc, cap, d).to(compute_dtype)
    g = torch.bmm(ebuf, w_gate)
    u = torch.bmm(ebuf, w_up)
    h = F.silu(g) * u
    out = torch.bmm(h, w_down).reshape(sentinel, d)

    # combine: each pair's slot output (the sentinel row is zero) times
    # its weight, a token's k pairs added in choice order
    out = torch.cat([out, out.new_zeros((1, d))])
    w = torch.where(valid, pair_w, torch.zeros((), device=dev))
    contrib = (F.embedding(slot, out).float() * w[:, None]).reshape(T, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y.to(xf.dtype)


def apply_moe(params: Params, cfg: ArchConfig, x: torch.Tensor,
              mesh=None, dp_axes: Tuple[str, ...] = ("data",),
              ep_axis: str = "model"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x (B,S,d) -> (y (B,S,d), aux_loss). With a ``mesh`` the
    experts run expert-parallel (module docstring); ``params`` may be
    whole tensors (laid out here by the LM specs) or sharded leaves."""
    if mesh is not None:
        if ep_axis != "model":
            raise ValueError(f"expert axis {ep_axis!r}: a launch mesh "
                             "splits experts over 'model'")
        from repro_torch.models.transformer import shard_params
        run = MeshRun(mesh, dp_axes)
        sharded = shard_params(cfg, prefixed("moe", params), mesh)
        ys, aux = apply_moe_mesh(subtree(sharded, "moe"), cfg, [x], run)
        return ys[0], aux
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    ids, wts, aux = _route(params, cfg, xf)
    y = _expert_shard(xf, ids, wts, params["w_gate"], params["w_up"],
                      params["w_down"], e0=0, cap=capacity(B * S, cfg),
                      compute_dtype=x.dtype)
    if cfg.moe.n_shared:
        y = y + apply_mlp(subtree(params, "shared"), xf)
    return y.reshape(B, S, d), aux


def apply_moe_mesh(params, cfg: ArchConfig, xs: Sequence[torch.Tensor],
                   run: MeshRun
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The expert-parallel MoE over the data shards' activations ``xs``
    (each ``(b, S, d)`` on its home cell; one entry when the batch did
    not split over dp). Returns (the shards' outputs, aux on cell
    ``(0, 0)``)."""
    m = cfg.moe
    d = xs[0].shape[-1]
    T = sum(x.shape[0] * x.shape[1] for x in xs)
    dp, ep = run.dp, run.tp
    experts = all(splits_on(params[k], 0)
                  for k in ("w_down", "w_gate", "w_up"))
    if T % dp or not experts or m.n_experts % ep:
        # single-shard path (tokens that do not split over dp): whole
        x = run.join(xs)
        p = run.whole({k: v for k, v in params.items()
                       if not k.startswith("shared.")})
        xf = x.reshape(T, d)
        ids, wts, aux = _route(p, cfg, xf)
        y = _expert_shard(xf, ids, wts, p["w_gate"], p["w_up"],
                          p["w_down"], e0=0, cap=capacity(T, cfg),
                          compute_dtype=x.dtype).reshape(x.shape)
        ys = ([y] if len(xs) == 1 else
              [t.to(xi.device) for t, xi in zip(
                  y.split([xi.shape[0] for xi in xs]), xs)])
        return _add_shared(params, cfg, xs, ys, run), aux
    cap = capacity(max(1, T // dp), cfg)
    if len(xs) == dp:
        chunks = [x.reshape(-1, d) for x in xs]
    else:                      # rows that did not split: cut the tokens
        xf = xs[0].reshape(T, d)
        n = T // dp
        chunks = [xf.narrow(0, sd * n, n).to(run.home(sd))
                  for sd in range(dp)]
    keys = ("router", "w_down", "w_gate", "w_up")
    outs, auxs = [], []
    for sd, xf in enumerate(chunks):
        parts = []
        for sm in range(ep):
            dev = run.device(sm, sd)
            with on_cell(sm, sd):
                xc = xf.to(dev)
                p = run.cell({k: params[k] for k in keys}, sm, sd,
                             ("w_down", "w_gate", "w_up"))
                # routing recomputed per cell, on its data shard's tokens
                ids, wts, aux = _route(p, cfg, xc)
                if sm == 0:
                    auxs.append(aux)
                parts.append(_expert_shard(
                    xc, ids, wts, p["w_gate"], p["w_up"], p["w_down"],
                    e0=sm * (m.n_experts // ep), cap=cap,
                    compute_dtype=xc.dtype))
        outs.append(run.reduce(parts, sd))
    home = run.home(0)
    aux = auxs[0].to(home)
    for a in auxs[1:]:
        aux = aux + a.to(home)
    aux = aux / torch.full((), float(dp), device=home)
    if len(xs) == dp:
        ys = [y.reshape(x.shape) for y, x in zip(outs, xs)]
    else:
        ys = [run.join(outs).reshape(xs[0].shape)]
    return _add_shared(params, cfg, xs, ys, run), aux


def _add_shared(params, cfg: ArchConfig, xs, ys, run: MeshRun
                ) -> List[torch.Tensor]:
    """The shared expert (if any), added after the routed combine."""
    if not cfg.moe.n_shared:
        return list(ys)
    shared = subtree(params, "shared")
    return [y + apply_mlp_mesh(shared, x, run, sd if len(xs) > 1 else 0)
            for sd, (x, y) in enumerate(zip(xs, ys))]
