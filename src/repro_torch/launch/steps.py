"""Step builders for training (the FedCD mode-B round), prefill and
decode (port of ``repro/launch/steps.py``, whole: ``client_weights_per_row``,
``_lm_loss`` with its audio and MTP branches, ``quantize_grads``,
``make_train_step``, ``make_eval_step``, ``make_prefill_step`` and
``make_serve_step``, each with the reference's ``mesh``, ``dp_axes`` and
``hints``).

``make_train_step`` is the cluster-scale FedCD round (DESIGN.md §3):
clients are contiguous row-groups of the global batch; eq 1's
score-weighted aggregation of per-client gradients is realized as a
score-weighted loss — identical for E=1 because aggregation is linear in
client gradients. Multiple global models are a host-level loop over this
same step.

The port's step trains IN PLACE: ``step(params, ...)`` writes the
updated values into ``params``' own tensors and returns that dict (the
LM trainer's bank rows are trained where they lie; pass a copy to keep
the input). It takes one gradient per LAYER of each stacked leaf
(``segments.*``, ``mamba_tail.*`` and ``lora.*`` split along their row
axis into views, ``mamba_groups.*`` along its (site, layer) axes, in
memory order: ``transformer.stacked_depth``), so no stacked gradient is
ever assembled; the values are the reference's, since every layer's
slice of a stacked gradient is that layer's gradient. The encoder-decoder
model's ``enc_blocks.*`` and ``dec_blocks.*`` split per row too.

On a tensor-parallel ``mesh`` the train and eval steps run the model's
mesh forward (``transformer.lm_forward(mesh=...)``). Params may be whole
tensors (the ``legacy`` engine's: laid out per step, their gradients
whole) or sharded leaves (the LM bank's rows,
``launch/tensor_parallel.Sharded``): then the gradient of each piece is
taken on the piece's device, copies of one block (over the data axis, or
a replicated leaf's on several devices) take the sum of their gradients
in cell order, and the float32 SGD runs in place per piece.
The prefill and serve steps run the decode path on the mesh
(``transformer.lm_prefill`` / ``lm_decode`` with ``mesh=``: caches
sharded or whole, as ``transformer``'s docstring says); the audio serve
step runs the encoder-decoder decode on the params gathered whole on
cell ``(0, 0)``, as the reference passes no mesh there.
``quantize_grads`` cuts each leaf's 128-value blocks from the WHOLE
leaf's flattened row, so its codes and scales are the one-device step's:
a piece goes to the kernels alone where every row of it is a whole
number of blocks; a leaf whose blocks cross pieces is gathered to cell
``(0, 0)``, quantized there and split back. One grouped call of each
kernel per device (per 32 leaves).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.launch.tensor_parallel import (Block, Sharded, narrow_block,
                                                on_cell, reduce_replicas)
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.common import Params
from repro_torch.optim import sgd_update_
from repro_torch.sharding_hints import sharding_hints

Part = Union[torch.Tensor, Sharded]
GradTree = Dict[str, Union[Part, List[Part]]]
QUANT_BLOCK = 128                # values of one transport block


def client_weights_per_row(client_scores: torch.Tensor, batch: int
                           ) -> torch.Tensor:
    """Expand per-client FedCD scores c_i to per-row loss weights that sum
    to 1 (eq 1 numerator/denominator in one step)."""
    n_clients = client_scores.shape[0]
    per = batch // n_clients
    w = torch.repeat_interleave(client_scores, per)            # (B,)
    return w / torch.clamp(torch.sum(w), min=1e-12)


def _forward(cfg: ArchConfig, params, tokens, frames, remat=False,
             mesh=None, dp_axes=("data",)):
    """(logits, hidden, aux): the encoder-decoder model on ``frames``
    for an audio config (aux 0; it takes no mesh, as the reference's),
    else the decoder-only LM."""
    if cfg.family == "audio":
        logits, hidden = ed.encdec_forward(cfg, params, frames, tokens,
                                           remat=remat)
        return logits, hidden, torch.zeros((), device=logits.device)
    return tf.lm_forward(cfg, params, tokens, mesh=mesh, dp_axes=dp_axes,
                         remat=remat)


def _lm_loss(cfg: ArchConfig, params, tokens, labels, row_w, mesh=None,
             dp_axes=("data",), frames=None, remat=True):
    """Score-weighted next-token loss, plus DeepSeek's MTP loss (weight
    0.3) where the model has an MTP head. Returns (loss + aux, (loss,
    aux))."""
    logits, hidden, aux = _forward(cfg, params, tokens, frames, remat,
                                   mesh, dp_axes)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (logz - gold).mean(dim=-1)                           # (B,)
    loss = torch.sum(nll * row_w)
    if cfg.mtp and any(k.startswith("mtp.") for k in params):
        # predict t+2: condition on emb(t+1)=labels, target labels shifted
        mtp_lg = tf.mtp_logits(cfg, params, hidden, labels, mesh, dp_axes)
        mtp_labels = torch.roll(labels, -1, 1).long()
        lz = torch.logsumexp(mtp_lg, dim=-1)
        gd = torch.gather(mtp_lg, -1, mtp_labels[..., None])[..., 0]
        mask = torch.ones(labels.shape, device=lz.device)
        mask[:, -1] = 0.0
        mtp_nll = (((lz - gd) * mask).sum(-1)
                   / torch.clamp(mask.sum(-1), min=1.0))
        loss = loss + 0.3 * torch.sum(mtp_nll * row_w)
    return loss + aux, (loss, aux)


def _parts(g: Union[Part, Sequence[Part]]) -> List[Part]:
    return [g] if isinstance(g, (torch.Tensor, Sharded)) else list(g)


def _tensors(part: Part) -> List[torch.Tensor]:
    return [part] if isinstance(part, torch.Tensor) else part.distinct()


def _aligned(shape: Sequence[int], blk: Block) -> bool:
    """Whether every row of the block ``blk`` of a leaf (layer) of
    ``shape`` is a whole number of transport blocks of the whole leaf's
    flattened row: its runs start and end on block boundaries."""
    cut = [d for d, (_, c) in enumerate(blk) if c > 1]
    if not cut:
        return True
    j = cut[-1]
    inner = math.prod(shape[j + 1:])
    n = shape[j] // blk[j][1]
    return all(v % QUANT_BLOCK == 0 for v in
               (blk[j][0] * n * inner, n * inner, shape[j] * inner))


def _sharded_jobs(layers: List[Sharded], jobs: list) -> List[list]:
    """Transport jobs of a sharded leaf (its per-layer parts ``layers``):
    one per block where each piece's rows are whole blocks, else one for
    the leaf gathered to cell ``(0, 0)``. Returns, per layer, the list
    the jobs fill with the new distinct tensors."""
    s0 = layers[0]
    new: List[list] = [[None] * len(s.distinct()) for s in layers]
    index = {id(p): i for i, p in enumerate(s0.distinct())}
    groups = [(blk, [index[id(t)] for t in ts]) for blk, ts in s0.groups()]
    if all(_aligned(s0.shape, blk) for blk, _ in groups):
        for _, idx in groups:
            first = [s.distinct()[idx[0]] for s in layers]
            row = torch.cat([p.reshape(-1).float() for p in first])[None]

            def write(flat, idx=idx, first=first):
                o = 0
                for li, (s, p) in enumerate(zip(layers, first)):
                    v = flat[0, o:o + p.numel()].reshape(p.shape).to(p.dtype)
                    o += p.numel()
                    for i in idx:
                        new[li][i] = v.to(s.distinct()[i].device)
            jobs.append((row, write))
        return new
    dev = s0.mesh.device(0, 0)
    wholes = [s.full(dev) for s in layers]
    row = torch.cat([w.reshape(-1).float() for w in wholes])[None]

    def write(flat):
        o = 0
        for li, (s, w) in enumerate(zip(layers, wholes)):
            v = flat[0, o:o + w.numel()].reshape(w.shape).to(w.dtype)
            o += w.numel()
            pos = {id(p): i for i, p in enumerate(s.distinct())}
            for blk, ts in s.groups():
                for t in ts:
                    new[li][pos[id(t)]] = \
                        narrow_block(v, blk).to(t.device).contiguous()
    jobs.append((row, write))
    return new


def quantize_grads(grads: GradTree, bits: int = 8) -> GradTree:
    """Paper §3.4 applied to the aggregation payload: blockwise-int8
    round-trip of the gradient tree (what crosses the wire in a FedCD
    round). Each leaf — a stacked leaf given as its per-layer parts too —
    is flattened to ONE float32 row (exact for bfloat16) in the stacked
    leaf's memory order; leaves of fewer than 128 values and scalars pass
    through. A sharded leaf keeps those blocks (module docstring). The
    rows go through one ``quantize_group`` and one ``dequantize_group``
    call per device: on the card one launch of each kernel (per 32
    leaves), on CPU tensors their plain versions. The result has each
    part's shape, dtype and layout."""
    jobs: list = []
    pending = []
    out: GradTree = dict(grads)
    for k, g in grads.items():
        parts = _parts(g)
        n = sum(p.numel() for p in parts)
        if (len(parts) == 1 and parts[0].dim() == 0) or n < 128:
            continue
        if isinstance(parts[0], Sharded):
            pending.append((k, parts, _sharded_jobs(parts, jobs)))
            continue
        row = (torch.cat([p.reshape(-1).float() for p in parts])[None]
               if len(parts) > 1 else
               parts[0].reshape(1, -1).float().contiguous())

        def write(flat, k=k, parts=parts):
            pieces, o = [], 0
            for p in parts:
                pieces.append(flat[0, o:o + p.numel()].reshape(p.shape)
                              .to(p.dtype))
                o += p.numel()
            out[k] = pieces[0] if isinstance(grads[k], torch.Tensor) \
                else pieces
        jobs.append((row, write))
    by_device: Dict[torch.device, List[int]] = {}
    for i, (row, _) in enumerate(jobs):
        # the tensor's own device: a mesh may name one card as "cuda"
        # and as "cuda:0"
        by_device.setdefault(row.device, []).append(i)
    for idx in by_device.values():
        rows = [jobs[i][0] for i in idx]
        qs, ss = q_ops.quantize_group(rows, bits)
        flats = q_ops.dequantize_group(qs, ss, [r.shape[1] for r in rows])
        for i, flat in zip(idx, flats):
            jobs[i][1](flat)
    for k, parts, new in pending:
        done = [s.with_pieces(t) for s, t in zip(parts, new)]
        out[k] = done[0] if isinstance(grads[k], Sharded) else done
    return out


def _targets(params) -> GradTree:
    """``params`` with each stacked leaf as its per-layer views."""
    out: GradTree = {}
    for k, v in params.items():
        depth = tf.stacked_depth(k)
        if not depth:
            out[k] = v
        elif isinstance(v, Sharded):
            out[k] = v.layers(depth)
        else:
            out[k] = tf.layer_views(v, depth)
    return out


def _detached(p: Part) -> Part:
    if isinstance(p, Sharded):
        return p.map(lambda t: t.detach().requires_grad_())
    return p.detach().requires_grad_()


def _grad_leaves(params) -> GradTree:
    """Leaves to differentiate: detached views of ``params`` that require
    grad, a stacked leaf as its per-layer views (a sharded leaf's
    distinct pieces each)."""
    return {k: ([_detached(p) for p in v] if isinstance(v, list)
                else _detached(v))
            for k, v in _targets(params).items()}


def _flat(tree: GradTree) -> List[torch.Tensor]:
    return [t for g in tree.values() for p in _parts(g)
            for t in _tensors(p)]


def _cells(tree: GradTree) -> List[Tuple[int, int]]:
    """The cell of each tensor of ``_flat(tree)``: a piece's first
    holder, a whole tensor's ``(0, 0)``."""
    return [cell for g in tree.values() for p in _parts(g)
            for cell in ([(0, 0)] if isinstance(p, torch.Tensor) else
                         [c for c, _ in p.holders()])]


def _unflat(tree: GradTree, flat: Sequence[torch.Tensor]) -> GradTree:
    """``flat`` (aligned with ``_flat(tree)``) in ``tree``'s structure; a
    sharded part's copies of one block take their group's summed
    gradient."""
    out: GradTree = {}
    i = 0
    for k, g in tree.items():
        parts = []
        for p in _parts(g):
            n = len(_tensors(p))
            if isinstance(p, Sharded):
                parts.append(reduce_replicas(p.with_pieces(flat[i:i + n])))
            else:
                parts.append(flat[i])
            i += n
        out[k] = parts if isinstance(g, list) else parts[0]
    return out


def _grads(total: torch.Tensor, flat: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """d total / d flat; a piece no cell computed with (a replicated
    leaf's copy on a device that only holds it) gets zeros."""
    gs = torch.autograd.grad(total, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, gs)]


def make_train_step(cfg: ArchConfig, mesh=None,
                    dp_axes: Tuple[str, ...] = ("data",),
                    lr: float = 1e-2, remat: Union[bool, str] = True,
                    microbatches: int = 1, hints: bool = False,
                    grad_transport_bits: int = 0) -> Callable:
    """FedCD mode-B round step.

    step(params, tokens (B,S), labels (B,S), client_scores (n_clients,)
         [, frames]) -> (params, metrics)

    ``params`` is updated in place (module docstring). ``remat``
    recomputes each layer in the backward pass (``True`` / ``"full"``, or
    ``"dots"``: ``models.common.remat_call``); ``microbatches`` splits
    the batch and sums the float32 gradients, as the reference's scan;
    ``grad_transport_bits=8`` compresses the aggregated update before the
    parameter update (transport-compressed FedCD round, paper §3.4).
    ``mesh``: the tensor-parallel forward (module docstring); ``hints``
    sets the sharding-hint context for the step."""

    def step(params: Params, tokens, labels, client_scores, frames=None):
        with sharding_hints(mesh if hints else None, dp_axes):
            return _step_body(params, tokens, labels, client_scores, frames)

    def _step_body(params, tokens, labels, client_scores, frames):
        B = tokens.shape[0]
        row_w = client_weights_per_row(client_scores, B)
        leaves = _grad_leaves(params)
        flat = _flat(leaves)
        if microbatches == 1:
            total, (loss, aux) = _lm_loss(cfg, leaves, tokens, labels,
                                          row_w, mesh, dp_axes,
                                          frames=frames, remat=remat)
            grads = _grads(total, flat)
        else:
            mb = B // microbatches
            grads = [torch.zeros(p.shape, device=p.device) for p in flat]
            loss = aux = torch.zeros((), device=tokens.device)
            for i in range(microbatches):
                sl = slice(i * mb, (i + 1) * mb)
                total, (l_mb, a) = _lm_loss(
                    cfg, leaves, tokens[sl], labels[sl], row_w[sl], mesh,
                    dp_axes, frames=None if frames is None else frames[sl],
                    remat=remat)
                gs = _grads(total, flat)
                grads = [acc + g for acc, g in zip(grads, gs)]
                loss, aux = loss + l_mb.detach(), aux + a.detach()
        gtree = _unflat(leaves, grads)
        if grad_transport_bits:
            gtree = quantize_grads(gtree, grad_transport_bits)
        targets = _targets(params)
        for cell, pair in zip(_cells(targets),
                              zip(_flat(targets), _flat(gtree))):
            with on_cell(*cell):
                sgd_update_([pair], lr)
        return params, {"loss": loss.detach(), "aux": aux.detach()}

    return step


def make_eval_step(cfg: ArchConfig, n_clients: int, mesh=None,
                   dp_axes: Tuple[str, ...] = ("data",)) -> Callable:
    """Per-client validation loss — feeds the FedCD score update (eq 2)."""

    @torch.no_grad()
    def step(params, tokens, labels, frames=None):
        logits, _, _ = _forward(cfg, params, tokens, frames, mesh=mesh,
                                dp_axes=dp_axes)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = (logz - gold).mean(dim=-1)                       # (B,)
        B = tokens.shape[0]
        return nll.reshape(n_clients, B // n_clients).mean(dim=-1)

    return step


def make_prefill_step(cfg: ArchConfig, window: int = 0, mesh=None,
                      dp_axes: Tuple[str, ...] = ("data",),
                      hints: bool = False) -> Callable:
    """Chunked cache-filling prefill: one call appends a whole token
    chunk to every layer cache.

    step(params, caches, tokens (B,S), n_valid) ->
        (next-token logits (B,V) at the last valid position, caches)

    Callers loop fixed-shape chunks over the prompt, padding the ragged
    tail and passing ``n_valid`` (an int or a 0-d tensor; read on the
    device, as the reference's clamped ``dynamic_slice``). With a
    ring-buffer window the chunk must satisfy S <= window. ``mesh`` /
    ``dp_axes``: the decode path on a tensor-parallel mesh (module
    docstring); ``hints`` sets the sharding-hint context."""
    if cfg.family == "audio":
        raise ValueError("audio uses the encdec driver paths in examples/")

    @torch.no_grad()
    def step(params, caches, tokens, n_valid):
        with sharding_hints(mesh if hints else None, dp_axes):
            S = tokens.shape[1]
            nv = torch.as_tensor(n_valid, dtype=torch.int32,
                                 device=tokens.device)
            logits, caches = tf.lm_prefill(cfg, params, tokens, caches,
                                           window=window, n_valid=nv,
                                           mesh=mesh, dp_axes=dp_axes)
            last = torch.clamp(nv - 1, 0, S - 1).long().reshape(1)
            return torch.index_select(logits, 1, last.to(logits.device)
                                      )[:, 0, :], caches

    return step


def make_serve_step(cfg: ArchConfig, window: int = 0, mesh=None,
                    dp_axes: Tuple[str, ...] = ("data",),
                    hints: bool = False) -> Callable:
    """One-token batched decode against a KV/state cache (the
    encoder-decoder model's for an audio config; on a ``mesh`` with its
    params gathered whole on cell ``(0, 0)``).

    step(params, caches, tokens (B,1)) -> (logits (B,V), caches)"""

    @torch.no_grad()
    def step(params, caches, tokens):
        with sharding_hints(mesh if hints else None, dp_axes):
            if cfg.family == "audio":
                if mesh is not None:
                    home = mesh.device(0, 0)
                    params = {k: v.full(home) if isinstance(v, Sharded)
                              else v.to(home) for k, v in params.items()}
                logits, caches = ed.encdec_decode(cfg, params, tokens,
                                                  caches, window)
            else:
                logits, caches = tf.lm_decode(cfg, params, tokens, caches,
                                              window=window, mesh=mesh,
                                              dp_axes=dp_axes)
            return logits[:, -1, :], caches

    return step
