"""Step builders for training (the FedCD mode-B round), prefill and
decode (port of ``repro/launch/steps.py``, whole: ``client_weights_per_row``,
``_lm_loss`` with its audio and MTP branches, ``quantize_grads``,
``make_train_step``, ``make_eval_step``, ``make_prefill_step`` and
``make_serve_step``; a ``mesh`` is ROADMAP item 13b.4).

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
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.common import Params
from repro_torch.optim import sgd_update_

GradTree = Dict[str, Union[torch.Tensor, List[torch.Tensor]]]


def client_weights_per_row(client_scores: torch.Tensor, batch: int
                           ) -> torch.Tensor:
    """Expand per-client FedCD scores c_i to per-row loss weights that sum
    to 1 (eq 1 numerator/denominator in one step)."""
    n_clients = client_scores.shape[0]
    per = batch // n_clients
    w = torch.repeat_interleave(client_scores, per)            # (B,)
    return w / torch.clamp(torch.sum(w), min=1e-12)


def _forward(cfg: ArchConfig, params, tokens, frames, remat=False):
    """(logits, hidden, aux): the encoder-decoder model on ``frames``
    for an audio config (aux 0), else the decoder-only LM."""
    if cfg.family == "audio":
        logits, hidden = ed.encdec_forward(cfg, params, frames, tokens,
                                           remat=remat)
        return logits, hidden, torch.zeros((), device=logits.device)
    return tf.lm_forward(cfg, params, tokens, remat=remat)


def _lm_loss(cfg: ArchConfig, params, tokens, labels, row_w, mesh=None,
             dp_axes=("data",), frames=None, remat=True):
    """Score-weighted next-token loss, plus DeepSeek's MTP loss (weight
    0.3) where the model has an MTP head. Returns (loss + aux, (loss,
    aux))."""
    if mesh is not None:
        raise NotImplementedError(tf.MESH_13B4)
    logits, hidden, aux = _forward(cfg, params, tokens, frames, remat)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (logz - gold).mean(dim=-1)                           # (B,)
    loss = torch.sum(nll * row_w)
    if cfg.mtp and any(k.startswith("mtp.") for k in params):
        # predict t+2: condition on emb(t+1)=labels, target labels shifted
        mtp_lg = tf.mtp_logits(cfg, params, hidden, labels)
        mtp_labels = torch.roll(labels, -1, 1).long()
        lz = torch.logsumexp(mtp_lg, dim=-1)
        gd = torch.gather(mtp_lg, -1, mtp_labels[..., None])[..., 0]
        mask = torch.ones(labels.shape, device=lz.device)
        mask[:, -1] = 0.0
        mtp_nll = (((lz - gd) * mask).sum(-1)
                   / torch.clamp(mask.sum(-1), min=1.0))
        loss = loss + 0.3 * torch.sum(mtp_nll * row_w)
    return loss + aux, (loss, aux)


def _parts(g: Union[torch.Tensor, Sequence[torch.Tensor]]
           ) -> List[torch.Tensor]:
    return [g] if isinstance(g, torch.Tensor) else list(g)


def quantize_grads(grads: GradTree, bits: int = 8) -> GradTree:
    """Paper §3.4 applied to the aggregation payload: blockwise-int8
    round-trip of the gradient tree (what crosses the wire in a FedCD
    round). Each leaf — a stacked leaf given as its per-layer parts too —
    is flattened to ONE float32 row (exact for bfloat16) in the stacked
    leaf's memory order; leaves of fewer than 128 values and scalars pass
    through. Every other leaf goes through one ``quantize_group`` and one
    ``dequantize_group`` call: on the card one launch of each kernel (per
    32 leaves), on CPU tensors their plain versions. The result has each
    part's shape and dtype."""
    names, rows = [], []
    for k, g in grads.items():
        parts = _parts(g)
        n = sum(p.numel() for p in parts)
        if (len(parts) == 1 and parts[0].dim() == 0) or n < 128:
            continue
        names.append(k)
        rows.append(torch.cat([p.reshape(-1).float() for p in parts])[None]
                    if len(parts) > 1 else
                    parts[0].reshape(1, -1).float().contiguous())
    qs, ss = q_ops.quantize_group(rows, bits)
    outs = q_ops.dequantize_group(qs, ss, [r.shape[1] for r in rows])
    out: GradTree = dict(grads)
    for k, flat in zip(names, outs):
        parts, pieces, o = _parts(grads[k]), [], 0
        for p in parts:
            pieces.append(flat[0, o:o + p.numel()].reshape(p.shape)
                          .to(p.dtype))
            o += p.numel()
        out[k] = pieces[0] if isinstance(grads[k], torch.Tensor) else pieces
    return out


def _targets(params: Params) -> GradTree:
    """``params`` with each stacked leaf as its per-layer views."""
    out: GradTree = {}
    for k, v in params.items():
        depth = tf.stacked_depth(k)
        out[k] = tf.layer_views(v, depth) if depth else v
    return out


def _grad_leaves(params: Params) -> GradTree:
    """Leaves to differentiate: detached views of ``params`` that require
    grad, a stacked leaf as its per-layer views."""
    return {k: ([p.detach().requires_grad_() for p in v]
                if isinstance(v, list) else v.detach().requires_grad_())
            for k, v in _targets(params).items()}


def _flat(tree: GradTree) -> List[torch.Tensor]:
    return [p for g in tree.values() for p in _parts(g)]


def _unflat(tree: GradTree, flat: Sequence[torch.Tensor]) -> GradTree:
    out, i = {}, 0
    for k, g in tree.items():
        n = len(_parts(g))
        out[k] = flat[i] if isinstance(g, torch.Tensor) else \
            list(flat[i:i + n])
        i += n
    return out


def make_train_step(cfg: ArchConfig, mesh=None,
                    dp_axes: Tuple[str, ...] = ("data",),
                    lr: float = 1e-2, remat: bool = True,
                    microbatches: int = 1,
                    grad_transport_bits: int = 0) -> Callable:
    """FedCD mode-B round step.

    step(params, tokens (B,S), labels (B,S), client_scores (n_clients,)
         [, frames]) -> (params, metrics)

    ``params`` is updated in place (module docstring). ``remat``
    recomputes each layer in the backward pass; ``microbatches`` splits
    the batch and sums the float32 gradients, as the reference's scan;
    ``grad_transport_bits=8`` compresses the aggregated update before the
    parameter update (transport-compressed FedCD round, paper §3.4)."""
    if mesh is not None:
        raise NotImplementedError(tf.MESH_13B4)

    def step(params: Params, tokens, labels, client_scores, frames=None):
        B = tokens.shape[0]
        row_w = client_weights_per_row(client_scores, B)
        leaves = _grad_leaves(params)
        flat = _flat(leaves)
        if microbatches == 1:
            total, (loss, aux) = _lm_loss(cfg, leaves, tokens, labels,
                                          row_w, frames=frames, remat=remat)
            grads = list(torch.autograd.grad(total, flat))
        else:
            mb = B // microbatches
            grads = [torch.zeros(p.shape, device=p.device) for p in flat]
            loss = aux = torch.zeros((), device=tokens.device)
            for i in range(microbatches):
                sl = slice(i * mb, (i + 1) * mb)
                total, (l_mb, a) = _lm_loss(
                    cfg, leaves, tokens[sl], labels[sl], row_w[sl],
                    frames=None if frames is None else frames[sl],
                    remat=remat)
                gs = torch.autograd.grad(total, flat)
                grads = [acc + g for acc, g in zip(grads, gs)]
                loss, aux = loss + l_mb.detach(), aux + a.detach()
        gtree = _unflat(leaves, grads)
        if grad_transport_bits:
            gtree = quantize_grads(gtree, grad_transport_bits)
        sgd_update_(zip(_flat(_targets(params)), _flat(gtree)), lr)
        return params, {"loss": loss.detach(), "aux": aux.detach()}

    return step


def make_eval_step(cfg: ArchConfig, n_clients: int, mesh=None,
                   dp_axes: Tuple[str, ...] = ("data",)) -> Callable:
    """Per-client validation loss — feeds the FedCD score update (eq 2)."""
    if mesh is not None:
        raise NotImplementedError(tf.MESH_13B4)

    @torch.no_grad()
    def step(params, tokens, labels, frames=None):
        logits, _, _ = _forward(cfg, params, tokens, frames)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = (logz - gold).mean(dim=-1)                       # (B,)
        B = tokens.shape[0]
        return nll.reshape(n_clients, B // n_clients).mean(dim=-1)

    return step


def make_prefill_step(cfg: ArchConfig, window: int = 0, mesh=None,
                      dp_axes: Tuple[str, ...] = ("data",)) -> Callable:
    """Chunked cache-filling prefill: one call appends a whole token
    chunk to every layer cache.

    step(params, caches, tokens (B,S), n_valid) ->
        (next-token logits (B,V) at the last valid position, caches)

    Callers loop fixed-shape chunks over the prompt, padding the ragged
    tail and passing ``n_valid`` (an int or a 0-d tensor; read on the
    device, as the reference's clamped ``dynamic_slice``). With a
    ring-buffer window the chunk must satisfy S <= window."""
    if cfg.family == "audio":
        raise ValueError("audio uses the encdec driver paths in examples/")
    if mesh is not None:
        raise NotImplementedError(tf.MESH_13B4)

    @torch.no_grad()
    def step(params, caches, tokens, n_valid):
        S = tokens.shape[1]
        nv = torch.as_tensor(n_valid, dtype=torch.int32,
                             device=tokens.device)
        logits, caches = tf.lm_prefill(cfg, params, tokens, caches,
                                       window=window, n_valid=nv)
        last = torch.clamp(nv - 1, 0, S - 1).long().reshape(1)
        return torch.index_select(logits, 1, last)[:, 0, :], caches

    return step


def make_serve_step(cfg: ArchConfig, window: int = 0, mesh=None,
                    dp_axes: Tuple[str, ...] = ("data",)) -> Callable:
    """One-token batched decode against a KV/state cache (the
    encoder-decoder model's for an audio config).

    step(params, caches, tokens (B,1)) -> (logits (B,V), caches)"""
    if mesh is not None:
        raise NotImplementedError(tf.MESH_13B4)

    @torch.no_grad()
    def step(params, caches, tokens):
        if cfg.family == "audio":
            logits, caches = ed.encdec_decode(cfg, params, tokens, caches,
                                              window)
        else:
            logits, caches = tf.lm_decode(cfg, params, tokens, caches,
                                          window=window)
        return logits[:, -1, :], caches

    return step
