"""Mamba2 block (SSD — state space duality, arXiv:2405.21060) for zamba2
(port of ``repro/models/mamba2.py``).

Training/prefill uses the chunked SSD algorithm: the sequence is split
into chunks of length ``Q = min(chunk, S)`` (zero padded to a multiple
of ``Q``); intra-chunk terms are dense products over a ``(B, Q, Q, H)``
float32 decay matrix and inter-chunk terms propagate an ``(B, H, P, N)``
float32 state. The reference scans the chunks with ``lax.scan``; here it
is a Python loop over chunks, with the same carries in float32.

Decode keeps the recurrent state ``(B, H, P, N)`` and advances it one
token per step: ``h' = exp(A dt) h + dt * B x``; ``y = C h + D x``.

Numerics kept from the reference: the decay's upper triangle is set to
``-1e30`` BEFORE ``exp`` (exp of it overflows, and a ``where`` after it
would still carry NaN into the gradient); grouped B/C heads repeat each
group (``repeat_interleave``, the reference's ``jnp.repeat``); the causal
convolution sums its taps in the reference's order (``F.conv1d`` would
let cuDNN reorder the sum); ``softplus`` is ``logaddexp(x, 0)``, as
``jax.nn.softplus``. ``A_log``, ``D`` and ``dt_bias`` are float32 leaves
in every model.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models.common import (Params, init_rmsnorm, normal_init,
                                       prefixed, rmsnorm, subtree)

NEG_INF = -1e30


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return s, d_in, n_heads


def init_mamba2(generator: torch.Generator, cfg: ArchConfig, dtype,
                device=None) -> Params:
    s, d_in, H = _dims(cfg)
    G, N = s.n_groups, s.state_dim
    conv_dim = d_in + 2 * G * N
    p: Params = {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": normal_init(generator, (cfg.d_model, 2 * d_in + 2 * G * N
                                        + H), dtype, device=device),
        "conv_w": normal_init(generator, (s.conv_width, conv_dim), dtype,
                              stddev=0.1, device=device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H)).to(device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        **prefixed("norm", init_rmsnorm(d_in, dtype, device)),
        "w_out": normal_init(generator, (d_in, cfg.d_model), dtype,
                             device=device),
    }
    return dict(sorted(p.items()))


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    s, d_in, H = _dims(cfg)
    G, N = s.n_groups, s.state_dim
    z, rest = proj[..., :d_in], proj[..., d_in:]
    xbc, dt = rest[..., :d_in + 2 * G * N], rest[..., d_in + 2 * G * N:]
    return z, xbc, dt  # dt: (..., H)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. xbc (B,S,D); w (W,D). Returns (y, new_state).
    The taps are summed in order from 0, as the reference's ``sum``."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else pad
    return F.silu(y + b), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x (B,S,H,P), dt (B,S,H) f32, A (H,) f32 (negative), Bm/Cm (B,S,G,N).
    Returns (y (B,S,H,P), h_final (B,H,P,N) f32).
    """
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    S_ = x.shape[1]
    nc = S_ // Q
    rep = H // G
    xc = x.reshape(Bsz, nc, Q, H, Pd)
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = torch.repeat_interleave(Bm.reshape(Bsz, nc, Q, G, N), rep, dim=3)
    Cc = torch.repeat_interleave(Cm.reshape(Bsz, nc, Q, G, N), rep, dim=3)
    Af = A.float()  # (H,) negative
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for c in range(nc):
        xq, dtq = xc[:, c].float(), dtc[:, c]     # (B,Q,H,P), (B,Q,H)
        Bq, Cq = Bc[:, c].float(), Cc[:, c].float()  # (B,Q,H,N)
        dA = dtq * Af                             # (B,Q,H) log-decay
        cum = torch.cumsum(dA, dim=1)             # (B,Q,H)
        total = cum[:, -1]                        # (B,H)
        # intra-chunk (quadratic within chunk, Q x Q), i >= j:
        li = cum[:, :, None, :] - cum[:, None, :, :]      # (B,Q,Q,H)
        # mask BEFORE exp: exp of the (positive, growing) upper triangle
        # overflows and a where() after it would backprop NaN through it
        li = torch.where(mask[None, :, :, None], li, NEG_INF)
        decay = torch.exp(li)
        cb = torch.einsum("bihn,bjhn->bijh", Cq, Bq)
        att = cb * decay * dtq[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", att, xq)
        # contribution of the carried state:
        state_decay = torch.exp(cum)                        # (B,Q,H)
        y_inter = torch.einsum("bihn,bhpn->bihp",
                               Cq * state_decay[..., None], h)
        # new state:
        w = torch.exp(total[:, None] - cum)                 # (B,Q,H)
        dBx = torch.einsum("bqhn,bqhp->bhpn", Bq * (dtq * w)[..., None], xq)
        h = h * torch.exp(total)[..., None, None] + dBx
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, S_, H, Pd)[:, :S]
    return y.to(x.dtype), h


def mamba2_forward(params: Params, cfg: ArchConfig, u: torch.Tensor
                   ) -> torch.Tensor:
    """Full-sequence forward. u (B,S,d_model)."""
    s, d_in, H = _dims(cfg)
    G, N = s.n_groups, s.state_dim
    proj = torch.matmul(u, params["w_in"])
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, _ = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    B, S = xbc.shape[:2]
    x = xbc[..., :d_in]
    Bm = xbc[..., d_in:d_in + G * N].reshape(B, S, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(B, S, G, N)
    dt = _softplus(dt.float() + params["dt_bias"])
    xh = x.reshape(B, S, H, s.head_dim)
    A = -torch.exp(params["A_log"])
    y, _ = _ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    y = y + xh * params["D"][:, None].to(y.dtype)
    y = y.reshape(B, S, d_in)
    y = rmsnorm(subtree(params, "norm"), y * F.silu(z), cfg.norm_eps)
    return torch.matmul(y, params["w_out"])


def init_mamba2_cache(cfg: ArchConfig, batch: int, dtype,
                      device=None) -> Params:
    s, d_in, H = _dims(cfg)
    G, N = s.n_groups, s.state_dim
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, d_in + 2 * G * N),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, N), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(params: Params, cfg: ArchConfig, u: torch.Tensor,
                  cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode. u (B,1,d_model); O(1) state update."""
    s, d_in, H = _dims(cfg)
    G, N = s.n_groups, s.state_dim
    proj = torch.matmul(u, params["w_in"])
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_new = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 state=cache["conv"])
    B = xbc.shape[0]
    x = xbc[..., :d_in]
    Bm = xbc[..., d_in:d_in + G * N].reshape(B, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(B, G, N)
    dt = _softplus(dt.float() + params["dt_bias"])[:, 0]         # (B,H)
    xh = x[:, 0].reshape(B, H, s.head_dim).float()
    A = -torch.exp(params["A_log"])
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=1).float()          # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).float()
    decay = torch.exp(dt * A)                                      # (B,H)
    h = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bhn,bhp->bhpn", Bh * dt[..., None], xh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + xh * params["D"][:, None]
    y = y.reshape(B, 1, d_in).to(u.dtype)
    y = rmsnorm(subtree(params, "norm"), y * F.silu(z), cfg.norm_eps)
    out = torch.matmul(y, params["w_out"])
    return out, {"conv": conv_new, "ssm": h}


def select_step(states: Params, n_keep, time_axis: int) -> Params:
    """Each state of ``states`` at index ``n_keep - 1`` of ``time_axis``
    (the index clamped into range, as ``lax.dynamic_index_in_dim``'s);
    ``n_keep`` may be a tensor on the states' device (no host read)."""
    out = {}
    for k, s in states.items():
        i = torch.as_tensor(n_keep, device=s.device).long().reshape(1) - 1
        i = torch.clamp(i, 0, s.shape[time_axis] - 1)
        out[k] = torch.index_select(s, time_axis, i).squeeze(time_axis)
    return out


def mamba2_rollback(states: Params, n_keep, time_axis: int) -> Params:
    """Select the recurrent state after ``n_keep`` consumed tokens from
    a speculative verify's per-step collected states (DESIGN.md §16).
    ``states`` stacks the POST-update state of every chunk step on
    ``time_axis``, so step ``n_keep - 1`` (``n_keep >= 1``: the current
    token is always consumed) is the state an ``n_keep``-token prefill
    would have left behind."""
    return select_step(states, n_keep, time_axis)
