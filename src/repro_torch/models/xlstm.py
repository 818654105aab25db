"""xLSTM blocks (arXiv:2405.04517; port of ``repro/models/xlstm.py``):
mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar memory,
sequential).

mLSTM uses the stabilized chunkwise formulation: within a chunk of
length ``Q = min(chunk, S)`` the gate-decay matrix is dense ``(B, Q, Q,
H)`` float32; across chunks a matrix state ``C (B,H,dk,dv)``, normalizer
``n (B,H,dk)`` and log-scale ``m (B,H)`` are carried in float32 (the
reference's ``lax.scan`` over chunks is a Python loop here). Padding
gives the input gate ``-1e30`` and the forget gate 0; the ``tril`` mask
goes on before ``exp``; the row stabilizer is the reference's (``m_row``
with a ``-1e30`` floor, ``denom = max(|qn|, exp(-m_row))``); maxima are
``torch.amax`` / ``torch.maximum``, which split a tie's gradient evenly
as ``jnp.max`` / ``jnp.maximum`` do. The score scale is the float32
``1 / sqrt(dh)`` the reference computes, multiplied in.

sLSTM is inherently sequential (recurrent gate mixing): training loops
over time steps, its recurrent product in float32. ``jax.nn.gelu`` is
the tanh approximation, ``F.gelu(..., approximate="tanh")`` here.
``f_bias`` is a float32 leaf in every model, in both blocks.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models.common import (Params, init_layernorm, init_rmsnorm,
                                       layernorm, normal_init, prefixed,
                                       rmsnorm, subtree)
from repro_torch.models.mamba2 import NEG_INF, select_step


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mlstm_dims(cfg: ArchConfig):
    di = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    H = cfg.n_heads
    dh = di // H
    return di, H, dh


def init_mlstm(generator: torch.Generator, cfg: ArchConfig, dtype,
               device=None) -> Params:
    di, H, dh = _mlstm_dims(cfg)
    d = cfg.d_model

    def w(shape, stddev=0.02):
        return normal_init(generator, shape, dtype, stddev, device=device)

    p: Params = {
        "w_up": w((d, di)),
        "w_gate": w((d, di)),
        "conv_w": w((cfg.xlstm.conv_width, di), 0.1),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "wq": w((di, di)),
        "wk": w((di, di)),
        "wv": w((di, di)),
        "w_i": w((di, H)),
        "w_f": w((di, H)),
        "f_bias": torch.full((H,), 3.0, dtype=torch.float32, device=device),
        **prefixed("norm", init_rmsnorm(di, dtype, device)),
        "w_down": w((di, d)),
    }
    return dict(sorted(p.items()))


def _causal_conv1d(x, w, b, state=None):
    W = w.shape[0]
    pad = (torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device) if state is None else state)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return F.silu(y + b), xp[:, -(W - 1):]


def _scale(dh: int, device) -> torch.Tensor:
    # the reference's 1.0 / jnp.sqrt(float(dh)): a float32 square root and
    # a float32 reciprocal (1/math.sqrt(dh) rounds differently at dh=384)
    return (1.0 / torch.sqrt(torch.tensor(float(dh)))).to(device)


def _mlstm_inner_chunked(q, k, v, logi, logf, chunk, state=None):
    """q,k,v (B,S,H,dh); logi/logf (B,S,H) fp32. Returns (y, state)."""
    B, S, H, dh = q.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=NEG_INF)
        logf = F.pad(logf, (0, 0, 0, pad))
    S_ = q.shape[1]
    nc = S_ // Q
    dev = q.device
    qc = q.reshape(B, nc, Q, H, dh).float()
    kc = k.reshape(B, nc, Q, H, dh).float()
    vc = v.reshape(B, nc, Q, H, dh).float()
    ic = logi.reshape(B, nc, Q, H)
    fc = logf.reshape(B, nc, Q, H)
    scale = _scale(dh, dev)
    floor = torch.full((), NEG_INF, device=dev)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    if state is None:
        C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
        m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    else:
        C, n, m = state["C"], state["n"], state["m"]
    ys = []
    for c in range(nc):
        qq, kk, vv = qc[:, c], kc[:, c], vc[:, c]
        li, lf = ic[:, c], fc[:, c]
        cumf = torch.cumsum(lf, dim=1)                       # (B,Q,H)
        # intra-chunk log weights a_ij = cumf_i - cumf_j + li_j (j <= i)
        a = cumf[:, :, None, :] - cumf[:, None, :, :] + li[:, None, :, :]
        a = torch.where(tri[None, :, :, None], a, NEG_INF)
        b = cumf + m[:, None, :]                   # carry log-scale (B,Q,H)
        m_row = torch.maximum(torch.amax(a, dim=2), b)       # (B,Q,H)
        m_row = torch.maximum(m_row, floor)
        dmat = torch.exp(a - m_row[:, :, None, :])           # (B,Q,Q,H)
        bsc = torch.exp(b - m_row)                           # (B,Q,H)
        s = torch.einsum("bihd,bjhd->bijh", qq, kk) * scale
        y_intra = torch.einsum("bijh,bjhd->bihd", s * dmat, vv)
        y_inter = torch.einsum("bihk,bhkv->bihv", qq * bsc[..., None],
                               C) * scale
        denom_intra = torch.einsum("bijh,bjhd->bihd", dmat,
                                   kk)  # sum_j w_ij k_j
        qn = torch.einsum("bihd,bihd->bih", qq, denom_intra) * scale
        qn = qn + torch.einsum("bihk,bhk->bih", qq * bsc[..., None],
                               n) * scale
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_row))
        ys.append((y_intra + y_inter) / denom[..., None])
        # state update
        ftot = cumf[:, -1]                                   # (B,H)
        w_log = ftot[:, None] - cumf + li                    # (B,Q,H)
        m_new = torch.maximum(ftot + m, torch.amax(w_log, dim=1))
        wts = torch.exp(w_log - m_new[:, None])
        carry = torch.exp(ftot + m - m_new)
        C = (C * carry[..., None, None]
             + torch.einsum("bqhk,bqhv->bhkv", kk * wts[..., None], vv))
        n = (n * carry[..., None]
             + torch.einsum("bqhk,bqh->bhk", kk, wts))
        m = m_new
    y = torch.stack(ys, dim=1).reshape(B, S_, H, dh)[:, :S]
    return y.to(v.dtype), {"C": C, "m": m, "n": n}


def _mlstm_qkvif(params, cfg, x, conv_state=None):
    di, H, dh = _mlstm_dims(cfg)
    up = torch.matmul(x, params["w_up"])
    z = torch.matmul(x, params["w_gate"])
    c, conv_new = _causal_conv1d(up, params["conv_w"], params["conv_b"],
                                 conv_state)
    B, S, _ = x.shape
    q = torch.matmul(c, params["wq"]).reshape(B, S, H, dh)
    k = torch.matmul(c, params["wk"]).reshape(B, S, H, dh)
    v = torch.matmul(up, params["wv"]).reshape(B, S, H, dh)
    logi = torch.matmul(c, params["w_i"]).float()
    logf = F.logsigmoid(torch.matmul(c, params["w_f"]).float()
                        + params["f_bias"])
    return q, k, v, logi, logf, z, conv_new


def mlstm_forward(params: Params, cfg: ArchConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    di, H, dh = _mlstm_dims(cfg)
    q, k, v, logi, logf, z, _ = _mlstm_qkvif(params, cfg, x)
    y, _ = _mlstm_inner_chunked(q, k, v, logi, logf, cfg.xlstm.chunk)
    y = y.reshape(*y.shape[:2], di)
    y = rmsnorm(subtree(params, "norm"), y, cfg.norm_eps) * F.silu(z)
    return torch.matmul(y, params["w_down"])


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype,
                     device=None) -> Params:
    di, H, dh = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, dh, dh), **f32),
        "conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, di),
                            dtype=dtype, device=device),
        "m": torch.full((batch, H), NEG_INF, **f32),
        "n": torch.zeros((batch, H, dh), **f32),
    }


def mlstm_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode via the same chunked inner with Q=1 chunk."""
    di, H, dh = _mlstm_dims(cfg)
    q, k, v, logi, logf, z, conv_new = _mlstm_qkvif(
        params, cfg, x, conv_state=cache["conv"])
    state = {"C": cache["C"], "n": cache["n"], "m": cache["m"]}
    y, st = _mlstm_inner_chunked(q, k, v, logi, logf, 1, state=state)
    y = y.reshape(*y.shape[:2], di)
    y = rmsnorm(subtree(params, "norm"), y, cfg.norm_eps) * F.silu(z)
    out = torch.matmul(y, params["w_down"])
    return out, {**st, "conv": conv_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def _slstm_dims(cfg: ArchConfig):
    d, H = cfg.d_model, cfg.n_heads
    return d, H, d // H


def init_slstm(generator: torch.Generator, cfg: ArchConfig, dtype,
               device=None) -> Params:
    d, H, dh = _slstm_dims(cfg)
    dff = int(cfg.xlstm.proj_factor_slstm * d)
    p: Params = {
        "w_in": normal_init(generator, (d, 4 * d), dtype,
                            device=device),        # z,i,f,o pre-acts
        "r": normal_init(generator, (4, H, dh, dh), dtype, stddev=0.01,
                         device=device),
        "f_bias": torch.full((H, dh), 3.0, dtype=torch.float32,
                             device=device),
        **prefixed("norm", init_layernorm(d, dtype, device)),
        "w_ff1": normal_init(generator, (d, dff), dtype, device=device),
        "w_ff2": normal_init(generator, (dff, d), dtype, device=device),
    }
    return dict(sorted(p.items()))


def _slstm_cell(params, cfg, pre, state):
    """pre (B,4,H,dh) fp32; state (c, n, m, h), each (B,H,dh) fp32."""
    c, n, m, h = state
    r = params["r"].float()
    rec = torch.einsum("bhk,ghkl->bghl", h, r)              # (B,4,H,dh)
    z_p, i_p, f_p, o_p = [pre[:, g] + rec[:, g] for g in range(4)]
    f_p = f_p + params["f_bias"]
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    m_new = torch.maximum(f_p + m, i_p)
    i = torch.exp(i_p - m_new)
    f = torch.exp(f_p + m - m_new)
    c_new = f * c + i * z
    n_new = torch.maximum(f * n + i, torch.full((), 1e-6, device=n.device))
    h_new = o * c_new / n_new
    return (c_new, n_new, m_new, h_new)


def _slstm_ffn(params, cfg, h):
    h = layernorm(subtree(params, "norm"), h, cfg.norm_eps)
    f = F.gelu(torch.matmul(h, params["w_ff1"]), approximate="tanh")
    return torch.matmul(f, params["w_ff2"])


def slstm_forward(params: Params, cfg: ArchConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    B, S, _ = x.shape
    d, H, dh = _slstm_dims(cfg)
    pre = torch.matmul(x, params["w_in"]).float()
    pre = pre.reshape(B, S, 4, H, dh)
    zeros = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    st = (zeros, zeros, torch.full((B, H, dh), NEG_INF, device=x.device),
          zeros)
    hs = []
    for t in range(S):
        st = _slstm_cell(params, cfg, pre[:, t], st)
        hs.append(st[3])
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    return _slstm_ffn(params, cfg, h)


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype,
                     device=None) -> Params:
    _, H, dh = _slstm_dims(cfg)
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return {"c": z, "h": z.clone(),
            "m": torch.full((batch, H, dh), NEG_INF, device=device),
            "n": z.clone()}


def slstm_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Params) -> Tuple[torch.Tensor, Params]:
    B = x.shape[0]
    d, H, dh = _slstm_dims(cfg)
    pre = torch.matmul(x, params["w_in"]).float().reshape(B, 4, H, dh)
    st = (cache["c"], cache["n"], cache["m"], cache["h"])
    c, n, m, h = _slstm_cell(params, cfg, pre, st)
    out = _slstm_ffn(params, cfg, h.reshape(B, 1, d).to(x.dtype))
    return out, {"c": c, "h": h, "m": m, "n": n}


def xlstm_rollback(states: Params, n_keep, time_axis: int) -> Params:
    """mLSTM/sLSTM analogue of ``mamba2.mamba2_rollback``: pick the
    post-update recurrent state of verify-chunk step ``n_keep - 1`` out
    of the per-step states collected on ``time_axis``."""
    return select_step(states, n_keep, time_axis)
