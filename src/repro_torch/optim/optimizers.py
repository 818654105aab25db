"""Minimal optimizers over flat param dicts (port of
``repro/optim/optimizers.py``).

FL clients in the paper run plain local SGD; Adam is provided for
non-federated training paths. States are dicts matching params. Every
update is computed in float32 and cast back to the param's dtype (round
to nearest even for bfloat16), as the reference's. :func:`sgd_update`
returns new tensors; :func:`sgd_update_` writes the same values into the
params in place (the LM trainer's bank rows).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Tuple

import torch

Params = Dict[str, torch.Tensor]
OptState = Dict[str, Any]


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


# ---------------------------------------------------------------------------
# SGD (+ optional momentum)
# ---------------------------------------------------------------------------
def sgd_init(params: Params, momentum: float = 0.0) -> OptState:
    step = torch.zeros((), dtype=torch.int32)
    if momentum:
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "step": step}
    return {"step": step}


def _sgd(p: torch.Tensor, g: torch.Tensor, lr) -> torch.Tensor:
    return (p.float() - lr * g.float()).to(p.dtype)


def sgd_update(params: Params, grads: Params, state: OptState, lr,
               momentum: float = 0.0) -> Tuple[Params, OptState]:
    if momentum:
        mu = {k: momentum * m + grads[k].to(m.dtype)
              for k, m in state["mu"].items()}
        params = {k: _sgd(p, mu[k], lr) for k, p in params.items()}
        return params, {"mu": mu, "step": state["step"] + 1}
    params = {k: _sgd(p, grads[k], lr) for k, p in params.items()}
    return params, {"step": state["step"] + 1}


#: elements of one in-place SGD chunk (64 MiB of float32 temporaries)
SGD_CHUNK = 1 << 24


@torch.no_grad()
def sgd_update_(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                lr: float) -> None:
    """Plain SGD IN PLACE over ``(param, grad)`` pairs: each param takes
    :func:`sgd_update`'s value. A contiguous param of more than
    ``SGD_CHUNK`` values is written chunk by chunk of its flat view,
    which bounds the float32 temporaries (the update is elementwise, so
    the values are the same)."""
    for p, g in pairs:
        if p.numel() > SGD_CHUNK and p.is_contiguous():
            for pc, gc in zip(p.view(-1).split(SGD_CHUNK),
                              g.reshape(-1).split(SGD_CHUNK)):
                pc.copy_(_sgd(pc, gc, lr))
        else:
            p.copy_(_sgd(p, g, lr))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------
def adam_init(params: Params) -> OptState:
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": {k: z(p) for k, p in params.items()},
            "v": {k: z(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def adam_update(params: Params, grads: Params, state: OptState, lr,
                b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8) -> Tuple[Params, OptState]:
    step = state["step"] + 1
    m = {k: b1 * m_ + (1 - b1) * grads[k].float()
         for k, m_ in state["m"].items()}
    v = {k: b2 * v_ + (1 - b2) * torch.square(grads[k].float())
         for k, v_ in state["v"].items()}
    s = step.float()
    bc1 = 1 - torch.pow(torch.full((), b1), s)
    bc2 = 1 - torch.pow(torch.full((), b2), s)
    params = {k: (p.float() - lr * (m[k] / bc1.to(p.device))
                  / (torch.sqrt(v[k] / bc2.to(p.device)) + eps)).to(p.dtype)
              for k, p in params.items()}
    return params, {"m": m, "v": v, "step": step}


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def make_optimizer(name: str, params: Params, momentum: float = 0.0):
    """Returns (state, update_fn(params, grads, state, lr))."""
    if name == "sgd":
        return sgd_init(params, momentum), (
            lambda p, g, s, lr: sgd_update(p, g, s, lr, momentum))
    if name == "adam":
        return adam_init(params), adam_update
    raise ValueError(name)
