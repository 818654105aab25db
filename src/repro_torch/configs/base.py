"""Architecture registry + reduced (smoke) variants + input specs (port
of ``repro/configs/base.py``, whole)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ArchConfig, ShapeConfig, override
from repro_torch.models.common import dtype_of

Spec = Tuple[Tuple[int, ...], torch.dtype]

ARCH_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def all_arch_names():
    import repro_torch.configs  # noqa: F401
    return sorted(ARCH_REGISTRY)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: 2 layers, d_model<=512, <=4 experts (brief)."""
    d = min(cfg.d_model, 256)
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, heads))
    kw = dict(
        n_layers=2, d_model=d, n_heads=heads, n_kv_heads=kv,
        head_dim=64 if cfg.head_dim else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        param_dtype="float32", compute_dtype="float32",
    )
    if cfg.moe.n_experts:
        kw.update({"moe.n_experts": 4, "moe.top_k": 2,
                   "moe.expert_ff": 128, "moe.first_k_dense": 1,
                   "moe.dense_ff": 256,
                   "moe.n_shared": min(cfg.moe.n_shared, 1)})
    if cfg.attn_type == "mla":
        kw.update({"mla.q_lora_rank": 64, "mla.kv_lora_rank": 32,
                   "mla.qk_nope_dim": 32, "mla.qk_rope_dim": 16,
                   "mla.v_head_dim": 32})
    if cfg.family == "hybrid":
        kw.update({"n_layers": 3, "shared_attn_every": 2,
                   "shared_attn_lora_rank": 8,
                   "ssm.head_dim": 32, "ssm.state_dim": 16, "ssm.chunk": 16})
    if cfg.family == "ssm":
        kw.update({"xlstm.slstm_layers": (1,), "xlstm.chunk": 16})
    if cfg.family == "audio":
        kw.update({"encdec.n_enc_layers": 2, "encdec.source_len": 24})
    if cfg.ssm.state_dim and cfg.family not in ("hybrid",):
        kw.update({"ssm.head_dim": 32, "ssm.state_dim": 16, "ssm.chunk": 16})
    return override(cfg, **kw)


# ---------------------------------------------------------------------------
# (shape, dtype) stand-ins for every model input (dry-run contract)
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                n_clients: int = 16) -> Dict[str, Spec]:
    """Abstract inputs for the step the shape lowers (no allocation), as
    ``(shape, dtype)`` pairs (the reference's ``ShapeDtypeStruct``s; the
    dry run makes ``meta`` tensors of them).

    train   -> tokens/labels (B, S) + FedCD per-client scores (n_clients,)
    prefill -> tokens (B, S)
    decode  -> tokens (B, 1)  (caches are built by the launcher)
    Audio adds stub frames (B, source_len, d_model); see frontends.py.
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    specs: Dict[str, Spec] = {}
    if shape.kind == "train":
        specs["tokens"] = ((B, S), i32)
        specs["labels"] = ((B, S), i32)
        specs["client_scores"] = ((n_clients,), torch.float32)
    elif shape.kind == "prefill":
        specs["tokens"] = ((B, S), i32)
    else:  # decode
        specs["tokens"] = ((B, 1), i32)
    if cfg.family == "audio":
        specs["frames"] = ((B, cfg.encdec.source_len, cfg.d_model),
                           dtype_of(cfg.compute_dtype))
    return specs


def shape_supported(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k policy (DESIGN.md §5): native for recurrent-state archs,
    sliding-window variant for attention archs (explicit carve-out)."""
    if shape.name != "long_500k":
        return True
    return cfg.long_context_variant in ("native", "sliding_window")


def decode_window(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Ring-buffer window for attention caches on long-context decode."""
    if shape.name == "long_500k" and cfg.long_context_variant == "sliding_window":
        return 8192
    return 0
