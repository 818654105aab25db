"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention.

Assignment row: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64. The 81 layers are Mamba2 blocks; ONE shared
attention+MLP block is applied every 6 mamba blocks (13 sites) with
per-site LoRA (rank 128) on its projections, consuming
concat(hidden, original embedding) — the Zamba2 design. Mamba2 inner dim
= 2*d_model (7168), head_dim 64 => 112 SSM heads. Native long-context via
recurrent state; the shared-attention sites use a sliding window on
long_500k.
"""
from repro_torch.config import ArchConfig, SSMConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    shared_attn_every=6,
    shared_attn_lora_rank=128,
    sliding_window=0,
    long_context_variant="native",
))
