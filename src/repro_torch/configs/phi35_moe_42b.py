"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

Assignment row: 32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064,
MoE 16 experts top-2, no shared expert.
"""
from repro_torch.config import ArchConfig, MoEConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, expert_ff=6400,
                  capacity_factor=1.25, aux_coef=0.01),
    long_context_variant="sliding_window",
))
