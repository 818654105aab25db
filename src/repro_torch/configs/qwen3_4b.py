"""Qwen3-4B [hf:Qwen/Qwen3-8B family] — dense GQA with qk-norm.

Assignment row: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
Qwen3 uses head_dim 128 (so q-proj is 32*128=4096 > d_model) and RMS
qk-norm; the 4B variant ties embeddings.
"""
from repro_torch.config import ArchConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    long_context_variant="sliding_window",
))
