"""Llama-3.1 405B [arXiv:2407.21783] — dense GQA, 128k vocab.

Assignment row: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. rope_theta 500k per the paper's long-context recipe.
"""
from repro_torch.config import ArchConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="llama3-405b",
    family="dense",
    source="arXiv:2407.21783",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
    long_context_variant="sliding_window",
))
