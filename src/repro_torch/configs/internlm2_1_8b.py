"""InternLM2-1.8B [arXiv:2403.17297] — dense GQA decoder.

Assignment row: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.config import ArchConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    source="arXiv:2403.17297",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1e6,
    long_context_variant="sliding_window",
))
