"""GLM-4-9B [hf:THUDM/glm-4-9b] — dense GQA with 2 KV heads, partial RoPE.

Assignment row: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
GLM rotates half the head dim (rope_fraction=0.5).
"""
from repro_torch.config import ArchConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="glm4-9b",
    family="dense",
    source="hf:THUDM/glm-4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_fraction=0.5,
    rope_theta=5e6,
    long_context_variant="sliding_window",
))
