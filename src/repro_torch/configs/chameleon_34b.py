"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM decoder.

Assignment row: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion: VQ image tokens share the text vocabulary (stub frontend
supplies mixed token ids — frontends.vision_tokens). Chameleon uses
qk-norm for training stability; retained here.
"""
from repro_torch.config import ArchConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    frontend="vision",
    long_context_variant="sliding_window",
))
