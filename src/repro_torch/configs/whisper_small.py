"""Whisper-small [arXiv:2212.04356] — encoder-decoder, conv frontend STUB.

Assignment row: 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
12 encoder + 12 decoder layers; the mel+conv frontend is a stub —
input_specs() provides (B, 1500, 768) frame embeddings (30 s of audio at
the 50 Hz post-conv rate). Deviation: RoPE replaces Whisper's
absolute positional embeddings so the attention substrate is shared
(DESIGN.md §8).
"""
from repro_torch.config import ArchConfig, EncDecConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    encdec=EncDecConfig(n_enc_layers=12, source_len=1500),
    frontend="audio",
    long_context_variant="sliding_window",
))
