"""DeepSeek-V3 671B [arXiv:2412.19437] — MoE 256e top-8 + MLA + MTP.

Assignment row: 61L d_model=7168 128H (GQA kv=128) d_ff=2048 vocab=129280,
MoE 256 experts top-8, 1 shared expert. d_ff=2048 is the routed-expert
width; the first 3 layers are dense with ff 18432 (paper §4.2). MLA
dims (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128) from the paper.
long_500k runs with the sliding-window variant (full attention otherwise).
"""
from repro_torch.config import ArchConfig, MLAConfig, MoEConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, expert_ff=2048,
                  first_k_dense=3, dense_ff=18432, capacity_factor=1.25,
                  aux_coef=0.001),
    mtp=True,
    rope_theta=10000.0,
    long_context_variant="sliding_window",
))
