"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM blocks.

Assignment row: 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304. d_ff=0
means no separate FFN: the mLSTM block carries a 2x up-projection and the
sLSTM block a 4/3 post-FFN internally (paper Fig 9/10). sLSTM at layers
(3, 9), mLSTM elsewhere (an xLSTM[10:2]-style mix). Native long-context:
O(1) recurrent state, so long_500k decodes without attention windows.
"""
from repro_torch.config import ArchConfig, XLSTMConfig
from repro_torch.configs.base import register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attn_type="none",
    xlstm=XLSTMConfig(slstm_layers=(3, 9), proj_factor_mlstm=2.0,
                      proj_factor_slstm=1.3333333, chunk=64),
    tie_embeddings=True,
    long_context_variant="native",
))
