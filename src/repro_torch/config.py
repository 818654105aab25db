"""Configuration system (port of ``repro/config.py``).

Frozen dataclasses with dotted-path overrides and JSON round-tripping.
``ArchConfig`` describes one transformer/SSM/hybrid architecture;
``FedCDConfig`` describes the federated-learning algorithm hyperparameters
from the paper; ``ShapeConfig`` describes one of the assigned input shapes.
The port's LM trainer runs the ``ATTN_MLP`` layouts; the other kinds are
described here so that every registered architecture's config and
parameter count is the reference's.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

# ---------------------------------------------------------------------------
# Layer kinds used by models/transformer.py layouts
# ---------------------------------------------------------------------------
ATTN_MLP = "attn_mlp"          # standard pre-norm attention + dense MLP
ATTN_MOE = "attn_moe"          # attention + MoE FFN
MLA_MOE = "mla_moe"            # DeepSeek MLA attention + MoE FFN
MLA_MLP = "mla_mlp"            # MLA attention + dense MLP (dense prefix layers)
MAMBA2 = "mamba2"              # Mamba2 SSD block
SLSTM = "slstm"                # xLSTM sLSTM block
MLSTM = "mlstm"                # xLSTM mLSTM block
SHARED_ATTN = "shared_attn"    # zamba2 shared attention block site


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0            # shared (always-on) experts
    expert_ff: int = 0           # per-expert FFN width
    first_k_dense: int = 0       # leading dense layers (DeepSeek-V3 uses 3)
    dense_ff: int = 0            # FFN width of those dense layers
    capacity_factor: float = 1.25
    aux_coef: float = 0.01       # load-balance auxiliary loss coefficient
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # N (SSM state size)
    conv_width: int = 4
    expand: int = 2              # inner dim = expand * d_model
    head_dim: int = 64           # P (channels per SSM head)
    n_groups: int = 1            # B/C groups
    chunk: int = 256             # SSD chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_layers: Tuple[int, ...] = ()   # indices that are sLSTM (rest mLSTM)
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333333
    chunk: int = 64              # mLSTM chunkwise-parallel chunk length
    conv_width: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 0
    source_len: int = 1500       # encoder positions (whisper: 30s @ 50Hz)


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. Field values follow the assignment table exactly."""

    name: str = "unnamed"
    family: str = "dense"        # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""             # citation

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention options
    attn_type: str = "gqa"       # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0   # fraction of head_dim that is rotated (glm4: 0.5)
    sliding_window: int = 0      # 0 = full attention
    long_context_variant: str = ""  # "" | "sliding_window" | "native"

    # sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)
    encdec: EncDecConfig = field(default_factory=EncDecConfig)

    # hybrid (zamba2): shared attention block every k mamba blocks
    shared_attn_every: int = 0   # 0 = no shared block
    shared_attn_lora_rank: int = 0

    # extras
    mtp: bool = False            # DeepSeek multi-token prediction head
    tie_embeddings: bool = False
    frontend: str = "none"       # none | audio | vision

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # norm eps
    norm_eps: float = 1e-5

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def layout(self) -> List[str]:
        """Per-layer block kinds for decoder-only stacks."""
        if self.family == "ssm":
            sl = set(self.xlstm.slstm_layers)
            return [SLSTM if i in sl else MLSTM for i in range(self.n_layers)]
        if self.family == "hybrid":
            # zamba2: mamba2 backbone; a shared attention block is *inserted*
            # after every `shared_attn_every` mamba blocks. Layout positions
            # here are mamba layers only; insertion sites handled by the model.
            return [MAMBA2] * self.n_layers
        if self.attn_type == "mla":
            kinds = []
            for i in range(self.n_layers):
                if self.moe.n_experts and i >= self.moe.first_k_dense:
                    kinds.append(MLA_MOE)
                else:
                    kinds.append(MLA_MLP)
            return kinds
        if self.moe.n_experts:
            return [ATTN_MOE] * self.n_layers
        return [ATTN_MLP] * self.n_layers

    # -- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) --------
    def param_counts(self) -> Dict[str, float]:
        """Approximate parameter counts: total and active-per-token."""
        d, hd = self.d_model, self.resolved_head_dim()
        H, Kv, L, V = self.n_heads, self.n_kv_heads, self.n_layers, self.vocab_size
        embed = V * d * (1 if self.tie_embeddings else 2)
        total = active = float(embed)
        layout = self.layout()

        def attn_params() -> float:
            if self.attn_type == "mla":
                m = self.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                p = d * m.q_lora_rank + m.q_lora_rank * H * qk
                p += d * (m.kv_lora_rank + m.qk_rope_dim)
                p += m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
                p += H * m.v_head_dim * d
                return float(p)
            return float(d * H * hd + 2 * d * Kv * hd + H * hd * d)

        def mlp_params(ff: int) -> float:
            return float(3 * d * ff)  # SwiGLU: gate+up+down

        def mamba_params() -> float:
            s = self.ssm
            di = s.expand * d
            nh = di // s.head_dim
            p = d * (2 * di + 2 * s.n_groups * s.state_dim + nh)  # in_proj
            p += s.conv_width * (di + 2 * s.n_groups * s.state_dim)
            p += nh + nh  # A_log, D
            p += di * d   # out_proj
            return float(p)

        def xlstm_params(kind: str) -> float:
            x = self.xlstm
            if kind == MLSTM:
                di = int(x.proj_factor_mlstm * d)
                p = 2 * d * di                      # up proj (x + gate branch)
                p += 3 * di * di                    # q,k,v (full)
                p += 2 * di * self.n_heads          # i,f gate projections (per head)
                p += di * d                         # down proj
                return float(p)
            dff = int(x.proj_factor_slstm * d)
            p = 4 * d * d + 4 * d * d               # recurrent+input gates (4 gates)
            p += 2 * d * dff                        # post-FFN
            return float(p)

        for kind in layout:
            if kind in (ATTN_MLP,):
                total += attn_params() + mlp_params(self.d_ff)
                active += attn_params() + mlp_params(self.d_ff)
            elif kind in (ATTN_MOE, MLA_MOE):
                a = attn_params()
                e = mlp_params(self.moe.expert_ff)
                shared = self.moe.n_shared * e
                total += a + self.moe.n_experts * e + shared + d * self.moe.n_experts
                active += a + self.moe.top_k * e + shared + d * self.moe.n_experts
            elif kind == MLA_MLP:
                ff = self.moe.dense_ff or self.d_ff
                total += attn_params() + mlp_params(ff)
                active += attn_params() + mlp_params(ff)
            elif kind == MAMBA2:
                total += mamba_params()
                active += mamba_params()
            elif kind in (SLSTM, MLSTM):
                total += xlstm_params(kind)
                active += xlstm_params(kind)
        if self.shared_attn_every:
            # one shared attention+mlp block (counted once) + per-site LoRA
            sb = attn_params() + mlp_params(self.d_ff) + 2 * d * d  # concat in-proj
            n_sites = self.n_layers // self.shared_attn_every
            lora = n_sites * self.shared_attn_lora_rank * 2 * d * 4
            total += sb + lora
            active += sb + lora / max(n_sites, 1)
        if self.encdec.n_enc_layers:
            enc = self.encdec.n_enc_layers * (attn_params() + mlp_params(self.d_ff))
            cross = self.n_layers * attn_params()
            total += enc + cross
            active += enc + cross
        return {"total": total, "active": active}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class FedCDConfig:
    """Hyperparameters of the FedCD algorithm (paper section 2 & 3.1)."""

    n_devices: int = 30
    devices_per_round: int = 15      # K
    local_epochs: int = 1            # E
    score_window: int = 3            # ℓ (eq 2)
    milestones: Tuple[int, ...] = (5, 15, 25, 30)
    late_delete_round: int = 20      # after this, 2-model devices may drop one
    late_delete_threshold: float = 0.3
    score_noise: float = 0.01        # "with some randomization" (sec 2)
    max_models: int = 16             # safety cap (2^#milestones)
    quantize_bits: int = 0           # 0 = off; 8 = int8 transport compression
    lr: float = 0.05
    momentum: float = 0.0
    seed: int = 0


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2)


def override(cfg: Any, **kw: Any) -> Any:
    """Replace fields, supporting dotted paths for nested dataclasses.

    >>> override(arch, **{"moe.top_k": 2, "n_layers": 4})
    """
    nested: Dict[str, Dict[str, Any]] = {}
    flat: Dict[str, Any] = {}
    for k, v in kw.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
        else:
            flat[k] = v
    for head, sub in nested.items():
        flat[head] = override(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **flat)
