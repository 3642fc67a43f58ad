"""Architecture config schema + input-shape registry (port of
``repro.configs.base``; framework-free, copied as it is).

One ``ArchConfig`` per architecture lives in ``configs/<arch_id>.py``;
each exposes ``CONFIG`` (the exact published numbers) and every config
supports ``.reduced()`` -- a tiny same-family variant for CPU smoke
tests.  The port registers all ten architectures
(``configs/__init__``).  The four assigned input shapes are global
(``SHAPES``); per-arch applicability (decode/long-context skips) is
declared via ``ArchConfig.supports``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Family(str, enum.Enum):
    DENSE = "dense"
    SSM = "ssm"
    AUDIO = "audio"
    MOE = "moe"
    VLM = "vlm"
    HYBRID = "hybrid"


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int              # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # shared ("always-on") experts
    d_ff_shared: int = 0        # total shared width (n_shared * d_ff_expert)
    first_dense_layers: int = 0 # leading layers with dense FFN (DeepSeek)
    d_ff_dense: int = 0         # width of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 64         # N (per-head state) for Mamba2; dk for RWKV6
    head_dim: int = 64
    expand: int = 2             # d_inner = expand * d_model (Mamba2)
    conv_dim: int = 4           # depthwise causal conv width (Mamba2)
    chunk: int = 128            # chunked-scan window (the SpliDT "window")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                     # 0 -> d_model // n_heads
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    act: str = "silu"                   # mlp activation: silu|gelu
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    # enc-dec (whisper): encoder shares d_model/heads; frontend is a stub
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    dec_ratio: int = 8                  # decoder len = seq_len // dec_ratio
    # vlm: image-prefix length fed as precomputed patch embeddings (stub)
    n_image_tokens: int = 0
    # hybrid (zamba2): shared attention block applied every N ssm layers
    shared_attn_every: int = 0
    # attention window for long-context serving (0 = full causal)
    sliding_window: int = 0
    # which assigned shapes this arch runs (DESIGN.md §Arch-applicability)
    supports_decode: bool = True
    supports_long: bool = False
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        return self.family in (Family.SSM, Family.HYBRID)

    def param_count(self) -> int:
        """Approximate total parameters (for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models import model_zoo
        return model_zoo.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import model_zoo
        return model_zoo.param_count(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        def shrink_moe(m: Optional[MoECfg]) -> Optional[MoECfg]:
            if m is None:
                return None
            return dataclasses.replace(
                m, n_experts=8, top_k=min(m.top_k, 2), d_ff_expert=64,
                n_shared=min(m.n_shared, 1), d_ff_shared=64 if m.n_shared else 0,
                first_dense_layers=min(m.first_dense_layers, 1),
                d_ff_dense=128 if m.first_dense_layers else 0)

        def shrink_mla(m: Optional[MLACfg]) -> Optional[MLACfg]:
            if m is None:
                return None
            return MLACfg(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                          qk_rope_dim=8, v_head_dim=16)

        def shrink_ssm(m: Optional[SSMCfg]) -> Optional[SSMCfg]:
            if m is None:
                return None
            return dataclasses.replace(m, state_dim=16, head_dim=16, chunk=16)

        return dataclasses.replace(
            self,
            n_layers=2 if not self.shared_attn_every else 4,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128,
            vocab=256,
            d_head=16,
            moe=shrink_moe(self.moe),
            mla=shrink_mla(self.mla),
            ssm=shrink_ssm(self.ssm),
            enc_layers=min(self.enc_layers, 2),
            n_image_tokens=min(self.n_image_tokens, 8),
            shared_attn_every=2 if self.shared_attn_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shape_supported(cfg: ArchConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; else the reason."""
    if shape.name == "long_500k" and not cfg.supports_long:
        return False, ("pure full-attention architecture: 500k-token decode "
                       "requires sub-quadratic state (skip noted in DESIGN.md)")
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only architecture has no decode step"
    return True, ""
