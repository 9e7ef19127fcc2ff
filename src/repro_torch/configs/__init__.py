"""Architecture configs: one module per assigned architecture.

Every config is an immutable :class:`ModelConfig`. ``get_config(name)``
resolves the registry; ``SHAPES`` defines the assigned input-shape set and
``shape_applicable`` encodes the per-family skip policy (documented in
DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = [
    "ModelConfig",
    "ShapeSpec",
    "SHAPES",
    "ARCH_IDS",
    "get_config",
    "list_configs",
    "shape_applicable",
]


@dataclass(frozen=True)
class ModelConfig:
    """Unified model configuration for every supported family.

    Families: ``dense`` | ``moe`` | ``ssm`` | ``hybrid`` | ``audio`` | ``vlm``.
    Fields irrelevant to a family stay at their zero/None defaults.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    vocab_size: int
    # ---- attention ----
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                      # 0 -> d_model // num_heads
    d_ff: int = 0
    qk_norm: bool = False                  # qwen3
    qkv_bias: bool = False                 # qwen2
    attn_logit_softcap: Optional[float] = None   # gemma2
    final_logit_softcap: Optional[float] = None  # gemma2
    sliding_window: int = 0                # gemma2 local layers (0 = none)
    local_global_period: int = 0           # every Nth layer is global (gemma2: 2)
    attn_scale: Optional[float] = None     # override 1/sqrt(head_dim)
    post_norms: bool = False               # gemma2 post-attn/post-mlp norms
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"                      # "silu" | "gelu"
    norm: str = "rmsnorm"                  # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    # ---- MoE ----
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False           # arctic: dense FFN in parallel w/ MoE
    capacity_factor: float = 1.25
    # ---- SSM (mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # ---- hybrid (zamba2) ----
    attn_period: int = 0                   # one shared-attn block per N blocks
    # ---- encoder-decoder (whisper) ----
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0                   # stubbed frame/patch embedding length
    # ---- vision-language (llama-3.2-vision) ----
    cross_attn_period: int = 0             # every Nth layer is a cross-attn layer
    vision_seq: int = 0                    # stubbed patch-embedding length
    # ---- numerics ----
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # ---- substrate knobs (perf hillclimb touches these) ----
    remat: str = "full"                    # "full" | "none" | "dots"
    scan_layers: bool = True
    attn_impl: str = "xla"                 # "xla" | "pallas"
    attn_q_chunk: int = 256                # query-block size for chunked attn
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell: lowers train_step or serve_step."""

    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# Assigned architecture ids (order matches the task brief).
ARCH_IDS: Tuple[str, ...] = (
    "mamba2-2.7b",
    "whisper-large-v3",
    "gemma2-27b",
    "qwen3-4b",
    "deepseek-coder-33b",
    "qwen2-0.5b",
    "zamba2-7b",
    "llama-3.2-vision-90b",
    "arctic-480b",
    "granite-moe-3b-a800m",
)

_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "whisper-large-v3": "whisper_large_v3",
    "gemma2-27b": "gemma2_27b",
    "qwen3-4b": "qwen3_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen2-0.5b": "qwen2_0p5b",
    "zamba2-7b": "zamba2_7b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "arctic-480b": "arctic_480b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    # paper Table-1 models (used by the paper-replication benchmarks)
    "paper-qwen2.5-7b": "paper_qwen25_7b",
    "paper-qwen3-30b-a3b": "paper_qwen3_30b_a3b",
    "paper-qwen3-235b-a22b": "paper_qwen3_235b_a22b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_configs() -> Tuple[str, ...]:
    return tuple(_MODULES)


# Families with sub-quadratic sequence mixing run long_500k; pure
# full-attention families skip it (DESIGN.md §Arch-applicability).
_SUBQUADRATIC = {"ssm", "hybrid"}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Return (applicable, reason-if-not)."""
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC:
        return False, "full-attention arch: 500k decode skipped per policy"
    return True, ""


def reduced_config(name: str) -> ModelConfig:
    """Same-family reduced config for CPU smoke tests: tiny widths/depths,
    few experts, small vocab — preserving every structural feature
    (GQA-ness, softcaps, qk-norm, local/global pattern, hybrid periods...)."""
    cfg = get_config(name)
    layers = {
        "dense": 4, "moe": 4, "ssm": 3, "audio": 2,
        "hybrid": 2 * max(cfg.attn_period, 1) + 1,
        "vlm": 2 * max(cfg.cross_attn_period, 1),
    }[cfg.family]
    kw = dict(
        num_layers=layers,
        d_model=64,
        vocab_size=128,
        head_dim=16,
        attn_scale=None,
        ssm_state=16,
        ssm_head_dim=8,
        ssm_chunk=8,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=12 if cfg.encoder_seq else 0,
        vision_seq=9 if cfg.vision_seq else 0,
        sliding_window=8 if cfg.sliding_window else 0,
        attn_q_chunk=32,
    )
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 2 if cfg.num_kv_heads < cfg.num_heads else 4
    if cfg.d_ff:
        kw["d_ff"] = 128
    if cfg.num_experts:
        kw["num_experts"] = 8
        kw["experts_per_token"] = min(cfg.experts_per_token, 4)
        kw["moe_d_ff"] = 48
    return cfg.replace(**kw)
