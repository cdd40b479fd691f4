"""Config system: architectures and input shapes.

The port's own copy of ``repro.configs.base``: every architecture is a
``ModelConfig`` plus a ``smoke_reduce`` reduction of the same family for
CPU tests.  Shapes are the four input-shape cells; ``applicable`` encodes
the long_500k sub-quadratic skip rule.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    mrope: bool = False           # qwen2-vl M-RoPE
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (Zamba2): one shared attention block applied every `attn_every`
    # SSM layers (shared parameters, Zamba-style)
    attn_every: int = 0
    # enc-dec (Whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    frontend: Optional[str] = None   # "audio" | "vision" stub
    sub_quadratic: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    # training memory policy for the big dry-run configs
    moment_dtype: str = "float32"
    remat: bool = True

    @property
    def ssm_nheads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_headdim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def n_params(self) -> int:
        """Total parameter count (embedding + layers + head)."""
        d, dff, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d
        head = 0 if self.tie_embeddings else V * d
        att = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim \
            + self.n_heads * self.head_dim * d
        mlp = 3 * d * dff
        norm = 2 * d
        if self.family == "dense":
            per_layer = att + mlp + norm
            return emb + head + self.n_layers * per_layer + d
        if self.family == "moe":
            expert_mlp = self.n_experts * 3 * d * dff
            router = d * self.n_experts
            per_layer = att + expert_mlp + router + norm
            return emb + head + self.n_layers * per_layer + d
        if self.family == "ssm":
            di, st = self.d_inner, self.ssm_state
            nh = self.ssm_nheads
            in_proj = d * (2 * di + 2 * st + nh)
            per_layer = in_proj + self.ssm_conv * (di + 2 * st) + di * d + nh + nh + d
            return emb + head + self.n_layers * per_layer + d
        if self.family == "hybrid":
            di, st = self.d_inner, self.ssm_state
            nh = self.ssm_nheads
            in_proj = d * (2 * di + 2 * st + nh)
            ssm_layer = in_proj + self.ssm_conv * (di + 2 * st) + di * d + nh + nh + d
            shared_attn = att + mlp + norm
            return emb + head + self.n_layers * ssm_layer + shared_attn + d
        if self.family == "encdec":
            enc_layer = att + mlp + norm
            dec_layer = att + att + mlp + 3 * d   # self + cross + mlp
            return (emb + head + self.encoder_layers * enc_layer
                    + self.n_layers * dec_layer + 2 * d)
        raise ValueError(self.family)

    def active_params(self) -> int:
        """Activated parameters per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.n_params()
        d, dff = self.d_model, self.d_ff
        dense_share = self.n_params() - self.n_layers * self.n_experts * 3 * d * dff
        return dense_share + self.n_layers * self.experts_per_token * 3 * d * dff


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Shape-applicability rule. long_500k requires sub-quadratic mixing."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (O(L^2))"
    return True, ""


def smoke_reduce(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else 64,
        ssm_chunk=32,
        attn_every=1 if cfg.attn_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 64) if cfg.encoder_seq else 0,
        param_dtype="float32",
        moment_dtype="float32",
    )
