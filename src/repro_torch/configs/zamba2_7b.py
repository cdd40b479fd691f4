"""zamba2-7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242; unverified].

81 Mamba2 layers; one *shared* (parameter-tied) attention+MLP block applied
after every 9th SSM layer (9 applications; Zamba-style weight sharing)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab_size=32000,
    head_dim=112, ssm_state=64, ssm_headdim=64, ssm_expand=2,
    attn_every=9, sub_quadratic=True, param_dtype="bfloat16")
