"""olmoe-1b-7b — MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab_size=50304,
    head_dim=128, qk_norm=True, n_experts=64, experts_per_token=8,
    param_dtype="bfloat16")
