"""qwen3-32b — dense, qk-norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, d_ff=25600, vocab_size=151936,
    head_dim=128, qk_norm=True, rope_theta=1e6,
    param_dtype="bfloat16")
