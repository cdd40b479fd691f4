"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=128256,
    head_dim=128, rope_theta=5e5, tie_embeddings=True,
    param_dtype="bfloat16")
