"""mamba2-2.7b — attention-free SSD [arXiv:2405.21060; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2,
    sub_quadratic=True, tie_embeddings=True, param_dtype="bfloat16")
