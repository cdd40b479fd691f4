"""qwen2-vl-72b — VLM backbone, M-RoPE [arXiv:2409.12191; hf].

The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings merged into the token stream; the backbone (this config) applies
M-RoPE 3D rotary sections."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab_size=152064,
    head_dim=128, mrope=True, rope_theta=1e6, frontend="vision",
    param_dtype="bfloat16", moment_dtype="bfloat16")
