"""mistral-nemo-12b — dense, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072,
    head_dim=128, rope_theta=1e6, param_dtype="bfloat16")
