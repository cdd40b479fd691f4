"""whisper-small — enc-dec audio backbone [arXiv:2212.04356; unverified].

Conv audio frontend is a STUB: the encoder takes precomputed frame
embeddings (1500 frames, ``embeds`` of ``forward`` and ``prefill``)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=51865,
    head_dim=64, encoder_layers=12, encoder_seq=1500,
    frontend="audio", param_dtype="bfloat16")
