"""Whisper-small [arXiv:2212.04356]: enc-dec; conv frontend is a STUB -
input_specs provides precomputed frame embeddings [B, frames, d_model]."""
from ..models.common import Config

CONFIG = Config(
    name="whisper-small",
    n_layers=12, d_model=768, n_heads=12, kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865,
    family="encdec", enc_layers=12,
    enc_pattern=(("bidir", "mlp"),),
    pattern=(("cross_global", "mlp"),),
    frontend="audio_stub", frontend_len=1536, act="gelu",
    tie_embeddings=True,
)
