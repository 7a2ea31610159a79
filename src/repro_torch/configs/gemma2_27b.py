"""Gemma-2 27B [arXiv:2408.00118]: 1:1 local:global alternation, softcaps."""
from ..models.common import Config

CONFIG = Config(
    name="gemma2-27b",
    n_layers=46, d_model=4608, n_heads=32, kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    pattern=(("local", "mlp"), ("global", "mlp")), window=4096,
    attn_softcap=50.0, final_softcap=30.0, act="gelu",
    tie_embeddings=True,
)
