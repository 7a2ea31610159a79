"""Gemma-3 27B [hf:google/gemma-3-27b-pt]: 5:1 local:global, qk-norm, 128k."""
from ..models.common import Config

CONFIG = Config(
    name="gemma3-27b",
    n_layers=62, d_model=5376, n_heads=32, kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144,
    # 5 local : 1 global; 62 = 10 groups of 6 + 2 remainder local layers
    pattern=tuple([("local", "mlp")] * 5 + [("global", "mlp")]),
    window=1024, qk_norm=True, rope_theta=1e6, act="gelu",
    tie_embeddings=True,
)
