"""RecurrentGemma-2B [arXiv:2402.19427]: RG-LRU + local attention, 2:1."""
from ..models.common import Config

CONFIG = Config(
    name="recurrentgemma-2b",
    n_layers=26, d_model=2560, n_heads=10, kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000,
    # 26 = 8 groups of (rglru, rglru, local) + 2 remainder rglru layers
    pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("local", "mlp")),
    window=2048, lru_width=2560, conv_width=4, act="gelu",
    tie_embeddings=True,
)
