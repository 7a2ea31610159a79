"""PaliGemma-3B [arXiv:2407.07726]: SigLIP vision frontend (STUB - patch
embeddings provided) + gemma decoder with bidirectional prefix."""
from ..models.common import Config

CONFIG = Config(
    name="paligemma-3b",
    n_layers=18, d_model=2048, n_heads=8, kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216,
    pattern=(("global", "mlp"),),
    frontend="vision_stub", frontend_len=256, prefix_lm=True,
    tie_embeddings=True,
)
