"""StarCoder2-7B [arXiv:2402.19173]: GQA kv=4, RoPE, GELU."""
from ..models.common import Config

CONFIG = Config(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152,
    pattern=(("global", "mlp"),), act="gelu",
    rope_theta=1e5, tie_embeddings=True,
)
