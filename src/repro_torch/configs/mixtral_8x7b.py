"""Mixtral 8x7B [arXiv:2401.04088]: 8-expert top-2 MoE, sliding-window attn."""
from ..models.common import Config

CONFIG = Config(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    pattern=(("local", "moe"),), window=4096,
    n_experts=8, top_k=2, capacity_factor=1.25,
    rope_theta=1e6, tie_embeddings=False,
)
