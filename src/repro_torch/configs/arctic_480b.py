"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]:
128-expert top-2 MoE + dense residual MLP on every layer."""
from ..models.common import Config

CONFIG = Config(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000,
    pattern=(("global", "moe_dense"),),
    n_experts=128, top_k=2, capacity_factor=1.25,
    tie_embeddings=False,
)
