"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M]: small llama-arch dense LM."""
from ..models.common import Config

CONFIG = Config(
    name="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, kv_heads=5, head_dim=64,
    d_ff=2560, vocab=49152,
    pattern=(("global", "mlp"),),
    tie_embeddings=True,
)
