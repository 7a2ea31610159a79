"""DeepSeek-V2-Lite [arXiv:2405.04434; huggingface.co/deepseek-ai/
DeepSeek-V2-Lite]: 27 layers of multi-head latent attention, the first
with a dense MLP of width 10,944 (``first_k_dense_replace = 1``), the
other 26 with 64 routed experts of width 1,408 (6 a token, gates not
renormalised) and 2 shared experts; YaRN RoPE (factor 40 over 4,096).

A port-only architecture: the JAX package has no latent attention, so
it is not in `configs.ARCHS`.  ``capacity_factor`` 11 (ceil(64 / 6))
lets every expert take a whole group, so routing drops nothing, as the
source serves it.
"""
from ..models.common import MLAConfig

CONFIG = MLAConfig(
    name="deepseek-v2-lite",
    n_layers=27, d_model=2048, n_heads=16, kv_heads=16, head_dim=192,
    d_ff=1408, vocab=102400,
    pattern=(("mla", "mlp"),) + (("mla", "moe"),) * 26,
    n_experts=64, top_k=6, capacity_factor=11.0, moe_group=512,
    rope_theta=10_000.0, tie_embeddings=False, norm_eps=1e-6,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    d_ff_dense=10944, n_shared=2, norm_topk=False,
    yarn_factor=40.0, yarn_original_len=4096, yarn_beta_fast=32.0,
    yarn_beta_slow=1.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707,
)
