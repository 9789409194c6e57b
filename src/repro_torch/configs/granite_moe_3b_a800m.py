"""Granite-3.0-3B-A800M MoE [hf:ibm-granite/granite-3.0-3b-a800m-base]:
32L, d=1536, 24H GQA kv=8, expert ff=512, 40 experts top-8, vocab 49155."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="decoder",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                # informational; experts carry the FFN
    vocab_size=49155,
    pattern=(("ga", "moe"),),
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                  shared_expert=False, capacity_factor=2.0),
    act="swiglu",
    tie_embeddings=True,
    subquadratic=False,
)

# smoke capacity covers all tokens (no drops) so decode == forward exactly
SMOKE = CONFIG.scaled(n_layers=3, d_model=128, n_heads=4, n_kv_heads=2,
                      head_dim=32, d_ff=64, vocab_size=512,
                      moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                                    capacity_factor=8.0))
