"""Llama-4-Maverick 400B-A17B [hf:meta-llama/Llama-4-Maverick-17B-128E]:
48L, d=5120, 40H GQA kv=8, ff=8192, vocab 202048; MoE 128 experts top-1
with a shared expert, interleaved dense:MoE = 1:1 (DESIGN.md §Config
fidelity: reproduces ~400B total / ~17B active params).  Early-fusion
multimodality is a frontend concern (text path exercised here)."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="decoder",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(("ga", "dense"), ("ga", "moe")),
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                  shared_expert=True, capacity_factor=2.0),
    act="swiglu",
    tie_embeddings=False,
    rope_theta=500000.0,
    subquadratic=False,
)

# smoke capacity covers all tokens (no drops) so decode == forward exactly
SMOKE = CONFIG.scaled(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=512,
                      moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=256,
                                    shared_expert=True,
                                    capacity_factor=16.0))
