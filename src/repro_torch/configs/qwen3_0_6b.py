"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B]: 28L, d=1024, 16H GQA kv=8, head 128,
ff=3072, vocab 151936, qk-norm."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="decoder",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    pattern=(("ga", "dense"),),
    qk_norm=True,
    rope_theta=1000000.0,
    act="swiglu",
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=96, n_heads=4, n_kv_heads=2,
                      head_dim=24, d_ff=192, vocab_size=512)
