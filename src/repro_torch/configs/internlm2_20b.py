"""InternLM2-20B [arXiv:2403.17297]: 48L, d=6144, 48H GQA kv=8, ff=16384,
vocab 92544."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="decoder",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    pattern=(("ga", "dense"),),
    act="swiglu",
    tie_embeddings=False,
    rope_theta=1000000.0,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
                      head_dim=16, d_ff=256, vocab_size=512)
