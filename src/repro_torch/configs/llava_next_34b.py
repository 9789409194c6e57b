"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6-34b]: 60L backbone (Yi-34B-ish),
d=7168, 56H GQA kv=8, ff=20480, vocab 64000.

[vlm]: the anyres tiling vision frontend is a STUB by spec —
input_specs()/the data pipeline provide precomputed patch embeddings
('embeds' [B, T, d]); the language backbone is exact."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="decoder",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    pattern=(("ga", "dense"),),
    act="swiglu",
    tie_embeddings=False,
    rope_theta=5000000.0,
    modality="vlm",
    subquadratic=False,
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
                      head_dim=16, d_ff=256, vocab_size=512)
