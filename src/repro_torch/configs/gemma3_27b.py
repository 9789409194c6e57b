"""Gemma-3-27B [hf:google/gemma-3 family]: 62L, d=5376, 32H GQA kv=16,
ff=21504, vocab 262144; 5 local(window 1024):1 global pattern, qk-norm,
128k context.  62 = 10 x (5L+1G) + 2 trailing local layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="decoder",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=(("la", "dense"),) * 5 + (("ga", "dense"),),
    window=1024,
    qk_norm=True,
    rope_theta=1000000.0,
    act="gelu",  # geglu: gelu with gate
    tie_embeddings=True,
    emb_scale=5376 ** 0.5,   # gemma embeds are sqrt(d)-scaled
    # local layers dominate (5:1, window 1024) => effectively subquadratic;
    # global layers at 500k decode are linear per step
    subquadratic=True,
)

# geglu needs a gate; reuse swiglu-style gate with gelu activation
CONFIG = CONFIG.scaled(act="swiglu")

SMOKE = CONFIG.scaled(n_layers=8, d_model=128, n_heads=4, n_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=512, window=64,
                      emb_scale=128 ** 0.5)
