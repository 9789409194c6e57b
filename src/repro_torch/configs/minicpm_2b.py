"""MiniCPM-2B [arXiv:2404.06395]: 40L, d=2304, 36H (kv=36 -> MHA), ff=5760,
vocab 122753.  Arch-defining features: muP-style scaling knobs + the WSD
(warmup-stable-decay) schedule, wired in optim/schedules.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="decoder",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    pattern=(("ga", "dense"),),
    act="swiglu",
    tie_embeddings=True,
    # muP knobs (paper: scale_emb=12, scale_depth=1.4, dim_model_base=256)
    emb_scale=12.0,
    residual_scale=1.4 / (40 ** 0.5),
    logit_scale=1.0 / (2304 / 256),
    subquadratic=False,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                      head_dim=32, d_ff=320, vocab_size=512,
                      residual_scale=1.4 / 2.0, logit_scale=0.5)
