"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: 26L, d=2560, 10H GQA
kv=1 (MQA), ff=7680; pattern = [RG-LRU, RG-LRU, local-attn(window 2048)];
26 = 8 x 3 + 2 trailing recurrent blocks.  vocab 256000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="decoder",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=(("rg", "dense"), ("rg", "dense"), ("la", "dense")),
    window=2048,
    rg_lru_width=2560,
    conv1d_width=4,
    act="swiglu",  # geglu variant
    tie_embeddings=True,
    emb_scale=2560 ** 0.5,
    subquadratic=True,   # hybrid: recurrent state + fixed-window attention
)

SMOKE = CONFIG.scaled(n_layers=5, d_model=128, n_heads=2, n_kv_heads=1,
                      head_dim=64, d_ff=256, vocab_size=512, window=32,
                      rg_lru_width=128, emb_scale=128 ** 0.5)
