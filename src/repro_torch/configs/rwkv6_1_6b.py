"""RWKV-6 (Finch) 1.6B [arXiv:2404.05892]: 24L, d=2048, attention-free
(time mix w/ data-dependent decay + channel mix), ff=7168 (channel mix),
vocab 65536."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="decoder",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d / rwkv_head_dim; informational
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    pattern=(("rwkv", "cmix"),),
    rwkv_head_dim=64,
    act="relu2",
    tie_embeddings=False,
    subquadratic=True,     # attention-free: O(1) state per token
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
                      head_dim=32, d_ff=256, vocab_size=512,
                      rwkv_head_dim=32)
