"""SeamlessM4T-medium [arXiv:2308.11596]: enc-dec, 12L speech encoder +
12L text decoder, d=1024, 16H (kv=16), ff=4096, vocab 256206.

[audio]: the conformer speech frontend is a STUB by spec — input_specs()
provide precomputed frame embeddings ('enc_embeds' [B, S, d]); the
transformer backbone (bidirectional encoder + causal decoder with
cross-attention) is exact."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,             # decoder depth
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    pattern=(("xa", "dense"),),
    act="gelu",
    tie_embeddings=True,
    modality="audio",
    subquadratic=False,
)

SMOKE = CONFIG.scaled(n_layers=2, n_encoder_layers=2, d_model=128,
                      n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
                      vocab_size=512)
