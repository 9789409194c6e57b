"""Architecture configuration schema (a copy of `repro.configs.base`).

Every architecture is described by a `ModelConfig`; the per-layer block
structure is a repeating `pattern` of (mixer, mlp) kinds.  The JAX package
scans over the repeated units with stacked parameters; the port holds the
pattern-expanded `layers` as a list.

Mixer kinds:  'ga' global attention | 'la' local (sliding-window) attention
              | 'rg' RG-LRU recurrent block | 'rwkv' RWKV-6 time mix
              | 'bi' bidirectional attention (encoder)
              | 'xa' causal self-attn + cross-attn (decoder w/ encoder)
MLP kinds:    'dense' | 'moe' | 'cmix' (RWKV-6 channel mix)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False
    capacity_factor: float = 2.0
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # 'decoder' | 'encdec'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # repeating layer pattern: tuple of (mixer, mlp) kind pairs
    pattern: Tuple[Tuple[str, str], ...] = (("ga", "dense"),)
    window: Optional[int] = None     # for 'la' layers
    qk_norm: bool = False
    softcap: Optional[float] = None  # attention logit soft-capping
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "swiglu"              # 'swiglu' | 'gelu' | 'relu2'
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    # recurrent dims
    rg_lru_width: Optional[int] = None
    conv1d_width: int = 4
    rwkv_head_dim: int = 64
    # modality frontend: 'text' | 'vlm' | 'audio' (vlm/audio get precomputed
    # frame/patch embeddings by spec; backbone is exact)
    modality: str = "text"
    # enc-dec split (family == 'encdec'): n_layers is the decoder depth
    n_encoder_layers: int = 0
    # muP-style scaling knobs (MiniCPM / WSD arch)
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    # numerics
    dtype: str = "bfloat16"
    # long-context capability flag: False for pure full-attention archs =>
    # the long_500k shape is skipped (DESIGN.md §Arch-applicability)
    subquadratic: bool = False

    @property
    def layers(self) -> Tuple[Tuple[str, str], ...]:
        """The full per-layer (mixer, mlp) list, pattern-expanded."""
        p = self.pattern
        reps = -(-self.n_layers // len(p))
        return (p * reps)[: self.n_layers]

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_remainder(self) -> int:
        return self.n_layers - self.n_units * len(self.pattern)

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
