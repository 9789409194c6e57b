"""GQA attention with rotary embedding, optional qk-norm, sliding window,
a ring-buffer KV cache and per-slot decode positions (port of
`repro.models.attention`).

Plain PyTorch throughout: the JAX package computes attention outside any
Pallas kernel too (its `flash_attention` kernel is reached by no model).
Cross-attention (`kv_override`: a (k, v) pair, or an object whose
`.enc_out` this layer's own `wk` / `wv` project) rotates neither q nor k,
is never causal and keeps no cache, as in the JAX package.

Layouts:
  x          [B, T, d]
  q          [B, T, H, dh]     ->  grouped [B, Hkv, G, T, dh]
  k, v       [B, S, Hkv, dh]
  kv cache   [B, S_r, Hkv, dh]  (S_r = s_max, or the window for 'la')

The KV cache is updated IN PLACE: `attention` writes the new keys and
values into the cache tensors it is given and returns the same tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist import lm_blocks as blk
from . import common

F32 = torch.float32
NEG_INF = -1.0e30


class Attention(torch.nn.Module):
    """Projections of one attention block; `forward` is `attention`."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        P = common.param
        self.wq = P((d, H * dh), dtype, device)
        self.wk = P((d, Hkv * dh), dtype, device)
        self.wv = P((d, Hkv * dh), dtype, device)
        self.wo = P((H * dh, d), dtype, device)
        if cfg.qk_norm:                 # [head_dim] gains in the model dtype
            self.q_gamma = P((dh,), dtype, device)
            self.k_gamma = P((dh,), dtype, device)

    def forward(self, x, positions, **kw):
        return attention(self.cfg, self, x, positions, **kw)


@torch.no_grad()
def init_attn(p: Attention, generator) -> None:
    for name in ("wq", "wk", "wv", "wo"):
        common.init_dense(getattr(p, name), generator)
    if p.cfg.qk_norm:
        p.q_gamma.fill_(1.0)
        p.k_gamma.fill_(1.0)


def _pick_chunk(n: int, target: int) -> int:
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def _visible(i, j, cq, ck, q_offset, causal, window):
    """Can kv chunk j contribute to q chunk i at all?"""
    q_lo = i * cq + q_offset
    q_hi = q_lo + cq - 1
    k_lo = j * ck
    k_hi = k_lo + ck - 1
    if causal and k_lo > q_hi:
        return False
    # the weakest window constraint in the chunk comes from the earliest
    # query row: kpos > q_lo - window for some kpos in the kv chunk
    if window is not None and k_hi <= q_lo - window:
        return False
    return True


def _mask(qpos, kpos, causal, window):
    mask = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                      dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def kv_chunks(t: int, s: int, cq: int, ck: int, q_offset: int,
              causal: bool, window: Optional[int]):
    """For each of the t // cq q chunks, the kv chunks `_chunked_gqa`
    visits, in its order (ascending; every one of the s // ck without a
    causal mask or a window, as the JAX package's dense variant)."""
    return [[j for j in range(s // ck)
             if _visible(i, j, cq, ck, q_offset, causal, window)]
            for i in range(t // cq)]


def _chunked_gqa(q, k, v, *, causal: bool, window: Optional[int],
                 softcap: Optional[float], scale: float, q_offset: int,
                 chunk_q: int = 512, chunk_k: int = 1024):
    """Flash-style attention over the visible (q chunk, kv chunk) pairs,
    in the order of the JAX package's pruned variant (`BLOCK_PRUNE=True`):
    for each q chunk, the online softmax runs over its visible kv chunks
    in ascending order; a q chunk with none stays zero.  With neither a
    causal mask nor a window every pair is visible, which is the dense
    variant's computation.

    q: [B, Hkv, G, T, dh];  k, v: [B, S, Hkv, dh].  Returns like q."""
    b, hkv, g, t, dh = q.shape
    s = k.shape[1]
    cq = _pick_chunk(t, chunk_q)
    ck = _pick_chunk(s, chunk_k)
    k_ = k.permute(0, 2, 1, 3)                   # [B, Hkv, S, dh]
    v_ = v.permute(0, 2, 1, 3)
    dev = q.device
    out = torch.zeros_like(q)
    for i, js in enumerate(kv_chunks(t, s, cq, ck, q_offset, causal,
                                     window)):
        if not js:
            continue
        qi = q[:, :, :, i * cq:(i + 1) * cq].to(F32)
        m = torch.full((b, hkv, g, cq), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=F32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, dh), dtype=F32, device=dev)
        qpos = i * cq + torch.arange(cq, device=dev)[:, None] + q_offset
        for j in js:
            kj = k_[:, :, j * ck:(j + 1) * ck].to(F32)
            vj = v_[:, :, j * ck:(j + 1) * ck].to(F32)
            sc = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * scale
            if softcap is not None:
                sc = softcap * torch.tanh(sc / softcap)
            kpos = j * ck + torch.arange(ck, device=dev)[None, :]
            sc = torch.where(_mask(qpos, kpos, causal, window), sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vj)
            m = m_new
        safe = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, :, :, i * cq:(i + 1) * cq] = (acc / safe[..., None]).to(
            q.dtype)
    return out


def _direct_gqa(q, k, v, *, causal, window, softcap, scale, q_offset):
    """Small-shape einsum path (prompts, smoke tests)."""
    b, hkv, g, t, dh = q.shape
    s = k.shape[1]
    dev = q.device
    sc = torch.einsum("bhgqd,bshd->bhgqs", q.to(F32), k.to(F32)) * scale
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    qpos = torch.arange(t, device=dev)[:, None] + q_offset
    kpos = torch.arange(s, device=dev)[None, :]
    sc = torch.where(_mask(qpos, kpos, causal, window), sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqs,bshd->bhgqd", p, v.to(F32))
    return out.to(q.dtype)


def _decode_gqa(q, k, v, *, causal, window, softcap, scale, qpos, kpos):
    """Cache read with explicit absolute position arrays (ring-aware).

    qpos: [T] (or per-slot [B, T]) absolute query positions; kpos: [S]
    (or [B, S]) absolute position stored in each cache slot (negative and
    stale slots are masked by the causal and window conditions)."""
    sc = torch.einsum("bhgqd,bshd->bhgqs", q.to(F32), k.to(F32)) * scale
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    mask = _mask(qp, kp, causal, window) & (kp >= 0)
    if mask.dim() == 2:
        mask = mask[None]
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqs,bshd->bhgqd", p, v.to(F32))
    return out.to(q.dtype)


def attention(cfg: ModelConfig, p: Attention, x, positions, *,
              causal: bool = True, window: Optional[int] = None,
              cache: Optional[Tuple] = None, cache_pos=None,
              kv_override=None, chunk_q: int = 512, chunk_k: int = 1024):
    """Full attention block.  Returns (y [B,T,d], cache or None).

    cache: (k_cache, v_cache) each [B, S_r, Hkv, dh], updated in place;
    cache_pos: tokens already in the cache, a 0-dim tensor when all rows
    advance in lockstep or [B] for per-slot serving.  A cache with T > 1
    is a prefill, which starts at position 0.

    kv_override (cross-attention): a (k, v) pair [B, S, Hkv, dh], or an
    object whose `.enc_out` [B, S, d] this layer's `wk` / `wv` project.
    Then q and k are not rotated, the attention is not causal, starts at
    position 0 and uses no cache (the caller passes none)."""
    B, T, d = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    dev = x.device

    q = blk.linear(x, p.wq).view(B, T, H, dh)
    if kv_override is None:
        k = blk.linear(x, p.wk).view(B, T, Hkv, dh)
        v = blk.linear(x, p.wv).view(B, T, Hkv, dh)
    elif isinstance(kv_override, tuple):
        k, v = kv_override
    else:
        enc = kv_override.enc_out
        S = enc.shape[1]
        k = blk.linear(enc, p.wk).view(B, S, Hkv, dh)
        v = blk.linear(enc, p.wv).view(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = common.rms_norm(q, blk.use(p.q_gamma), cfg.norm_eps)
        k = common.rms_norm(k, blk.use(p.k_gamma), cfg.norm_eps)
    if kv_override is None:
        q = common.rope(q, positions, cfg.rope_theta)
        k = common.rope(k, positions, cfg.rope_theta)

    # ----- KV cache: a ring buffer of S_r slots; position p lives in slot
    # p mod S_r (floor mod: torch.remainder, never torch.fmod) -----------
    attend_from_cache = False
    if cache is not None:
        kc, vc = cache
        S_r = kc.shape[1]
        if T > S_r:                     # only the last S_r tokens survive
            k_w, v_w = k[:, -S_r:], v[:, -S_r:]
            pw = cache_pos[..., None] + T - S_r + torch.arange(S_r,
                                                               device=dev)
        else:
            k_w, v_w = k, v
            pw = cache_pos[..., None] + torch.arange(T, device=dev)
        slots = torch.remainder(pw, S_r)
        if slots.dim() == 1:
            kc[:, slots] = k_w.to(kc.dtype)
            vc[:, slots] = v_w.to(vc.dtype)
        else:                           # per-slot offsets: row b at slots[b]
            bi = torch.arange(B, device=dev)[:, None]
            kc[bi, slots] = k_w.to(kc.dtype)
            vc[bi, slots] = v_w.to(vc.dtype)
        cache = (kc, vc)
        attend_from_cache = T == 1      # decode reads the ring

    qg = q.view(B, T, Hkv, G, dh).permute(0, 2, 3, 1, 4)
    scale = dh ** -0.5

    if attend_from_cache:
        kc, vc = cache
        S_r = kc.shape[1]
        qpos = cache_pos[..., None] + torch.arange(T, device=dev)
        last = cache_pos + T - 1
        slot_i = torch.arange(S_r, device=dev)
        # the most recent absolute position stored in slot i
        kpos = last[..., None] - torch.remainder(last[..., None] - slot_i,
                                                 S_r)
        out = _decode_gqa(qg, kc, vc, causal=causal, window=window,
                          softcap=cfg.softcap, scale=scale, qpos=qpos,
                          kpos=kpos)
    else:
        s_len = k.shape[1]
        if cache is not None:
            q_offset = 0
        elif kv_override is not None:
            causal, q_offset = False, 0
        else:
            q_offset = s_len - T
        kw = dict(causal=causal, window=window, softcap=cfg.softcap,
                  scale=scale, q_offset=q_offset)
        if T * s_len > 1024 * 2048:
            out = _chunked_gqa(qg, k, v, chunk_q=chunk_q, chunk_k=chunk_k,
                               **kw)
        else:
            out = _direct_gqa(qg, k, v, **kw)

    y = out.permute(0, 3, 1, 2, 4).reshape(B, T, H * dh)
    return blk.linear(y, p.wo), cache
