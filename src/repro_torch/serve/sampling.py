"""Token sampling strategies (port of `repro.serve.sampling`)."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary (the first maximum on ties, as in JAX)."""
    return logits.argmax(-1)


def temperature(generator: torch.Generator, logits: torch.Tensor,
                temp: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """A categorical draw from softmax(logits / temp), optionally over the
    top_k logits only.  logits [..., V] -> [...]; the draw comes from
    `generator`, so it is not JAX's."""
    lf = logits.to(torch.float32) / max(temp, 1e-6)
    if top_k:
        thresh = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < thresh, -1e30, lf)
    probs = torch.softmax(lf, dim=-1).reshape(-1, lf.shape[-1])
    draw = torch.multinomial(probs, 1, generator=generator)
    return draw.view(lf.shape[:-1])
