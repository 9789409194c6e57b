"""Serving launcher: batched requests against a (smoke or full) config.

  python -m repro_torch.launch.serve --arch <id> [--smoke]
      [--requests 8] [--batch 4] [--max-new 16] [--s-max 128] [--seed 0]
      [--device cuda|cpu]

Runs the port's `ServeEngine` on the card (`--device cuda`, the default;
it raises without one) or on the CPU.  Every architecture of the JAX
package is ported: `recurrentgemma-2b` (its scan through the RG-LRU
kernel on the card, the plain version on the CPU), and in plain PyTorch
`rwkv6-1.6b`, `granite-moe-3b-a800m`, `qwen3-0.6b`, `minicpm-2b`,
`internlm2-20b`, `gemma3-27b`, `llama4-maverick-400b-a17b`,
`llava-next-34b` (its text path: the engine takes token prompts) and
`seamless-m4t-medium` (the engine takes no encoder input, so its
cross-attention layers attend over the decoder's own states, as the JAX
package's engine does).  The weights are the port's own random init from
`--seed`.  Prints the same `[serve]` line as `python -m
repro.launch.serve`, then the kernel launch counts.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, dev)
    eng = ServeEngine(cfg, params, batch=args.batch, s_max=args.s_max,
                      seed=args.seed, device=dev)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(4, 24))).astype(np.int32),
        max_new=args.max_new) for _ in range(args.requests)]
    ops.reset_launch_counts()
    t0 = time.time()
    done = eng.run(reqs)
    wall = time.time() - t0
    n = sum(r.out.shape[0] for r in done)
    print(f"[serve] {len(done)} requests, {n} tokens, {n/wall:.1f} tok/s")
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"[serve] {args.device}: {eng.stats['admissions']} slot prefills, "
          f"{eng.stats['decode_steps']} decode steps, kernel launches "
          f"{counts or 'none (plain PyTorch versions on the CPU)'}")
    return done


if __name__ == "__main__":
    main()
