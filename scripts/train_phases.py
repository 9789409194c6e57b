"""Run chip_smoke.py's training phases alone on one card.

    python3 scripts/train_phases.py [--sharded-only] [--layers N]

The card's name and power limit (`phase_card`), the kernels
(`phase_build`), then recurrentgemma-2b's weights drawn at full width as
`lm_serve` draws them (its serving run skipped), `train_full` on them,
`train_kernels` (the backward scan kernel, with layer 0's inputs from
`train_full`), `train_check` (SMOKE against `train_reference.json`) and
`train_sharded` (granite-moe-3b-a800m at full width over a 2x2 mesh of
four ranks on the card against one process), each printing chip_smoke's
JSON lines and its seconds.  `--sharded-only` runs the card's line and
`train_sharded` alone (it builds no kernel: granite's path reaches none);
`--layers N` sets its depth (default chip_smoke's TRAIN_SHARDED).  Exits 1
if a phase failed.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sharded-only", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    cs.import_port()
    torch = cs.torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.phase_card()
    sharded = dict(cs.TRAIN_SHARDED)
    if args.layers:
        sharded["layers"] = args.layers
    phases = [("train_sharded", lambda: cs.phase_train_sharded(
        card, args=sharded))]
    rc, layer0 = 0, None
    if not args.sharded_only:
        cs.phase_build()
        cfg = cs.get_config(cs.LM_ARCH)
        params = [cs.lm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")]

        def full():
            nonlocal layer0
            _, layer0, _ = cs.phase_train_full(params[0])
            params.clear()

        phases = [("train_full", full),
                  ("train_kernels", lambda: cs.phase_train_kernels(layer0)),
                  ("train_check", cs.phase_train_check)] + phases
    t0 = time.perf_counter()
    for name, run in phases:
        try:
            run()
        except cs.PhaseFailed as e:
            print(f"{name} FAILED: {e}", file=sys.stderr, flush=True)
            rc = 1
        torch.cuda.empty_cache()
        print(json.dumps({"phase": f"{name}_seconds",
                          "seconds": time.perf_counter() - t0}), flush=True)
        t0 = time.perf_counter()
    return rc


if __name__ == "__main__":
    sys.exit(main())
