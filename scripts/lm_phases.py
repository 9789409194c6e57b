"""Run chip_smoke.py's LM serving phases alone on one card.

    python3 scripts/lm_phases.py [--families-only | --frontends-only]

The card's name and power limit (`phase_card`), the kernels
(`phase_build`), then `lm_check` (recurrentgemma-2b at SMOKE against
`lm_reference.json`), `lm_serve` and `lm_profile` (recurrentgemma-2b at
full width), `lm_families_check` (the other seven decoder-only archs at
SMOKE against their entries), `lm_families_serve` (rwkv6-1.6b,
granite-moe-3b-a800m and qwen3-0.6b at full width), `lm_frontends_check`
(seamless-m4t-medium and llava-next-34b at SMOKE against their entries
and frontend runs) and `lm_frontends_serve` (both at full width), each
printing chip_smoke's JSON lines and its seconds.  `--families-only` runs
only the families' two phases, `--frontends-only` only the frontends'.
Exits 1 if a phase failed.  About four minutes on an H100.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    cs.import_port()
    torch = cs.torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cs.phase_card()
    cs.phase_build()
    families = [("lm_families_check", cs.phase_lm_families_check),
                ("lm_families_serve", cs.phase_lm_families_serve)]
    frontends = [("lm_frontends_check", cs.phase_lm_frontends_check),
                 ("lm_frontends_serve", cs.phase_lm_frontends_serve)]
    phases = families + frontends
    if "--families-only" in argv:
        phases = families
    elif "--frontends-only" in argv:
        phases = frontends
    else:
        def rg():
            params, _ = cs.phase_lm_serve()
            cs.phase_lm_profile(params)
        phases = [("lm_check", cs.phase_lm_check),
                  ("lm_serve", rg)] + phases
    rc = 0
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except cs.PhaseFailed as e:
            print(f"{name} FAILED: {e}", file=sys.stderr, flush=True)
            rc = 1
        torch.cuda.empty_cache()
        print(json.dumps({"phase": f"{name}_seconds",
                          "seconds": time.perf_counter() - t0}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
