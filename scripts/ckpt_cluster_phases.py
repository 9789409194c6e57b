"""Run chip_smoke.py's checkpoint and cluster phases alone on one card.

    python3 scripts/ckpt_cluster_phases.py

The card's name and power limit (`phase_card`), the kernels
(`phase_build`), the dense 8x8 program's state at t = 50
(`_ckpt8_state`), then `ckpt_check`, `cluster_check` and the
`cluster_scaling` quick sweep, each printing chip_smoke's JSON line (the
sweep: its deterministic and wall keys) and its seconds.  Exits 1 if a
phase failed.  About four minutes on an H100.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    cs.import_port()
    torch, StepProgram = cs.torch, cs.StepProgram
    GridConfig, EngineConfig = cs.GridConfig, cs.EngineConfig
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.phase_card()
    cs.phase_build()
    t0 = time.perf_counter()
    sp8 = StepProgram(GridConfig(grid_x=8, grid_y=8), EngineConfig(),
                      device="cuda")
    ckpt8 = cs._ckpt8_state(sp8)
    del sp8
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "state_8x8",
                      "seconds": time.perf_counter() - t0}), flush=True)
    rc = 0
    for name, run in (("ckpt_check", lambda: cs.phase_ckpt(card, ckpt8)),
                      ("cluster_check", lambda: cs.phase_cluster(card))):
        try:
            run()
        except cs.PhaseFailed as e:
            print(f"{name} FAILED: {e}", file=sys.stderr, flush=True)
            rc = 1
    t0 = time.perf_counter()
    rep = cs.cluster_cli.sweep_report(quick=True, device="cuda")
    print(json.dumps({"phase": "cluster_scaling_quick",
                      "seconds": time.perf_counter() - t0,
                      "deterministic": rep["deterministic"],
                      "wall": rep["wall"]}), flush=True)
    if not rep["deterministic"]["identical_across_procs"]:
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
