"""Run chip_smoke.py's training phases alone on one card.

    python3 scripts/train_phases.py

The card's name and power limit (`phase_card`), the kernels
(`phase_build`), then recurrentgemma-2b's weights drawn at full width as
`lm_serve` draws them (its serving run skipped), `train_full` on them,
`train_kernels` (the backward scan kernel, with layer 0's inputs from
`train_full`) and `train_check` (SMOKE against `train_reference.json`),
each printing chip_smoke's JSON lines and its seconds.  Exits 1 if a phase
failed.
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
    torch = cs.torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cs.phase_card()
    cs.phase_build()
    rc, layer0 = 0, None
    t0 = time.perf_counter()
    cfg = cs.get_config(cs.LM_ARCH)
    params = cs.lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")

    def full():
        nonlocal layer0
        _, layer0, _ = cs.phase_train_full(params)

    for name, run in (("train_full", full),
                      ("train_kernels", lambda: cs.phase_train_kernels(
                          layer0)),
                      ("train_check", cs.phase_train_check)):
        try:
            run()
        except cs.PhaseFailed as e:
            print(f"{name} FAILED: {e}", file=sys.stderr, flush=True)
            rc = 1
        if name == "train_full":
            del params
        torch.cuda.empty_cache()
        print(json.dumps({"phase": f"{name}_seconds",
                          "seconds": time.perf_counter() - t0}), flush=True)
        t0 = time.perf_counter()
    return rc


if __name__ == "__main__":
    sys.exit(main())
