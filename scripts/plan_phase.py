"""Run chip_smoke.py's `plan` phase alone on one card.

    python3 scripts/plan_phase.py

The card's name and power limit (`phase_card`), the kernels
(`phase_build`), then the two experiment plans of the `plan` phase
(`run_plans`: the full-width 8-cell plan and the quick plan's 15 cells,
each run twice, the report and the dashboard) one after the other with
nothing else on the card, printing chip_smoke's `plan` line: the cells'
walls, phase splits and times per synaptic event are then their own
(chip_smoke.py runs the plans beside `ckpt_check` and `simserve_check`
and marks its line as contended).  Exits 1 if a plan failed.  About four minutes on an H100.
"""
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    cs.import_port()
    if not cs.torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.phase_card()
    cs.phase_build()
    try:
        cs.phase_plan(card, cs.run_plans(at_once=False))
    except cs.PhaseFailed as e:
        print(f"plan FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
