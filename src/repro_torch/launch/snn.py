"""DPSNN simulation launcher on PyTorch (the paper's workload).

  python -m repro_torch.launch.snn --grid 8x8 --steps 500 [--shards H]
      [--placement block|scatter] [--profile ring3|gaussian:sigma=1.5|...]
      [--device cuda|cpu]

Runs the dense DPSNN-STDP step through the hand-written CUDA kernels on the
card (`--device cuda`, the default) or through their plain PyTorch versions
on the CPU.  `--shards H` stacks H logical shards on the one device; the
raster is identical for every H and placement (paper Table 1).  Prints the
same `[snn]` lines as `python -m repro.launch.snn`.

Not ported yet, and refused with the ROADMAP item that ports it:
`--delivery event` (queue 1, item 6), `--connectivity-mode streamed:...`
(item 7) and `--ckpt-dir` (item 9).
"""
from __future__ import annotations

import argparse

from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                              observables, profiles)
from repro_torch.core.step_program import check_supported


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--neurons-per-column", type=int, default=1000)
    ap.add_argument("--synapses", type=int, default=200)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--placement", default="block",
                    choices=["block", "scatter"])
    ap.add_argument("--profile", default="ring3",
                    help="lateral-connectivity profile spec "
                         "(repro_torch.core.profiles): ring3 | ringN | "
                         "ring:max_ring=N | gaussian:sigma=S | "
                         "exponential:lambda=L")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--delivery", default="dense")
    ap.add_argument("--connectivity-mode", default="materialized")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    if args.ckpt_dir:
        ap.error("--ckpt-dir: checkpoints are not ported yet "
                 "(ROADMAP queue 1, item 9)")
    gx, gy = (int(v) for v in args.grid.split("x"))
    cfg = GridConfig(grid_x=gx, grid_y=gy,
                     neurons_per_column=args.neurons_per_column,
                     synapses_per_neuron=args.synapses,
                     connectivity=args.profile)
    eng = EngineConfig(n_shards=args.shards, placement=args.placement,
                       delivery=args.delivery,
                       connectivity=args.connectivity_mode)
    try:
        check_supported(eng)
    except NotImplementedError as e:
        ap.error(str(e))
    prof = profiles.from_config(cfg)       # fail fast on a bad spec
    print(f"[snn] {cfg.n_neurons} neurons / {cfg.n_synapses} synapses "
          f"on {args.shards} shards (allgather, {args.placement}, "
          f"{prof.spec()} reach={prof.reach()}, {args.device})")

    sp = StepProgram(cfg, eng, device=args.device)
    state, raster, _ = sp.run(sp.init_state(), 0, args.steps)
    rate = observables.mean_rate_hz(raster.cpu().numpy(), cfg.n_neurons)
    print(f"[snn] final-window rate {rate:.1f} Hz; done at t={args.steps} ms")
    return rate


if __name__ == "__main__":
    main()
