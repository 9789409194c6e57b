"""DPSNN simulation launcher on PyTorch (the paper's workload).

  python -m repro_torch.launch.snn --grid 8x8 --steps 500 [--shards H]
      [--placement block|scatter] [--profile ring3|gaussian:sigma=1.5|...]
      [--exchange allgather|halo|hier [--hier-groups G]]
      [--exchange-schedule sync|pipelined] [--delivery dense|event]
      [--connectivity-mode materialized|streamed:chunk=K] [--device cuda|cpu]

Runs the DPSNN-STDP step through the hand-written CUDA kernels on the
card (`--device cuda`, the default; `run` replays a captured CUDA graph)
or through their plain PyTorch versions on the CPU, with dense (O(E)
arrival flags) or event (O(spikes x fan-out) event lists) delivery.
`--connectivity-mode streamed:chunk=K` regenerates each chunk of K target
columns' synapse tables inside the step instead of holding them whole
(dense delivery; the same raster and weights).  `--shards H` stacks H
logical shards on the one device; the
raster is identical for every H and placement (paper Table 1).  Prints the
same `[snn]` lines as `python -m repro.launch.snn`.  With `--exchange` or
`--exchange-schedule` it also runs the same steps through
`StepProgram.time_phases` (the paper's Table 2 split, with that exchange
wire and schedule) and prints its per-phase walls; the shards of 'hier'
are `--hier-groups` groups without a job.

As a rank of a job (the REPRO_CLUSTER_* variables, `repro_torch._flags`,
or torchrun's), it joins the job before it touches a device, and
`--shards H` runs over the job's R ranks, H / R shards each, with real
collectives (`core.distributed`; hier's groups are the ranks' blocks):

    torchrun --nproc-per-node 4 -m repro_torch.launch.snn --grid 2x2 \
        --shards 4 --exchange halo --device cpu

The primary prints the `[snn]` lines, with the process count and the wire
(gloo, gloo staged through pinned host memory where ranks share a GPU,
or NCCL).

Not ported yet, and refused with the ROADMAP item that ports it:
`--ckpt-dir` (queue 1, item 9).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.cluster import runtime
from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                              observables, profiles, stream_engine)
from repro_torch.core.step_program import check_supported
from repro_torch.dist.mesh import make_snn_mesh


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
    ap.add_argument("--exchange", default=None,
                    choices=["allgather", "halo", "hier"])
    ap.add_argument("--exchange-schedule", default=None,
                    choices=["sync", "pipelined"],
                    help="'pipelined' issues the spike exchange before the "
                         "LTP half of phase A and delivers one step later "
                         "(bit-identical outputs)")
    ap.add_argument("--hier-groups", type=int, default=None,
                    help="shard groups of --exchange hier")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the steps run (default: the job's device, "
                         "else cuda)")
    ap.add_argument("--delivery", default="dense",
                    choices=["dense", "event"])
    ap.add_argument("--connectivity-mode", default="materialized",
                    help="materialized | streamed:chunk=K (K target "
                         "columns' synapse tables regenerated a chunk at a "
                         "time inside the step; dense delivery)")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    if args.ckpt_dir:
        ap.error("--ckpt-dir: checkpoints are not ported yet "
                 "(ROADMAP queue 1, item 9)")
    # a rank of a job joins it before anything touches a device
    in_job = runtime.ensure_initialized(device=args.device)
    device = (runtime.job().device.type if in_job
              else args.device or "cuda")
    primary = runtime.is_primary()
    gx, gy = (int(v) for v in args.grid.split("x"))
    cfg = GridConfig(grid_x=gx, grid_y=gy,
                     neurons_per_column=args.neurons_per_column,
                     synapses_per_neuron=args.synapses,
                     connectivity=args.profile)
    split = args.exchange is not None or args.exchange_schedule is not None
    eng = EngineConfig(n_shards=args.shards, placement=args.placement,
                       exchange=args.exchange or "allgather",
                       exchange_schedule=args.exchange_schedule or "sync",
                       delivery=args.delivery,
                       connectivity=args.connectivity_mode)
    try:
        mesh = make_snn_mesh(args.shards) if in_job else None
        check_supported(eng, mesh)
    except (NotImplementedError, ValueError) as e:
        ap.error(str(e))
    prof = profiles.from_config(cfg)       # fail fast on a bad spec
    job = (f", {runtime.process_count()} processes over {mesh.backend}"
           if in_job else "")
    if primary:
        print(f"[snn] {cfg.n_neurons} neurons / {cfg.n_synapses} synapses "
              f"on {args.shards} shards ({eng.exchange}, {args.placement}, "
              f"{eng.delivery} delivery, {eng.connectivity} connectivity, "
              f"{prof.spec()} reach={prof.reach()}, {device}{job})",
              flush=True)

    sp = StepProgram(cfg, eng, device=device, mesh=mesh,
                     hier_groups=args.hier_groups)
    if split:
        try:
            sp.phase_fns()              # fail fast on the hier groups
        except ValueError as e:
            ap.error(str(e))
    state, raster, tm = sp.run(sp.place(sp.init_state()), 0, args.steps)
    raster = sp.gather_raster(raster)
    rate = (observables.mean_rate_hz(raster.numpy(), cfg.n_neurons)
            if primary else None)
    if split:
        _, times, rasters, counts = sp.time_phases(
            sp.init_state(), 0, args.steps, collect_rasters=True)
        if primary:
            same = np.array_equal(np.stack(rasters), raster.numpy())
            ms = {k: v / args.steps * 1e3 for k, v in times.items()}
            print(f"[snn] phases ({eng.exchange}, "
                  f"{eng.exchange_schedule}): phase A "
                  f"{ms['phase_a_s']:.4f}, exchange "
                  f"{ms['exchange_s']:.4f}, phase B {ms['phase_b_s']:.4f} "
                  f"ms/step; {counts['spikes']} spikes; raster "
                  f"{'equal to' if same else 'DIFFERS from'} the fused "
                  f"run's", flush=True)
            if not same:
                raise SystemExit("[snn] the phase split's raster differs "
                                 "from the fused run's")
    if args.delivery == "event":
        arrivals, sat = (int(x) for x in _summed(
            sp, tm.arrivals.sum(), state.sat.sum()))
        if primary:
            print(f"[snn] event delivery: {arrivals} arrivals, {sat} events "
                  f"dropped (sat)")
    if sp.splan is not None:
        full = sp.gather(state)
        if primary:
            ss = sp.spec.stream
            print(f"[snn] streamed: {ss.n_chunks} chunks of "
                  f"{ss.chunk_cols} column(s) a shard, live tables "
                  f"{stream_engine.live_table_bytes(sp.spec, sp.splan)} B "
                  f"a shard (the reference's accounting "
                  f"{stream_engine.streamed_table_bytes(sp.spec)} B); "
                  f"weights {sp.weight_signature(full).hex()[:16]}")
    if primary:
        print(f"[snn] final-window rate {rate:.1f} Hz; done at "
              f"t={args.steps} ms", flush=True)
    return rate


def _summed(sp, *xs):
    """Device scalars summed over the job's ranks (as they are without a
    mesh)."""
    import torch
    v = torch.stack([x.to(torch.int64) for x in xs])
    return sp.mesh.wire.all_reduce_sum(v) if sp.mesh is not None else v


if __name__ == "__main__":
    main()
