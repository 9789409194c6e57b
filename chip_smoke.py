"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port only (it imports neither jax nor the JAX package) and
prints one JSON line per phase.  The plain versions it runs on the CPU as
yardsticks run with ATen's and MKL's CPU kernels pinned to the code paths
every x86-64 host runs alike (`ATEN_CPU_CAPABILITY=default`,
`MKL_CBWR=COMPATIBLE`), so their bits do not depend on the host.

  card     the card's name and power limit (nvidia-smi), torch's name, the
           CPU kernels' instruction set;
  build    nvcc builds the kernels from `src/repro_torch/csrc` (one nvcc
           per source, all at once), and beside them `event.cu` alone
           with the arrivals' other target lookup (REPRO_ARRIVAL_TARGET
           flipped), the yardstick of the lookup the library keeps, and
           the `-Xptxas -v` reports the later phases print (INSPECTED);
  attn_sass  `-Xptxas -v` of the bf16 prefill and the decode attention
           sources (registers, spills) and the count of wgmma (HGMMA) and
           TMA load (UTMALDG) instructions in the prefill kernel's SASS
           (`cuobjdump`); fails if either is missing;
  kernels  each kernel on numpy-seeded inputs at the 8x8 main-path shapes
           (E = 12.8 M synapses, N = 64,000 neurons), bit-equal to its
           plain PyTorch version on a CPU copy of the inputs (the ordered
           sum and the STDP passes also to their plain versions on the
           card), timed with CUDA events beside its plain version, its
           memory/compute bound and, for the ordered sum, `index_add_`.
           The STDP passes (the main path's phase-A kernel
           `stdp_phase_a`, the fused arrival pass and ordered sum
           `stdp_arrival_current`, LTP, and the arrival pass alone) run on
           the 8x8 plan's own synapse arrays and row pointers, with the
           ring and spikes drawn at the main path's density (2.15%) and at
           10x it; they update their inputs in place, so every timed call
           starts from restored inputs and only the kernel is timed
           (events around it, profiler device time by its own name), and
           their bound counts the bytes these inputs make them move.  The
           phase-A row is also timed against the sequence it replaced
           (`stdp_arrival_current`, the stimulus, the constants,
           `izhikevich_update`, the mask and sum, `stdp_ltp`), and the
           fused arrival row against the pair it replaced (`stdp_arrival`
           then `segment_sum_ordered`), each bit-equal to what it
           replaced, on the same restored inputs: no PyTorch call does
           either; the phase-A kernel is also timed with t read from the
           step counter (as the path runs it) and with t a launch
           argument, in turns, twice each (the same bits).  Phase B's kernel (`arborize`, source-major over the
           plan's forward CSR; element-major where a sample of the spike
           flags shows 18% or more spiking) runs on the 8x8 plan's own
           tables with 2.15%, 10.75%, 21.5% and 43% of the sources
           spiking, bit-equal to its plain
           version (the reference's broadcast-compare) on a CPU copy and
           on the card, to the element-major kernel it replaced
           (`arborize_elements`) and to the sequence before that (gather,
           `nonzero`, index put), both timed beside it, its bound from the
           bytes the work needs (and counted by 32-B sectors, and the
           element-major design's); an all-False mask at t = -1 must set
           nothing.
           The event delivery's four ops (`event_arrival`,
           `event_neurons`, `event_ltp`, `event_emit`) run on the 8x8
           event plan's own tables with the ring's list, the neurons, the
           spikes and the sources drawn at 2.15% and 21.5% and compacted
           with the timed run's capacities (c_post = N, c_src = S), and at
           21.5% with c_post = 1,024 and the default c_src (both cut: sat
           counts the rest), each bit-equal to its plain version on a CPU
           copy and on the card, timed beside its bound, its plain version
           and, for the arrivals, `index_add_`, the same op built with
           the other target lookup (syn_tgt or a search of row_ptr; the
           same bits) at the main density and 10x, each one's place
           kernel alone, and the op's accesses at its events'
           synapses alone (w and plastic gathered, last_arr written, as
           PyTorch indexing calls); for the neuron pass (t and the
           stimulus row from the step counter, as the path calls it), the
           sequence it replaced (the window's rows, the stimulus,
           `izhikevich_update`, the copies, mask, sum and
           `compact_indices`) and, from i_syn to the end of LTP, the pass
           with `event_ltp` against that sequence with the LTP kernel
           they replaced (`event_ltp_rows`), each bit-equal, with device time
           and operations; for LTP, `event_compact` then `event_ltp` on a
           spike mask (the list, count, w, last_post and sat bit-equal to
           the plain versions on a CPU copy and on the card) beside
           `event_ltp_rows` on the same mask; for
           the emission, its delay loads alone (one indexing call).
           `event_emit` also runs on rings of
           21 and 40 slots (a 2x2 event plan at full width, delay_max 20
           and 39: the kernel scans 16 slots a pass), bit-equal to its
           plain version on a CPU copy and on the card, timed beside it
           (rows `d21`, `d40`).  Each of the six ops of the two paths
           (`stdp_phase_a`, `arborize` and the four event ops) also has
           a `[t_base]` row: its form with per-shard steps, as
           `simserve`'s folded round launches it (t from a step counter
           at 0, t_base[h] the shard's step), at simserve_timed's 8-tenant
           fold (8 slots of the 4x4 full-width plan at H = 1, shard h at
           step t + h, its inputs drawn at its own step at 2.15%),
           bit-equal to its plain version with the same per-shard steps
           on a CPU copy and on the card and, shard by shard, to each
           shard's solo launch at its own step, timed beside those 8 solo
           launches in turns on the same restored inputs.  The phase also
           prints ptxas's
           registers and spills of `stdp.cu`, `arborize.cu`, `event.cu`
           and `event_phase_a.cu`;
  check    both deliveries (`StepProgram(..., device="cuda").run`; the
           event one with capacities that drop nothing,
           `event_engine.no_drop_caps` and a ring of E events a slot) at
           4x4, full width, 150 steps, at H=1 block, H=4 block, H=4
           scatter: raster and weight signatures equal to the committed
           AVX-pinned JAX reference (`src/repro_torch/data/
           jax_reference.json`, `runs` and `event_runs`), `sat` 0, every
           kernel of the delivery's path (dense: `ops.SNN_KERNELS`; event:
           `ops.EVENT_KERNELS`) launched once per
           step by the eager loop (`graph=False`) and every other SNN
           kernel never.  Each run is the first of its program (an eager
           window, then the capture, then replays), and a second run
           (replays only) and the eager loop must give the same bits; the
           graph runs' eager launches plus their replays' (what the
           capture recorded, times the replays) must be one a step too.  A whole run of
           replays runs under `torch.cuda.set_sync_debug_mode("error")`,
           and after each H=4 run a few whole steps (phase A, the
           exchange, phase B) of each exchange wire (allgather, halo, hier
           in 2 groups) too (it fails if one synchronises);
  timed    each delivery at 8x8 (12.8 M synapses), H=1, 500 steps after a
           warm-up that captures the graph, as the captured graph's run
           and as the eager loop (the same bits): ms/step, launches (the
           eager loop's counted by the wrappers; the graph run's replays
           from what the capture recorded), peak
           memory, the paper's normalised metric
           (`bench.timing.norm_seconds`), synaptic events/s, the phase A /
           exchange / B split from `StepProgram.time_phases` (the
           synchronised pass), the sync-debug steps of each exchange wire
           at H=1, rate, raster signature, and for the event run `sat`
           (must be 0) and whether its raster equals the dense one;
  profile  device time by kernel, device busy and idle share, and device
           operations (kernels and copies) per step: the dense path over
           steps 0-19 (nearly silent), and each delivery, graph and eager,
           over the timed run's 500 steps (activity comes in bursts);
  stream_kernels  streamed connectivity's kernels: `chunk_tables` on the
           8x8 streamed plan's (K = 1, built on the card) first, an
           interior and the last chunk and on the ragged last chunk of a
           4x4 K = 3 plan at H = 4, bit-equal (row pointers and every kept
           entry) to the plain version on the card (and on a CPU copy for
           the interior and the ragged chunk), its flag clear, timed beside
           its plain version and two bounds (operations: SPLITMIX_OPS
           integer instructions a draw lane, counted in the SASS, at the
           int32 issue rate): the least work (the lanes the prefilter
           cannot skip, from `kref.chunk_prefilter` on this chunk, whose
           pass shares it prints) and the reference's draw order (three
           lanes a slot); each stage's device time (gen, scan, sort; a
           stage that reads none fails); the chunk windows of the phase-A row
           kernel (with LTP, t from the step counter), of LTP and of the
           element walk on the interior chunk at the main density,
           bit-equal to their plain versions on a CPU copy, timed on
           restored inputs; `chunk_tables[shard_id]`: the kernel on a
           block of scatter rows named by their shard ids (shards 2-3 of
           the 8x8 plan at H = 4, scatter, K = 1, the interior chunk),
           bit-equal to its plain version and to those rows of the
           all-shard call, timed beside its plain version and bound; row
           S's device ms beside run XF3's (0.0402743); ptxas's
           registers and spills of `stream.cu`;
  stream_check  streamed connectivity at 4x4 full width, 150 steps, K = 1
           and 3 (ragged at H = 4), three layouts: raster and weight
           signatures equal to `jax_reference.json`'s runs (the modes are
           bit-identical), graph = replays = eager, launches (chunk_tables
           twice a chunk a step, the row kernel and the element walk once),
           the flag clear, a run of replays under sync-debug; at K = 1,
           H = 1 the reference's host builder, timed, equals the plan and
           weights built on the card;
  stream_timed  the streamed 8x8 program (K = 1, H = 1, 64 chunks)
           STREAM_STEPS steps, graph and eager (the same bits, and the
           materialized run's raster and weights): ms a step, the capture's
           seconds, launches, device busy, operations a step and idle
           share, and the program's device bytes beside the materialized
           program's;
  mesh_check  the mesh (`core.distributed` over `torch.distributed`
           ranks, `bench.subproc.Ranks`; the ranks load the library
           the `build` phase made): R = 2 and R = 4 ranks sharing the one
           card (the wire gloo, staged through pinned host memory; NCCL
           where every rank has a card of its own) and one rank under
           NCCL, H = 4 shards, at 4x4 full width, 150 steps: dense
           {allgather, halo, hier} x {sync, pipelined}, scatter with
           allgather, event with allgather and halo (`no_drop_caps`, sat
           0), streamed K = 1 with halo sync and pipelined, and streamed
           K = 1 with scatter placement under halo sync and hier
           pipelined (a rank's block of scatter shards: the chunk
           kernel's shard ids) (NCCL: dense halo and allgather, and at
           R = 1 streamed K = 1 with scatter placement and halo); each
           cell's gathered raster and
           weights equal to `jax_reference.json`'s H = 4 run, every
           rank's kernels launched as the path launches them (eager), and
           the wire the one the runtime names; a failed rank fails the
           phase.  With two or more cards R = 2 also runs under NCCL
           (`nccl_multi_rank` says whether it ran);
  mesh_timed  the 8x8 dense halo program at H = 4 (12.8 M synapses),
           MESH_STEPS_8X8 steps, stacked in this process (R = 1: the
           captured graph's run) and over 4 ranks (eager), under each
           schedule: ms a step, `time_phases`' phase split and exchange
           share (its fence includes the wire), the raster equal across
           all four, beside the card's name and power limit;
  ckpt_check  checkpoints (`core.checkpoint`, `StepProgram.load`) at 4x4
           full width, 150 steps: each case of CKPT_CASES (dense H = 1 ->
           H = 4 block, H = 4 block -> scatter, event H = 4 -> H = 1 with
           the capacities that drop nothing, streamed K = 1 -> K = 2 at
           H = 4, and dense H = 4 -> H = 1 restored at t = 30, off the
           graph's window) runs 0 -> t on the card, saves, loads into a
           fresh program of the other layout and runs t -> 150: both
           windows' events give `jax_reference.json`'s raster signature
           and the final weights the restoring layout's weight signature;
           at 2x2 full width the file the card writes at t = 50 (dense,
           event) has the payload digest of the CPU plain path's; an R = 2
           job saves and an R = 4 job restores (sharing the card); at 8x8
           dense the keys', save's and load's seconds and the file's
           bytes (host work), beside the card and the host's CPUs (the
           plans, cluster_check and cluster_scaling run beside it, so the
           line marks its seconds as contended);
  cluster_check  `repro_torch.cluster run --supervise --ckpt-every 50`
           at 4x4 full width, H = 4 over 2 ranks sharing the card, 150
           steps, with `crash@step=50:rank=1` and with
           `corrupt_ckpt@step=100` (the two at once): each restarts,
           resumes at t = 50 (the corrupt epoch fails its sha256) and
           gives the h4_block signatures; restarts, steps salvaged and
           walls beside the card (its ranks are other processes: they
           run beside `ckpt_check`, `simserve_check` and the plans, then
           cluster_scaling's ranks run on the same thread, and the line,
           after simserve_check's, marks its walls as contended);
  plan     two experiment plans (`repro_torch.bench.plans`), written as
           JSON into a temporary directory and run on the card, each cell
           in a fresh interpreter or, at 2 processes, as a
           `repro_torch.cluster` launch of 2 ranks sharing the card: 4x4
           full width, 150 steps, phase_steps 10, reps 2, materialized
           and streamed K = 1 x halo and hier x block and scatter at H =
           4 over 1 and 2 processes (hier only over 2): 8 cells, each
           giving `jax_reference.json`'s h1_block raster signature and
           spikes; and the quick plan's content (2x2, 40 neurons a
           column, both deliveries, schedules and residencies, 1 and 2
           processes): 15 cells, each giving its plan_quick entry (the
           two plans at once, a thread each, beside `ckpt_check` and
           `simserve_check`: the cells are other processes, mostly
           start-up on the host; the line comes after simserve_check's,
           and the lines mark their times as contended).  Each plan runs again
           with `assert_complete` (0 cells executed);
           the merged report validates with every `identical_*` flag
           true, and the dashboard is written.  Per cell: the wall (the
           fastest rep, and each rep's), the phase split and the time per
           synaptic event;
  simserve_check  the multi-tenant service (`repro_torch.simserve`) at
           4x4 full width (3.2 M synapses a tenant): seeds 2013, 7, 99,
           5, 123456, 42 alternating dense and event delivery and seed
           2013 under event delivery, at H = 2, in 2 slots, rounds of 25
           steps, 150 steps each (queueing, preemption), the first
           running tenant evicted after round 2 and resumed at H = 4
           through its checkpoint; event tenants with capacities that
           drop nothing.  Every tenant's streamed signature equal to its
           solo `StepProgram.run` on the card, the seed-2013 pair equal to
           `jax_reference.json`'s h1_block runs, sat 0, one capture per
           shape key over 3 keys, preemptions > 0, and every kernel of
           both paths launched by the service (the counts the `[t_base]`
           rows carry).  The checks (`check`, the cases of `ckpt_check`,
           this one) build each layout's host tables once and reuse
           copies (`_shared_tables`: connectivity is a pure function of
           the grid, the shard count and the placement);
  simserve_timed  `simserve_throughput` at 4x4 full width, dense, H = 1:
           1, 4 and 8 tenants, 300 steps in rounds of 50: tenant-steps/s,
           the wall and the admissions' host builds, the paper's time per
           synaptic event, the device's idle share over a profiled round,
           beside the same tenants run one after another alone through
           `StepProgram.run` (each equal to its service run; one build and
           one capture a cell);
  bench    the ported suites (`repro_torch.bench`) on the card, one line
           per report (its env, config, deterministic and wall keys):
           `table1` quick (1x1, 4x4, 150 steps; the 4x4 row's raster
           signature must be the committed JAX reference's), `table1` at
           1x1, 4x4, 8x4 and 8x8 (16x16 left out for time), 300 steps, with
           each row's build seconds and peak memory, `table2` (2x2, H=1,
           halo, 200 steps) under `sync` and again under `pipelined`
           (equal raster signatures), `profile` (exchange x placement
           at 2x2, H=4, 150 steps; it raises unless every cell gives the
           same raster and totals), and `event_vs_dense`'s single-device
           rows (2x2, 500 neurons a column, 200 steps, stim 1 and 0: both
           deliveries' rasters must be equal), `cluster_scaling` quick
           (1 and 2 ranks on the card, run beside the checks above: the
           rasters must be equal; its walls are contended), and
           `connectivity_sweep` quick (6x6, H = 4, 40 steps; each of the
           four profiles' spikes and raster signature equal to
           `jax_reference.json`'s connectivity_sweep entries) and full
           (12x12, 100 neurons a column, M = 60, H = 8, 100 steps).

Then the LM serving path (`recurrentgemma-2b`, `repro_torch.serve`):

  lm_kernels  the RG-LRU scan kernel on numpy-seeded inputs at its prefill
              (1, 512, 2560), decode (4, 1, 2560), tail (3, 100, 96) and
              ragged (2, 77, 100) shapes and at prefill on views 4 bytes
              past an aligned address, bit-equal to its plain version on
              a CPU copy and on the card, timed beside its plain version
              and its bound;
  attn_kernels  the port's `kernels.ops.attention` (three hand-written
              attention kernels, picked by `kernels.flash_attention.variant`:
              "wgmma" for bf16 prefill, "splitkv" for T < 64, "simt" for
              the rest) at seven shapes: RecurrentGemma-2B's local attention
              (10 query heads over 1 KV head of 256, window 2048, bf16) at a
              2048-token prefill, a 4096-token prefill, batch-4 decode and a
              ragged 1000-token prefill, and fp32, softcap and ragged
              bidirectional shapes.  One call per shape with the launch
              counts reset before and read after; each row names the kernel
              the call took (`variant`), which must be the one the rule
              names; each output within 2e-5 (fp32) / one bf16 ulp (bf16:
              rtol 2^-7, atol 1e-4) of the plain version on a CPU copy and
              on the card; timed beside the plain version, its bound, and
              `scaled_dot_product_attention` at the same shape and scale
              (events and device time);
  lm_check    SMOKE size, fp32 and bf16, weights from the numpy seed of
              the committed JAX reference
              (`src/repro_torch/data/lm_reference.json`): `ServeEngine`
              (batch 2, s_max 48, the 32-slot window ring wraps) gives the
              reference's greedy tokens in fp32, request 0 gives the same
              tokens alone, the teacher-forced logits are within 2e-4
              (fp32) and 0.1 (bf16) of the reference, and the scan kernel
              ran once per RG-LRU layer and forward call;
  lm_serve    full width (26 layers, d 2560, vocab 256,000, bf16, the
              port's own init from a seeded CUDA generator): 8 requests
              (prompts of 16-512 tokens, 32 new tokens each) through
              `ServeEngine(batch=4, s_max=1024)`: parameter count and
              bytes, init seconds, prefill tokens/s, decode ms/step and
              tokens/s, peak memory, kernel launches (18 per forward
              call), every sampled logit finite, and the kernel bit-equal
              to its plain version on the real inputs the first admission
              gives layer 0;
  lm_profile  device time by kernel and the device's idle share over a
              short serving run at full width;
  train_full  recurrentgemma-2b trained at full width on lm_serve's
              weights (`train.train_state.create` turns their gradients
              on): batches of 4 x 512 from `data.pipeline.Batcher(seed=1)`,
              `train.step.make_train_step` with the launcher's WSD
              schedule, one warm-up step, three timed, one profiled:
              parameter count (equal to the JAX package's), ms a step,
              tokens/s, peak memory, every loss finite, the RG-LRU
              launches of each timed step (`rg_lru_scan` twice a layer,
              forward and recompute, `rg_lru_scan_bwd` once: 36 and 18),
              the device's idle share and the scan kernels' device ms;
  train_kernels  the backward scan kernel (`rg_lru_scan_bwd`) on
              numpy-seeded inputs at 1 x 512 x 2560, the training shape
              4 x 512 x 2560 and a ragged one, and on the inputs the
              full-width run's warm-up step gave layer 0: bit-equal to
              its plain version on a CPU copy and on the card, timed
              beside its plain version and its bound (20 B an element);
  train_check  SMOKE training on the card against
              `src/repro_torch/data/train_reference.json` (the JAX
              package's loss and gradients, AVX-pinned): for
              qwen3-0.6b, recurrentgemma-2b, rwkv6-1.6b and
              granite-moe-3b-a800m in fp32 and bf16 and
              seamless-m4t-medium and llava-next-34b in fp32, the loss
              and MoE aux within 2e-5 (fp32) / 0.05 (bf16), the global
              gradient norm and each leaf's sampled entries, largest
              magnitude and sum within 1e-3 (fp32) / 0.1 (bf16) of the
              leaf's largest magnitude (the sum times its size), the
              RG-LRU launches, and a second run bit for bit; then the
              reference's three-step `train.step` trajectories (losses
              within 1e-4, gradient norms within 1e-4 of theirs), each
              run twice, bit for bit;
  lm_families_check  the other seven decoder-only archs (RWKV-6, MoE,
              qk-norm, untied embeddings: LM_FAMILIES) as lm_check does
              it, each against its own entry of `lm_reference.json`: fp32
              greedy tokens equal, request 0 alone the same, teacher-forced
              logits within 2e-4 (fp32) and 0.1 (bf16), all finite, no
              kernel launched (their modules are plain PyTorch).  The MoE
              archs' bf16 pass is also run on the CPU and on the card with
              every routing decision recorded: a decision may differ only
              at a tie within the two devices' bf16 rounding (k-th and
              (k+1)-th probabilities closer than twice the largest gap
              between the devices' probabilities for that token), and
              with the CPU run's routing forced the card's logits are
              within 0.1 (as are the CPU run's);
  lm_families_serve  `rwkv6-1.6b`, `granite-moe-3b-a800m` and
              `qwen3-0.6b` at full width (bf16, the port's own init from a
              seeded CUDA generator): 8 requests (prompts of 8-24 tokens,
              32 new tokens each) through `ServeEngine(batch=4)`:
              parameter count (equal to the JAX package's), bytes and the
              time to read them once at the HBM rate, init seconds,
              prefill tokens/s, decode ms/step and tokens/s, peak memory,
              every sampled logit finite; then 2 decode steps of a full
              batch profiled: the device's idle share, its ms under each
              model function (`record_function` labels: attention,
              rwkv_time_mix, rwkv_channel_mix, moe, mlp) and the top
              kernels;
  lm_frontends_check  `seamless-m4t-medium` (enc-dec) and
              `llava-next-34b` (`embeds` input) at SMOKE, fp32 and bf16:
              the serving engine's run as lm_check holds it against the
              arch's entry of `lm_reference.json`, and the entry's
              `frontend` run (frame embeddings encoded before a prompt
              of tokens, or patch embeddings, drawn from the entry's
              numpy seed; `lm.prefill`, then `lm.decode_step` fed the
              reference's greedy tokens): logits within 2e-4 (fp32) and
              0.1 (bf16), fp32 greedy tokens equal, all finite, no
              kernel launched;
  lm_frontends_serve  both at full width (bf16, the port's own init
              from a seeded CUDA generator; the frames and patch
              embeddings from it too, their frontends being stubs):
              parameter count (equal to the JAX package's), bytes, the
              free memory before the init, init seconds; seamless
              encodes 4 x 512 frames (ms), prefills 4 prompts of 8-24
              tokens in lockstep from the cache's encoder output and
              takes 32 greedy steps, then serves 8 requests through
              `ServeEngine` (no encoder input, as in the JAX package);
              llava prefills 2 x 2,048 `embeds` positions (the chunked
              attention path, one call a layer) into 2,080 slots and
              takes 32 greedy steps; each reports prefill tokens/s,
              decode ms a step, peak memory, every sampled logit
              finite, and profiles of the prefill and of 2 decode steps
              (the device's idle share, its ms under the labels
              encoder, self_attention, cross_attention and mlp, the top
              kernels) beside the weight-read floor.

Then, where the kept end of the output holds them, train_full's and
train_kernels' main numbers again and the card's name and power limit
(nvidia-smi's line), the `{"kernels": [...]}` line (launches from the
timed eager run of the delivery whose path the kernel is on, or the
streamed timed eager run, counted by the wrappers; of the `[t_base]` rows from simserve_check's
service run; from the lm_serve run, from attn_kernels' one call per
shape, and from train_full's three timed steps) and, last,
`{"ok": true, "device": {...}}`.  Any failed phase exits non-zero before
that line.  Without a CUDA device, or without the rest of the repository
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
PEAK_FP32_PER_S = 67e12        # H100 SXM fp32, outside the tensor cores
PEAK_BF16_PER_S = 989e12       # H100 SXM bf16, dense tensor cores
PEAK_INT32_PER_S = 64 * 132 * 1.98e9   # H100 SXM int32: 64 lanes an SM
MAIN_STEPS = 500
SYNC_DEBUG_STEPS = 5     # timed: whole steps under sync-debug "error"
EXCHANGES = ("allgather", "halo", "hier")   # (hier: one group at H=1)
# bench: table1's rows (the JAX suite's four) at the suite's 300 steps;
# the paper's 256-column row (16x16, 51.2 M synapses; 50.7 s of the
# script, its build 51.1 s of that in PR 28's run F28c) is left out to
# keep the script inside its time limit beside the LM families' phases
TABLE1_ROWS = [(1, 1), (4, 4), (8, 4), (8, 8)]
# kernels phase: the STDP passes' inputs flag this share of the valid
# synapses and spike this share of the neurons (the 8x8 timed run's mean:
# 275,342 arrivals a step among 12.8 M synapses, 21.52 Hz), and 10x it
STDP_DENSITY = 0.0215
# kernels phase: the event neurons' and LTP's c_post in the third event row
# (21.5% of 64,000 neurons spike: the list is cut and sat counts the rest)
SMALL_C_POST = 1024
STDP_REPLACES = {"stdp_phase_a": "src/repro/kernels/izhikevich.py:37, "
                                 "src/repro/kernels/stdp.py:57, "
                                 "src/repro/kernels/stdp.py:81",
                 "stdp_arrival_current": "src/repro/kernels/stdp.py:57",
                 "stdp_arrival": "src/repro/kernels/stdp.py:57",
                 "stdp_ltp": "src/repro/kernels/stdp.py:81"}
# the event delivery's ops: their sources, the JAX lines they replace
# (plain jnp, no Pallas kernel) and the profiler's names of their kernels
EVENT_SOURCES = {"event_arrival": "src/repro_torch/csrc/event.cu",
                 "event_neurons": "src/repro_torch/csrc/event_phase_a.cu",
                 "event_ltp": "src/repro_torch/csrc/event_phase_a.cu",
                 "event_emit": "src/repro_torch/csrc/event.cu"}
# event_neurons: the Pallas neuron update on the event path (with the
# stimulus, mask and compaction of event_engine.py:141-228 around it)
EVENT_REPLACES = {"event_arrival": "src/repro/core/event_engine.py:150",
                  "event_neurons": "src/repro/kernels/izhikevich.py:37",
                  "event_ltp": "src/repro/core/event_engine.py:199",
                  "event_emit": "src/repro/core/event_engine.py:245"}
# csrc/event.cu's REPRO_ARRIVAL_TARGET: how the arrivals' place pass finds
# an event's target
ARRIVAL_TARGETS = {0: "syn_tgt", 1: "row_ptr search"}
EVENT_KERNEL_NAMES = {"event_arrival": ("arrival_place", "arrival_sum"),
                      "event_neurons": "neuron_scan",
                      "event_ltp": "ltp_synapses",
                      "event_ltp_rows": "event_ltp_kernel",
                      "event_emit": "emit_scan"}
# streamed connectivity: the check's chunk sizes (K = 3 leaves a ragged
# last chunk at H = 4, 4 columns a shard), the 8x8 timed run's steps (64
# chunks, each regenerated twice a step), the integer instructions of one
# splitmix64 draw lane (counted in the SASS of a kernel that draws one
# lane, less that of the same kernel copying its input, sm_90a, the port's
# flags), and chunk_tables' kernels, as the profiler names them
STREAM_CHECK_CHUNKS = (1, 3)
STREAM_STEPS = 100
SPLITMIX_OPS = 22
CHUNK_KERNELS = ("gen_kernel", "scan_kernel", "sort_kernel")
# the profiler's names of the STDP kernels (row_kernel<true, false> is
# phase A; <true, true> its chunk window on the streamed path)
STDP_KERNEL_NAMES = {"stdp_phase_a": "row_kernel<true, false>",
                     "stdp_arrival_current": "row_kernel<false, false>",
                     "stdp_arrival": "arrival_kernel",
                     "stdp_ltp": "ltp_kernel"}
LM_ARCH = "recurrentgemma-2b"
# (label, shape, bytes past an aligned address of the inputs on the card)
LM_SCAN_SHAPES = (("prefill", (1, 512, 2560), 0), ("decode", (4, 1, 2560), 0),
                  ("tail", (3, 100, 96), 0), ("ragged", (2, 77, 100), 0),
                  ("offset", (1, 512, 2560), 4))
LM_TOL = {"float32": 2e-4, "bfloat16": 0.1}
# lm_families_check: the other decoder-only archs, at SMOKE against their
# entries of lm_reference.json; lm_families_serve: three of them at full
# width, with the parameter counts of the JAX package's init_params
# (jax.eval_shape; tests/test_torch_lm_families.py holds them equal)
LM_FAMILIES = ("rwkv6-1.6b", "granite-moe-3b-a800m", "qwen3-0.6b",
               "minicpm-2b", "internlm2-20b", "gemma3-27b",
               "llama4-maverick-400b-a17b")
LM_FAMILIES_FULL = {"rwkv6-1.6b": 1_583_941_632,
                    "granite-moe-3b-a800m": 3_298_793_472,
                    "qwen3-0.6b": 596_049_920}
# lm_families_serve: 8 requests of 8-24 prompt tokens (RWKV prefills one
# token at a time) and 32 new tokens through ServeEngine(batch=4); the
# decode profile's steps
LM_FAMILIES_PROMPTS = (8, 24)
LM_FAMILIES_S_MAX = 64
LM_PROFILE_STEPS = 2
# lm_frontends_check / lm_frontends_serve: the archs whose input is more
# than tokens, with the JAX package's full-width parameter counts
# (tests/test_torch_lm_encdec.py holds them equal); seamless encodes B x S
# frames before a lockstep prefill of 8-24-token prompts (and serves 8
# requests through ServeEngine); llava prefills B x T `embeds` positions
# (LLaVA-NeXT's anyres gives up to 2,880; T x T > 2^21: the chunked
# attention path) into s_max slots; each then takes FRONTEND_NEW greedy
# lockstep steps
LM_FRONTENDS_FULL = {"seamless-m4t-medium": 614_739_968,
                     "llava-next-34b": 34_388_917_248}
SEAMLESS_FRAMES = (4, 512)
LLAVA_PROMPT = (2, 2048)
LLAVA_S_MAX = 2080
FRONTEND_NEW = 32
# attn_kernels: B x heads query heads over B x kv_heads KV heads (repeated
# to B x heads before the call).  Tolerances (rtol, atol): fp32 that of
# tests/test_kernels.py; bf16 one bf16 ulp of the output, since the kernel
# and the plain version both compute in fp32 and round once at the output
# (a typical |o| at these shapes is about 0.03, so 2e-2 would pass a kernel
# that drops a whole kv tile)
RG_LOCAL = dict(heads=10, kv_heads=1, D=256, dtype="bfloat16", causal=True,
                window=2048, softcap=None, qk_scale=1.0)
ATTN_SHAPES = (
    ("rg_local_prefill", dict(RG_LOCAL, B=1, T=2048, S=2048)),
    ("rg_local_long", dict(RG_LOCAL, B=1, T=4096, S=4096)),
    ("rg_local_decode", dict(RG_LOCAL, B=4, T=1, S=2048)),
    ("fp32_causal", dict(B=1, heads=16, kv_heads=16, T=1024, S=1024, D=128,
                         dtype="float32", causal=True, window=None,
                         softcap=None, qk_scale=1.0)),
    ("softcap", dict(B=1, heads=8, kv_heads=8, T=512, S=512, D=128,
                     dtype="bfloat16", causal=True, window=256, softcap=50.0,
                     qk_scale=4.0)),
    ("bidir_ragged", dict(B=1, heads=3, kv_heads=3, T=100, S=300, D=80,
                          dtype="float32", causal=False, window=64,
                          softcap=None, qk_scale=1.0)),
    ("rg_local_ragged", dict(RG_LOCAL, B=1, T=1000, S=1000)),
)
# each attention kernel's source, and the one `kernels.flash_attention.
# variant` must pick for each shape
ATTN_SOURCES = {"wgmma": "src/repro_torch/csrc/flash_attention_sm90.cu",
                "splitkv": "src/repro_torch/csrc/flash_decode.cu",
                "simt": "src/repro_torch/csrc/flash_attention.cu"}
ATTN_VARIANTS = {"rg_local_prefill": "wgmma", "rg_local_long": "wgmma",
                 "rg_local_decode": "splitkv", "fp32_causal": "simt",
                 "softcap": "wgmma", "bidir_ragged": "simt",
                 "rg_local_ragged": "wgmma"}
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-4)}
# simserve_check: the fleet's seeds (alternating dense and event delivery),
# its slots, round and steps; simserve_timed: the suite's steps and rounds
SIMSERVE_SEEDS = (2013, 7, 99, 5, 123456, 42)
SIMSERVE_SLOTS, SIMSERVE_ROUND, SIMSERVE_STEPS = 2, 25, 150
# the [t_base] kernel rows: simserve_timed's largest group, 8 tenants at
# H = 1, folded onto 8 shards
T_BASE_SLOTS = 8


class PhaseFailed(RuntimeError):
    pass


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets `at_s`, the seconds
    since the script started."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def _together(a, b) -> tuple:
    """a and b on one device: the card's where either lies there (the
    comparisons below are exact, so the device does not change their
    result, and the card's copy of the other is quicker than the host's
    pass over tens of millions of elements)."""
    dev = a.device if a.is_cuda else b.device
    return a.detach().to(dev), b.detach().to(dev)


def bit_equal(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = _together(a, b)
    if a.dtype.is_floating_point:
        return bool((a.view(torch.int32) == b.view(torch.int32)).all())
    return bool((a == b).all())


def max_abs_err(a, b) -> float:
    a, b = _together(a, b)
    if a.dtype == torch.bool:
        return float((a != b).sum())
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def cuda_ms(fn, calls: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Time of one fn() call in ms: CUDA events around `calls` calls back to
    back, over the count; the median of `reps` such runs.  For a kernel
    shorter than its launch this is the launch's cost, which is what the
    step pays; `device_ms` below has the kernel alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_kernel_events(prof):
    """(name, device microseconds, calls) of the CUDA kernels a
    torch.profiler run recorded (operator rows are left out: they repeat
    their kernels' time)."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((e.key, e.self_device_time_total, e.count))
    return rows


def device_ms(fn, calls: int = 10, restore=None, kernel="",
              skip="Memcpy DtoD") -> float:
    """The device time per call in ms (torch.profiler) of the CUDA kernels
    and copies whose name holds `kernel` (or one of a tuple of names; all
    of fn's by default) and not `skip` (the device-to-device copies of
    `restore()`, which runs before every call where fn updates its inputs
    in place).  A session whose profiler hands back no event of those
    kernels (CUPTI now and then returns none, also for kernels that ran)
    is profiled again, up to three sessions; None if none reads."""
    from torch.profiler import ProfilerActivity, profile
    restore = restore or (lambda: None)
    restore()
    fn()
    torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                restore()
                fn()
            torch.cuda.synchronize()
        rows = [us for k, us, _ in device_kernel_events(prof)
                if any(n in k for n in names) and skip not in k]
        if rows:
            return sum(rows) * 1e-3 / calls
    return None


def bound(n_bytes: float, n_flops: float,
          peak_flops: float = PEAK_FP32_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over `peak_flops` (the fp32 peak unless given)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    name, power = (s.strip() for s in line.split(",", 1))
    emit({"phase": "card", "name": name, "power_limit": power,
          "torch_device_name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cpu_capability": torch.backends.cpu.get_cpu_capability(),
          "mkl_cbwr": os.environ.get("MKL_CBWR")})
    return line


#: the sources whose ptxas report (`_build.inspect`, an nvcc of its own
#: each) the phases print: `phase_build` starts them all beside the build
INSPECTED = ("flash_attention_sm90.cu", "flash_decode.cu", "stdp.cu",
             "arborize.cu", "event.cu", "event_phase_a.cu", "stream.cu")
_INSPECTS: dict = {}


def _inspect(name: str) -> dict:
    """`_build.inspect(name)`: the report `phase_build` started, where it
    ran."""
    fut = _INSPECTS.get(name)
    return fut.result() if fut is not None else _build.inspect(name)


def phase_build():
    """Build the library, and `event.cu` alone with the arrivals' other
    target lookup beside it, and start the INSPECTED sources' reports;
    returns the latter's (kept lookup, other lookup, loaded library)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(INSPECTED))
    _INSPECTS.update({n: pool.submit(_build.inspect, n) for n in INSPECTED})
    pool.shutdown(wait=False)
    src = _build.CSRC / "event.cu"
    kept = int(re.search(r"#define REPRO_ARRIVAL_TARGET (\d)",
                         src.read_text()).group(1))
    other = 1 - kept
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = _build.BUILD_DIR / f"event_target{other}.o"
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.flags(src), f"-DREPRO_ARRIVAL_TARGET={other}",
         "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    path = _build.build()
    _build.library()
    log, rc = proc.communicate()[0], proc.returncode
    so = obj.with_suffix(".so")
    if rc == 0:
        link = subprocess.run(
            [_build.nvcc(), *_build.ARCH, "-shared", "-o", str(so), str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log, rc = log + link.stdout, link.returncode
    if rc != 0:
        raise PhaseFailed(f"event.cu with REPRO_ARRIVAL_TARGET={other} did "
                          f"not build:\n{log}")
    lib = ctypes.CDLL(str(so))
    lib.repro_event_arrival.argtypes = _build.SIGNATURES[
        "repro_event_arrival"]
    lib.repro_event_arrival.restype = ctypes.c_int
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path, HERE),
          "arrival_target": ARRIVAL_TARGETS[kept],
          "yardstick": os.path.relpath(so, HERE)})
    return kept, other, lib


@contextlib.contextmanager
def _kernel_library(lib):
    """The wrappers' launches inside the block go to `lib` (a library
    that holds the entry points they call there)."""
    saved, _build._lib = _build._lib, lib
    try:
        yield
    finally:
        _build._lib = saved


def phase_attn_sass():
    """What ptxas says of the bf16 prefill and the decode attention sources
    (registers, spills), and the prefill kernel's wgmma (HGMMA) and TMA
    load (UTMALDG) instructions in its SASS, where a disassembler is."""
    reports = [_inspect(name) for name in ("flash_attention_sm90.cu",
                                           "flash_decode.cu")]
    emit({"phase": "attn_sass", "reports": reports})
    counts = reports[0]["sass_counts"]
    if counts is not None and not (counts["HGMMA"] and counts["UTMALDG"]):
        raise PhaseFailed(f"flash_attention_sm90.cu's SASS lacks wgmma or "
                          f"TMA loads: {counts}")


def _neuron_inputs(rng, N: int):
    """numpy-seeded Izhikevich inputs at the main-path width."""
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    exc = np.arange(N) % 5 != 4
    return dict(
        v=f(rng.uniform(-80.0, 29.9, N)), u=f(rng.uniform(-20.0, 10.0, N)),
        current=f(rng.uniform(-10.0, 25.0, N)),
        a=f(np.where(exc, 0.02, 0.1)), b=f(np.full(N, 0.2)),
        c=f(np.full(N, -65.0)), d=f(np.where(exc, 8.0, 2.0)))


def _stdp_state(rng, plan_cpu: dict, D: int, r: int, t: float,
                density: float) -> dict:
    """numpy-seeded dynamic inputs of the STDP passes on a plan's arrays
    (CPU tensors): ring slot r flagged on `density` of the valid synapses
    (as phase B flags them), `density` of the neurons spiking, weights in
    [0, 10], last spike and arrival times within 200 steps or never."""
    valid = plan_cpu["valid"].numpy()
    H, E = valid.shape
    N = plan_cpu["row_ptr"].shape[1] - 1
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def times(shape):
        return f(np.where(rng.random(shape) < 0.7,
                          rng.uniform(t - 200.0, t, shape), engine.NEG_TIME))
    ring = np.zeros((H, D, E), bool)
    ring[:, r] = (rng.random((H, E)) < density) & valid
    return dict(ring=torch.from_numpy(ring), last_post=times((H, N)),
                w=f(rng.uniform(0.0, 10.0, (H, E))), last_arr=times((H, E)),
                spiked=torch.from_numpy(rng.random((H, N)) < density))


def _stdp_traffic(plan_cpu: dict, st: dict, r: int, half_neg: float):
    """({name: (bytes, flops)}, counts): what each STDP pass must move and
    compute on these inputs, each input byte read once and each output
    byte written once, counting only the synapses the data makes them
    touch (`csrc/stdp.cu`'s note)."""
    valid, plastic = plan_cpu["valid"], plan_cpu["plastic"]
    tgt, row_ptr = plan_cpu["tgt"], plan_cpu["row_ptr"]
    H, E = valid.shape
    N = row_ptr.shape[1] - 1
    flags = st["ring"][:, r]
    arr = flags & valid
    lp = torch.gather(st["last_post"], 1, tgt)
    arr_pl = arr & plastic
    ltd = arr_pl & (lp > half_neg)
    n = lambda m: int(m.sum())
    # per synapse: ring flag in, contrib out; per flag: valid in, flag
    # cleared; per arrival: plastic and w in, last_arr out; per plastic
    # arrival: syn_tgt and last_post[tgt] in; per LTD: w out; n_arrived
    a_bytes = (H * E * (1 + 4) + n(flags) * 2 + n(arr) * (1 + 4 + 4)
               + n(arr_pl) * (8 + 4) + n(ltd) * 4 + H * 8)
    # the fused pass: every ring flag, the row pointers and last_post in,
    # i_syn out; per arrival: plastic and w in, last_arr out, the flag
    # cleared; per LTD: w out; n_arrived
    c_bytes = (H * E + nbytes(row_ptr) + H * N * (4 + 4)
               + n(arr) * (1 + 4 + 4 + 1) + n(ltd) * 4 + H * 8)
    row = kref.rows_of_synapses(row_ptr, E)
    post = torch.cat([st["spiked"], st["spiked"].new_zeros(H, 1)],
                     1).gather(1, row)
    post_pl = post & plastic
    ltp = post_pl & (st["last_arr"] > half_neg)
    # per neuron: spiked in; per spiking neuron: its two row pointers in,
    # last_post out; per synapse of a spiking target: plastic in; per
    # plastic one: last_arr in; per LTP: w in and out
    l_bytes = (H * N + n(st["spiked"]) * (8 + 4) + n(post) + n(post_pl) * 4
               + n(ltp) * 8)
    counts = dict(flagged=n(flags), arrivals=n(arr), ltd=n(ltd),
                  spiking=n(st["spiked"]), synapses_of_spiking=n(post),
                  ltp=n(ltp))
    return {"stdp_arrival_current": (c_bytes, n(ltd) * 25 + n(arr)),
            "stdp_arrival": (a_bytes, n(ltd) * 25),
            "stdp_ltp": (l_bytes, n(ltp) * 25)}, counts


def in_place_ms(fn, restore, calls: int = 20, warmup: int = 3) -> float:
    """Time of one call of a kernel that updates its inputs, in ms: the
    inputs restored before every call, CUDA events around the call alone;
    the median of `calls`."""
    for _ in range(warmup):
        restore()
        fn()
    times = []
    for _ in range(calls):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _phase_a_inputs(rng, plan_cpu: dict, st: dict, stim, density: float):
    """numpy-seeded neuron state for the phase-A kernel beside `st`: about
    `density` of the neurons at or past the threshold (they spike), the
    others at rest, and the step's stimulus row `stim` (index, amp)."""
    H, N = plan_cpu["exc"].shape
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    v = np.where(rng.random((H, N)) < density, rng.uniform(30.0, 40.0, (H, N)),
                 rng.uniform(-80.0, -60.0, (H, N)))
    return dict(st, v=f(v), u=f(rng.uniform(-20.0, 10.0, (H, N))),
                stim_idx=stim[0].cpu(), stim_amp=stim[1].cpu())


def _phase_a_traffic(plan_cpu: dict, st: dict, spiked, r: int, t: float,
                     half_neg: float, current_bytes: int):
    """(bytes, flops) the phase-A kernel must move and compute on these
    inputs: the fused arrival pass's bytes less i_syn, 19 bytes a neuron
    (v and u in and out, its two flags, the spike out), the stimulus list,
    and LTP of the rows of the neurons that spiked (`spiked`, the plain
    version's): their row pointers and last_post, and per synapse plastic,
    per plastic one last_arr, per update w in and out."""
    plastic, row_ptr = plan_cpu["plastic"], plan_cpu["row_ptr"]
    H, E = plastic.shape
    N = row_ptr.shape[1] - 1
    n = lambda m: int(m.sum())
    row = kref.rows_of_synapses(row_ptr, E)
    post = torch.cat([spiked, spiked.new_zeros(H, 1)], 1).gather(1, row)
    post_pl = post & plastic
    # LTP reads last_arr after the arrival pass set it to t
    la = torch.where(st["ring"][:, r] & plan_cpu["valid"],
                     torch.tensor(np.float32(t)), st["last_arr"])
    ltp = post_pl & (la > half_neg)
    k = st["stim_idx"].shape[1]
    n_bytes = (current_bytes - H * N * 4 + H * N * 19 + H * k * 12 + H * 8
               + n(spiked) * (8 + 4) + n(post) + n(post_pl) * 4 + n(ltp) * 8)
    counts = dict(spiking=n(spiked), synapses_of_spiking=n(post),
                  ltp=n(ltp))
    return n_bytes, n(ltp) * 25 + H * N * 20, counts


def _stdp_rows(plan8, spec8):
    """The STDP passes (phase A in one kernel, the fused arrival and sum,
    the arrival pass alone, LTP) on plan8's own arrays at the main path's
    density (2.15% of the valid synapses arrive, 2.15% of the neurons
    spike) and at 10x it: bit-equal to the plain version on a CPU copy and
    on the card, in every output and updated state tensor, and timed
    alone; phase A also beside the sequence of kernels and ops it replaced
    (`stdp_arrival_current`, the stimulus, the constants, `izhikevich_update`,
    the mask and sum, `stdp_ltp`), and the fused arrival pass beside the
    pair it replaced, each bit-equal to what it replaced."""
    stdp, izh = spec8.stdp, spec8.izh
    H, E = plan8.syn_valid.shape
    N = plan8.gid.shape[1]
    D = spec8.cfg.n_delay_slots
    t = 1000.0
    r = int(t) % D
    half_neg = engine.NEG_TIME / 2
    ltd_kw = dict(a_minus=stdp.a_minus, tau_minus=stdp.tau_minus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    ltp_kw = dict(a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    izh_kw = dict(v_peak=izh.v_peak, dt=izh.dt, substeps=izh.v_substeps)
    pa_kw = dict(izh=izh, stdp=stdp, neg_time=engine.NEG_TIME,
                 with_ltp=True)
    pg = dict(valid=plan8.syn_valid, tgt=plan8.syn_tgt,
              plastic=plan8.syn_plastic, row_ptr=plan8.row_ptr,
              exc=plan8.exc_mask, neuron_valid=plan8.neuron_valid)
    pc = {k: v.cpu() for k, v in pg.items()}
    pg["seg"] = kref.make_segments(plan8.row_ptr, E)
    pc["seg"] = kref.make_segments(pc["row_ptr"], E)
    gids = torch.from_numpy(stimulus.stim_table(
        spec8.cfg, plan8.columns.cpu().numpy(), int(t), 1)).cuda()
    stim = stimulus.stim_inputs(spec8.cfg, plan8.columns,
                                engine.make_gid_to_local(spec8,
                                                         plan8.shard_id),
                                gids.to(torch.int64), spec8.n_local)
    stim = (stim[0][0], stim[1][0])
    rng = np.random.default_rng(2015)
    rows, failed = [], []
    for i, (label, density) in enumerate((("main", STDP_DENSITY),
                                          ("10x", 10 * STDP_DENSITY))):
        st = _stdp_state(rng, pc, D, r, t, density)
        traffic, counts = _stdp_traffic(pc, st, r, half_neg)
        st = _phase_a_inputs(np.random.default_rng(2017 + i), pc, st, stim,
                             density)
        saved = {k: v.cuda() for k, v in st.items()}
        work = {k: v.clone() for k, v in saved.items()}

        def restore(*names):
            for k in names:
                src, dst = saved[k], work[k]
                (dst[:, r] if k == "ring" else dst).copy_(
                    src[:, r] if k == "ring" else src)

        def phase_a(impl, d, p):
            spiked, n_arr, n_spk = impl.stdp_phase_a(
                d["ring"], r, p["seg"], *(
                    (p["valid"], p["tgt"]) if impl is kref else ()),
                p["plastic"], p["exc"], p["neuron_valid"], d["stim_idx"],
                d["stim_amp"], d["v"], d["u"], d["last_post"], d["w"],
                d["last_arr"], t, **pa_kw)
            return (spiked, n_arr, n_spk, d["v"], d["u"], d["w"],
                    d["last_arr"], d["last_post"], d["ring"])

        def sequence(d, p):
            # what the engine ran for phase A before the phase-A kernel
            i_syn, n_arr = kstdp.stdp_arrival_current(
                d["ring"], r, p["seg"], p["plastic"], d["last_post"],
                d["w"], d["last_arr"], t, **ltd_kw)
            i_tot = i_syn + kref.stim_current(d["stim_idx"], d["stim_amp"],
                                              N)
            a, b, c, dd = kref.izh_coefficients(p["exc"], izh)
            v, u, spiked = kizh.izhikevich_update(d["v"], d["u"], i_tot, a,
                                                  b, c, dd, **izh_kw)
            spiked = spiked & p["neuron_valid"]
            n_spk = spiked.sum(1)
            kstdp.stdp_ltp(spiked, p["row_ptr"], p["plastic"],
                           d["last_arr"], d["w"], d["last_post"], t,
                           **ltp_kw)
            return (spiked, n_arr, n_spk, v, u, d["w"], d["last_arr"],
                    d["last_post"], d["ring"])

        def stim_ops():
            return kref.stim_current(work["stim_idx"], work["stim_amp"], N)

        def no_ltp(d, p):
            return kstdp.stdp_phase_a(
                d["ring"], r, p["seg"], p["plastic"], p["exc"],
                p["neuron_valid"], d["stim_idx"], d["stim_amp"], d["v"],
                d["u"], d["last_post"], d["w"], d["last_arr"], t,
                **dict(pa_kw, with_ltp=False))

        def split(d, p):
            # the split schedule: phase A without LTP, then the LTP kernel
            spiked, n_arr, n_spk = no_ltp(d, p)
            kstdp.stdp_ltp(spiked, p["row_ptr"], p["plastic"],
                           d["last_arr"], d["w"], d["last_post"], t,
                           **ltp_kw)
            return (spiked, n_arr, n_spk, d["v"], d["u"], d["w"],
                    d["last_arr"], d["last_post"], d["ring"])

        def current(impl, d, p):
            if impl is kstdp:
                i_syn, n_arr = kstdp.stdp_arrival_current(
                    d["ring"], r, p["seg"], p["plastic"], d["last_post"],
                    d["w"], d["last_arr"], t, **ltd_kw)
            else:
                i_syn, n_arr = kref.stdp_arrival_current(
                    d["ring"], r, p["seg"], p["valid"], p["tgt"],
                    p["plastic"], d["last_post"], d["w"], d["last_arr"], t,
                    **ltd_kw)
            return i_syn, n_arr, d["w"], d["last_arr"], d["ring"]

        def pair(d, p):
            # the kernels the fused one replaced, on the same inputs
            contrib, n_arr = kstdp.stdp_arrival(
                d["ring"], r, p["valid"], p["tgt"], p["plastic"],
                d["last_post"], d["w"], d["last_arr"], t, **ltd_kw)
            i_syn = kseg.segment_sum_ordered(contrib, p["seg"])
            return i_syn, n_arr, d["w"], d["last_arr"], d["ring"]

        def arrival(impl, d, p):
            contrib, n_arr = impl.stdp_arrival(
                d["ring"], r, p["valid"], p["tgt"], p["plastic"],
                d["last_post"], d["w"], d["last_arr"], t, **ltd_kw)
            return contrib, n_arr, d["w"], d["last_arr"], d["ring"]

        def ltp(impl, d, p):
            impl.stdp_ltp(d["spiked"], p["row_ptr"], p["plastic"],
                          d["last_arr"], d["w"], d["last_post"], t, **ltp_kw)
            return d["w"], d["last_post"]

        for name, fn, state in (
                ("stdp_phase_a", phase_a,
                 ("ring", "w", "last_arr", "v", "u", "last_post")),
                ("stdp_arrival_current", current, ("ring", "w", "last_arr")),
                ("stdp_arrival", arrival, ("ring", "w", "last_arr")),
                ("stdp_ltp", ltp, ("w", "last_post"))):
            restore(*saved)
            got = [x.clone() for x in fn(kstdp, work, pg)]
            torch.cuda.synchronize()
            cpu = {k: v.clone() for k, v in st.items()}
            with kref.flush_denormal():
                want = fn(kref, cpu, pc)
            restore(*state)
            want_gpu = fn(kref, work, pg)
            equal = all(bit_equal(a, b) and bit_equal(a, c)
                        for a, b, c in zip(got, want, want_gpu))
            err = max(max(max_abs_err(a, b), max_abs_err(a, c))
                      for a, b, c in zip(got, want, want_gpu))
            again = lambda: restore(*state)
            extra, shape = {}, dict(counts)
            n_bytes, n_flops = traffic.get(name, (None, None))
            if name == "stdp_phase_a":
                n_bytes, n_flops, spiking = _phase_a_traffic(
                    pc, st, want[0], r, t, half_neg,
                    traffic["stdp_arrival_current"][0])
                shape.update(spiking, stim_entries=int(
                    st["stim_idx"].numel()))
                again()
                equal &= all(bit_equal(a, b) for a, b in
                             zip(got, sequence(work, pg)))
                extra = dict(
                    replaced="stdp_arrival_current (row_kernel<false>), "
                             "stim_current, the add, a, b, c, d from 8 "
                             "constants, izhikevich_update, & "
                             "neuron_valid, the spike sum, stdp_ltp",
                    replaced_ms=in_place_ms(lambda: sequence(work, pg),
                                            again),
                    replaced_device_ms=device_ms(lambda: sequence(work, pg),
                                                 restore=again),
                    replaced_device_ops=device_ops(lambda: sequence(work, pg),
                                                   again),
                    no_ltp_device_ms=device_ms(
                        lambda: no_ltp(work, pg), restore=again,
                        kernel=STDP_KERNEL_NAMES[name]),
                    split_device_ms=device_ms(
                        lambda: split(work, pg), restore=again,
                        kernel=(STDP_KERNEL_NAMES[name], "ltp_kernel")),
                    # the stimulus: the kernel's own test of the list
                    # (against an empty list), and the two ops that would
                    # sum it outside (zeros, then scatter_add_)
                    no_stimulus_device_ms=device_ms(
                        lambda: phase_a(kstdp, dict(
                            work, stim_idx=work["stim_idx"][:, :0],
                            stim_amp=work["stim_amp"][:, :0]), pg),
                        restore=again, kernel=STDP_KERNEL_NAMES[name]),
                    stim_current_ms=cuda_ms(stim_ops),
                    stim_current_device_ms=device_ms(stim_ops))
                again()
                equal &= all(bit_equal(a, b) for a, b in
                             zip(got, split(work, pg)))
                # t as the path reads it (the step counter, r = t mod D,
                # the stimulus a window) against t and r as launch
                # arguments, in turns: the same bits, and each form's
                # device time twice
                ctr = torch.tensor([int(t), 0], dtype=torch.int64,
                                   device="cuda")
                counter = lambda: kstdp.stdp_phase_a(
                    work["ring"], None, pg["seg"], pg["plastic"], pg["exc"],
                    pg["neuron_valid"], work["stim_idx"][None],
                    work["stim_amp"][None], work["v"], work["u"],
                    work["last_post"], work["w"], work["last_arr"], ctr,
                    **pa_kw)
                again()
                equal &= all(bit_equal(a, b) for a, b in zip(
                    got, (*counter(), work["v"], work["u"], work["w"],
                          work["last_arr"], work["last_post"],
                          work["ring"])))
                args = lambda: phase_a(kstdp, work, pg)
                forms = {"t_argument": [], "step_counter": []}
                for _ in range(2):
                    for form, call in (("t_argument", args),
                                       ("step_counter", counter)):
                        forms[form].append(device_ms(
                            call, restore=again,
                            kernel=STDP_KERNEL_NAMES[name]))
                extra.update({f"{k}_device_ms": v for k, v in forms.items()})
            if name == "stdp_arrival_current":
                again()
                equal &= all(bit_equal(a, b) for a, b in
                             zip(got, pair(work, pg)))
                extra = dict(
                    pair="stdp_arrival (arrival_kernel) then "
                         "segment_sum_ordered (segment_sum_kernel)",
                    pair_ms=in_place_ms(lambda: pair(work, pg), again),
                    pair_device_ms=device_ms(
                        lambda: pair(work, pg), restore=again,
                        kernel=("arrival_kernel", "segment_sum_kernel")))
            if not equal:
                failed.append(f"{name} ({label})")
            bms, by = bound(n_bytes, n_flops)
            launch = lambda: fn(kstdp, work, pg)
            rows.append(dict(
                name=name, route="cuda", source="src/repro_torch/csrc/stdp.cu",
                replaces=STDP_REPLACES[name], launches=None,
                max_abs_err=err, ms=in_place_ms(launch, again),
                device_ms=device_ms(launch, restore=again,
                                    kernel=STDP_KERNEL_NAMES[name]),
                plain_ms=in_place_ms(lambda: fn(kref, work, pg), again,
                                     calls=3, warmup=1),
                bound_ms=bms, bound_by=by, library_ms=None, equal=equal,
                tolerance="bit-equal (every output and updated state "
                          "tensor, 0 ulp), to the plain version on a CPU "
                          "copy and on the card",
                density=label, bytes=n_bytes, flops=n_flops,
                shape={"H": H, "E": E, "D": D, "N": N, **shape}, **extra))
        del saved, work
    return rows, failed


def device_ops(fn, restore, calls: int = 10) -> float:
    """Device operations (kernels and copies, torch.profiler) per call of
    fn, the device-to-device copies of `restore()` left out."""
    from torch.profiler import ProfilerActivity, profile
    restore()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            restore()
            fn()
        torch.cuda.synchronize()
    return sum(c for k, _, c in device_kernel_events(prof)
               if "Memcpy DtoD" not in k) / calls


def _replaced_phase_b(ring, spiked_src, syn_src, syn_delay, syn_valid, t):
    """The port's phase B before the arborize kernel, on the same inputs:
    gather by syn_src, `torch.nonzero` (which waits for the device to size
    its output), the slots, an index put."""
    D = ring.shape[1]
    active = torch.gather(spiked_src, 1, syn_src) & syn_valid
    h, e = torch.nonzero(active, as_tuple=True)
    slot = torch.remainder(syn_delay[h, e] + t, D).to(torch.int64)
    ring[h, slot, e] = True
    return ring


def _arborize_rows(plan8, spec8):
    """Phase B's kernel (`arborize`, source-major over the plan's forward
    CSR, element-major where a sample shows 18% or more of the sources
    spiking: `walk`) on plan8's own tables, with the sources spiking at
    the main path's share (2.15%) and at 5x, 10x and 20x it, at a t whose
    slots wrap:
    bit-equal to its plain version (the reference's broadcast-compare) on
    a CPU copy and on the card, to the element-major kernel it replaced
    (`arborize_elements`) and to the sequence before that; an all-False
    spike mask at t = -1 (the pipelined schedule's prologue) sets nothing.
    Timed beside its bound, the element-major kernel and the replaced
    sequence, on the same inputs.  Setting flags that are set changes
    nothing, so the calls need no restore between them."""
    H, E = plan8.syn_valid.shape
    S = plan8.src_gid.shape[1]
    D = spec8.cfg.n_delay_slots
    t = 1003                           # t mod D = 5: most slots wrap
    tables = (plan8.syn_src, plan8.syn_delay, plan8.syn_valid)
    csr = (plan8.fwd_ptr, plan8.fwd_ids, plan8.fwd_delay)
    tables_cpu = tuple(x.cpu() for x in tables)
    n_valid = int(plan8.syn_valid.sum())
    rng = np.random.default_rng(2019)
    ring0 = torch.from_numpy(rng.random((H, D, E), dtype=np.float32)
                             < STDP_DENSITY) & tables_cpu[2][:, None]
    rows, failed = [], []
    for label, density in (("main", STDP_DENSITY), ("5x", 5 * STDP_DENSITY),
                           ("10x", 10 * STDP_DENSITY),
                           ("20x", 20 * STDP_DENSITY)):
        spiked_cpu = torch.from_numpy(rng.random((H, S)) < density)
        spiked = spiked_cpu.cuda()
        ring = ring0.cuda()
        got = karb.arborize(ring, spiked, *tables, *csr, t).clone()
        torch.cuda.synchronize()
        want = kref.arborize(ring0.clone(), spiked_cpu, *tables_cpu, t)
        want_gpu = kref.arborize(ring0.cuda(), spiked, *tables, t)
        elements = karb.arborize_elements(ring0.cuda(), spiked, *tables, t)
        replaced = _replaced_phase_b(ring0.cuda(), spiked, *tables, t)
        silent = karb.arborize(ring0.cuda(), torch.zeros_like(spiked),
                               *tables, *csr, -1)
        equal = (bit_equal(got, want) and bit_equal(got, want_gpu)
                 and bit_equal(got, elements) and bit_equal(got, replaced)
                 and bit_equal(silent, ring0))
        if not equal:
            failed.append(f"arborize ({label})")
        err = max(max_abs_err(got, want), max_abs_err(got, want_gpu))
        del want, want_gpu, elements, replaced, silent
        n_active = int((torch.gather(spiked, 1, plan8.syn_src)
                        & plan8.syn_valid).sum())
        n_spiking = int(spiked_cpu.sum())
        # what the work needs: the spike flags once, the two row pointers
        # of each spiking source, and per synapse it sets its id and delay
        # in (int32 each) and its flag out
        n_bytes = H * S + n_spiking * 8 + n_active * (4 + 4 + 1)
        bms, by = bound(n_bytes, 0)
        # the same with each flag's store counted as the 32-B sector it
        # lands in; and the element-major design's bound (every valid flag
        # and int64 source, the spike flags, the active delays and flags)
        sector_bytes = H * S + n_spiking * 8 + n_active * (4 + 4 + 32)
        element_bytes = H * E + n_valid * 8 + H * S + n_active * (4 + 1)
        launch = lambda: karb.arborize(ring, spiked, *tables, *csr, t)
        old = lambda: karb.arborize_elements(ring, spiked, *tables, t)
        seq = lambda: _replaced_phase_b(ring, spiked, *tables, t)
        rows.append(dict(
            name="arborize", route="cuda",
            source="src/repro_torch/csrc/arborize.cu",
            replaces="src/repro/core/engine.py:315", launches=None,
            max_abs_err=err, ms=cuda_ms(launch),
            device_ms=device_ms(launch, kernel="arborize_rows"),
            plain_ms=cuda_ms(lambda: kref.arborize(ring, spiked, *tables, t),
                             calls=3),
            bound_ms=bms, bound_by=by,
            bound_note="the bytes the work needs: spike flags, two row "
                       "pointers a spiking source, 4 + 4 B in and a 1-B "
                       "flag out a synapse set",
            sector_bound_ms=bound(sector_bytes, 0)[0],
            element_major_bound_ms=bound(element_bytes, 0)[0],
            element_major_ms=cuda_ms(old),
            element_major_device_ms=device_ms(old,
                                              kernel="arborize_elements"),
            device_ms_again=device_ms(launch, kernel="arborize_rows"),
            library_ms=None,
            library_note="no single PyTorch call does phase B; the "
                         "sequence the element-major kernel replaced is in "
                         "replaced_*",
            replaced="gather by syn_src, & syn_valid, torch.nonzero (a host "
                     "synchronisation), the slots, an index put",
            replaced_ms=cuda_ms(seq, calls=5),
            replaced_device_ms=device_ms(seq),
            replaced_device_ops=device_ops(seq, lambda: None),
            equal=equal,
            tolerance="bit-equal (every flag of the ring), to the plain "
                      "version on a CPU copy and on the card, to the "
                      "element-major kernel and to the sequence before it; "
                      "an all-False mask at t = -1 sets nothing",
            walk=("element-major" if karb.walks_elements(spiked_cpu)[0]
                  else "source-major"),
            density=label, bytes=n_bytes, sector_bytes=sector_bytes,
            element_major_bytes=element_bytes, flops=0,
            shape={"H": H, "E": E, "D": D, "S": S, "t": t,
                   "valid": n_valid, "active": n_active,
                   "spiking_sources": n_spiking}))
        del ring, spiked
    return rows, failed


def _event_state(rng, plan_cpu, t: int, density: float, cap: int, D: int):
    """numpy-seeded event state on a plan's arrays (CPU tensors): ring slot
    t mod D listing `density` of each shard's valid synapses in random
    order (the other slots a third of that, as lists phase B left), each
    synapse at most once a slot; weights in [0, 10]; last spike and
    arrival times within 200 steps or never; sat 0."""
    valid = plan_cpu["valid"]
    H, E = valid.shape
    N = plan_cpu["row_ptr"].shape[1] - 1
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def times(shape):
        return f(np.where(rng.random(shape) < 0.7,
                          rng.uniform(t - 200.0, t, shape), engine.NEG_TIME))
    ring = np.full((H, D, cap), -1, np.int32)
    count = np.zeros((H, D), np.int32)
    for h in range(H):
        nv = int(valid[h].sum())
        for d in range(D):
            k = min(cap, int((density if d == t % D else density / 3) * nv))
            ring[h, d, :k] = rng.choice(nv, k, replace=False)
            count[h, d] = k
    return dict(ev_ring=torch.from_numpy(ring),
                ev_count=torch.from_numpy(count), w=f(rng.uniform(
                    0.0, 10.0, (H, E))), last_post=times((H, N)),
                last_arr=times((H, E)),
                sat=torch.zeros(H, dtype=torch.int32))


def _event_traffic(pc: dict, st: dict, r: int, lookup):
    """({name: (bytes, flops)}, counts, operands) of the event ops on these
    inputs (CPU tensors; ring slot r): what each must move and compute,
    each input byte read once and each output byte written once, counting
    only what the data makes it touch (`csrc/event.cu`'s note); the
    neuron pass's comes from its plain output.  `lookup` is
    `phase_build`'s: where the arrivals read syn_tgt, 8 B an event more."""
    H, E = pc["valid"].shape
    N = pc["row_ptr"].shape[1] - 1
    S, D = pc["fwd"].shape[1], st["ev_ring"].shape[1]
    half_neg = engine.NEG_TIME / 2
    n = lambda m: int(m.sum())
    ev = st["ev_ring"][:, r]
    listed = ev >= 0
    eve = torch.clamp(ev, min=0).to(torch.int64)
    tgt_ev = torch.gather(pc["tgt"], 1, eve)
    plast_ev = torch.gather(pc["plastic"], 1, eve) & listed
    ltd = plast_ev & (torch.gather(st["last_post"], 1, tgt_ev)
                      > half_neg)
    n_ev = n(listed)
    # per event: its list entry in and cleared, its target (syn_tgt's
    # 8 B where the kernel reads it), plastic, w in, last_arr out; per
    # LTD w out; per neuron last_post in, row pointers in and i_syn
    # out; the counts
    tgt_bytes = 8 if lookup[0] == 0 else 0
    a_bytes = (n_ev * (4 + 4 + tgt_bytes + 1 + 4 + 4) + n(ltd) * 4
               + H * N * (4 + 4) + H * (N + 1) * 4 + H * D * 4 + H * 8)
    post_ids = st["post_ids"]
    listed_n = torch.zeros((H, N + 1), dtype=torch.bool).scatter_(
        1, post_ids.to(torch.int64), True)[:, :N]
    row = kref.rows_of_synapses(pc["row_ptr"], E)
    post = torch.cat([listed_n, listed_n.new_zeros(H, 1)],
                     1).gather(1, row)
    post_pl = post & pc["plastic"]
    ltp_n = post_pl & (st["last_arr"] > half_neg)
    # per listed neuron its list entry and its row's two pointers;
    # per synapse of a listed one plastic, per plastic one last_arr,
    # per LTP w in / out; the counts
    l_bytes = (n(listed_n) * (4 + 4 + 4) + n(post) + n(post_pl) * 4
               + n(ltp_n) * 8 + H * 8)
    src_ids = st["src_ids"]
    ok = src_ids < S
    fwd = torch.gather(pc["fwd"], 1, torch.clamp(
        src_ids, max=S - 1).to(torch.int64)[:, :, None].expand(
        -1, -1, pc["fwd"].shape[2]))
    emitted = n((fwd >= 0) & ok[:, :, None])
    # the list; per emitted event its row entry and delay in and its
    # id out; the counts and sat
    e_bytes = src_ids.numel() * 4 + emitted * (4 + 4 + 4) + H * D * 8
    traffic = {"event_arrival": (a_bytes, n_ev + n(ltd) * 25),
               "event_neurons": None,       # from the plain output
               "event_ltp": (l_bytes, n(ltp_n) * 25),
               "event_emit": (e_bytes, 0)}
    counts = dict(events=n_ev, ltd=n(ltd), spiking=n(st["spiked"]),
                  listed_neurons=n(listed_n), ltp=n(ltp_n),
                  spiking_sources=n(st["spiked_src"]), listed_sources=n(ok),
                  emitted=emitted)
    return traffic, counts, dict(eve=eve, listed=listed, tgt_ev=tgt_ev,
                                 fwd=fwd, ok=ok)


def _event_rows(sp8e, lookup):
    """The event ops on the 8x8 event plan's own tables (the plan's
    targets, delays and CSR rows, the EventPlan's forward rows) with the
    ring, spikes and sources drawn at the main path's density (2.15%) and
    at 10x it: each bit-equal to its plain version on a CPU copy and on
    the card in every output and updated state tensor, timed alone on
    restored inputs beside its bound, its plain version and, for the
    arrivals' sum, `index_add_` (atomics, not ordered).  The spike lists
    are compacted with the timed run's capacities (`sp8e.caps`, c_post =
    N and c_src = S, `event_engine.no_drop_caps`), so the main rows run
    at the main path's sizes; a third row at 10x compacts with the
    default caps (c_post N / 2, c_src S / 8), which the sources overflow,
    so that `sat` counts the dropped spikes.  `lookup` is `phase_build`'s
    (kept, other, library): the arrivals built with the other target
    lookup are held to the same bits and timed in the first two rows."""
    spec, plan, eplan = sp8e.spec, sp8e.plan, sp8e.eplan
    stdp = spec.stdp
    H, E = plan.syn_valid.shape
    N, S = plan.gid.shape[1], plan.src_gid.shape[1]
    D = spec.cfg.n_delay_slots
    cap = sp8e.cap_ev
    caps = (sp8e.caps["c_post"], sp8e.caps["c_src"])
    t = 1003
    r = t % D
    ltd_kw = dict(a_minus=stdp.a_minus, tau_minus=stdp.tau_minus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    ltp_kw = dict(a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    pg = dict(valid=plan.syn_valid, tgt=plan.syn_tgt,
              plastic=plan.syn_plastic, row_ptr=plan.row_ptr,
              delay=plan.syn_delay, fwd=eplan.fwd_rows)
    pc = {k: v.cpu() for k, v in pg.items()}
    rng = np.random.default_rng(2021)
    half_neg = engine.NEG_TIME / 2
    rows, failed = [], []
    izh = spec.izh
    coeffs = kref.izh_coefficients(plan.exc_mask, izh)
    window = engine.StimWindow(spec, plan, t, 1)        # [1, H, C*K]
    ctr = torch.tensor([t, 0], dtype=torch.int64, device="cuda")
    pg.update(exc=plan.exc_mask, neuron_valid=plan.neuron_valid)
    pc.update(exc=pg["exc"].cpu(), neuron_valid=pg["neuron_valid"].cpu())
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    for label, density, (c_post, c_src) in (
            ("main", STDP_DENSITY, caps),
            ("10x", 10 * STDP_DENSITY, caps),
            ("10x_small_caps", 10 * STDP_DENSITY,
             (SMALL_C_POST, event_engine.default_caps(spec)[1]))):
        st = _event_state(rng, pc, t, density, cap, D)
        st["spiked"] = torch.from_numpy(rng.random((H, N)) < density)
        st["spiked_src"] = torch.from_numpy(rng.random((H, S)) < density)
        # the LTP's list, as event_compact lists the spikes
        st["post_count"], st["post_ids"] = kref.event_compact(
            st["spiked"], st["last_post"].clone(), st["sat"].clone(), t,
            c_post=c_post)
        ids, drop = aer.compact_indices(st["spiked"], c_post, fill=N)
        st["rows_ids"], st["rows_drop"] = ids.contiguous(), drop
        ids, drop = aer.compact_indices(st["spiked_src"], c_src, fill=S)
        st["src_ids"], st["src_drop"] = ids.contiguous(), drop
        # the neuron pass's: about `density` of the neurons at or past the
        # threshold, the others at rest, the arrivals' current, the step's
        # stimulus
        st["i_syn"] = f(rng.uniform(-5.0, 20.0, (H, N)))
        st["v"] = f(np.where(rng.random((H, N)) < density,
                             rng.uniform(30.0, 40.0, (H, N)),
                             rng.uniform(-80.0, -60.0, (H, N))))
        st["u"] = f(rng.uniform(-20.0, 10.0, (H, N)))
        st["stim_idx"], st["stim_amp"] = (window.index.cpu(),
                                          window.amp.cpu())
        saved = {k: v.cuda() for k, v in st.items()}
        work = {k: v.clone() for k, v in saved.items()}

        def restore(*names):
            for k in names:
                work[k].copy_(saved[k])

        def arrival(impl, d, p):
            if impl is kref:
                i_syn, n = kref.event_arrival(
                    d["ev_ring"], d["ev_count"], r, p["tgt"], p["plastic"],
                    d["last_post"], d["w"], d["last_arr"], t, **ltd_kw)
            else:
                i_syn, n = kev.event_arrival(
                    d["ev_ring"], d["ev_count"], p["tgt"], p["row_ptr"],
                    p["plastic"], d["last_post"], d["w"], d["last_arr"], t,
                    **ltd_kw)
            return (i_syn, n, d["w"], d["last_arr"], d["ev_ring"],
                    d["ev_count"])

        def neurons(impl, d, p):
            # the kernel as the path calls it: t and the stimulus row from
            # the step counter, the stimulus a window
            step, k = (ctr, slice(None)) if impl is kev else (t, 0)
            out = impl.event_neurons(
                d["i_syn"], d["stim_idx"][k], d["stim_amp"][k], p["exc"],
                p["neuron_valid"], d["v"], d["u"], d["last_post"], d["sat"],
                step, izh=izh, c_post=c_post)
            return (*out, d["v"], d["u"], d["last_post"], d["sat"])

        def ltp(impl, d, p):
            impl.event_ltp(d["post_ids"], d["post_count"], p["row_ptr"],
                           p["plastic"], d["last_arr"], d["w"], t, **ltp_kw)
            return (d["w"],)

        def emit(impl, d, p):
            impl.event_emit(d["src_ids"], d["src_drop"], p["fwd"],
                            p["delay"], d["ev_ring"], d["ev_count"],
                            d["sat"], t)
            return d["ev_ring"], d["ev_count"], d["sat"]

        n = lambda m: int(m.sum())
        traffic, counts, aux = _event_traffic(pc, st, r, lookup)
        shape = dict(H=H, E=E, N=N, S=S, D=D, cap_ev=cap, t=t,
                     c_post=c_post, c_src=c_src, **counts)
        eve, listed, tgt_ev = aux["eve"], aux["listed"], aux["tgt_ev"]
        fwd, ok = aux["fwd"], aux["ok"]
        # index_add_'s operands: each event's flat target and weight
        lib_tgt = (tgt_ev + torch.arange(H)[:, None] * N)[listed].cuda()
        lib_w = torch.gather(st["w"], 1, eve)[listed].cuda()
        library = lambda: torch.zeros(H * N, device="cuda").index_add_(
            0, lib_tgt, lib_w)
        for name, fn, state in (
                ("event_arrival", arrival,
                 ("ev_ring", "ev_count", "w", "last_arr")),
                ("event_neurons", neurons, ("v", "u", "last_post", "sat")),
                ("event_ltp", ltp, ("w",)),
                ("event_emit", emit, ("ev_ring", "ev_count", "sat"))):
            restore(*saved)
            got = [x.clone() for x in fn(kev, work, pg)]
            torch.cuda.synchronize()
            cpu = {k: v.clone() for k, v in st.items()}
            with kref.flush_denormal():
                want = fn(kref, cpu, pc)
            restore(*state)
            want_gpu = fn(kref, work, pg)
            equal = all(bit_equal(a, b) and bit_equal(a, c)
                        for a, b, c in zip(got, want, want_gpu))
            err = max(max(max_abs_err(a, b), max_abs_err(a, c))
                      for a, b, c in zip(got, want, want_gpu))
            if not equal:
                failed.append(f"{name} ({label})")
            again = lambda: restore(*state)
            if name == "event_neurons":
                # per neuron v and u in and out, i_syn, its two flags, the
                # spike; per spiking one last_post; the list (the fill
                # too), the stimulus list, the counts and sat
                spiking = n(want[0])
                traffic[name] = (
                    H * N * (16 + 4 + 2 + 1) + spiking * 4
                    + H * c_post * 4
                    + nbytes(window.index[0], window.amp[0]) + H * 12,
                    H * N * 20)
                shape = dict(shape, neuron_spikes=spiking,
                             neuron_listed=n(want[2] < N),
                             neuron_sat=want[-1].tolist(),
                             stim_entries=int(window.index[0].numel()))
            n_bytes, n_flops = traffic[name]
            bms, by = bound(n_bytes, n_flops)
            launch = lambda: fn(kev, work, pg)
            rows.append(dict(
                name=name, route="cuda", source=EVENT_SOURCES[name],
                replaces=EVENT_REPLACES[name], launches=None,
                max_abs_err=err, ms=in_place_ms(launch, again),
                device_ms=device_ms(launch, restore=again,
                                    kernel=EVENT_KERNEL_NAMES[name]),
                device_ops=device_ops(launch, again),
                plain_ms=in_place_ms(lambda: fn(kref, work, pg), again,
                                     calls=3, warmup=1),
                bound_ms=bms, bound_by=by,
                library_ms=(cuda_ms(library) if name == "event_arrival"
                            else None),
                library_note=("index_add_ of the events' weights by target "
                              "(atomics, not in list order)"
                              if name == "event_arrival" else
                              "no single PyTorch call does this"),
                equal=equal,
                tolerance="bit-equal (every output and updated state "
                          "tensor, 0 ulp), to the plain version on a CPU "
                          "copy and on the card",
                density=label, bytes=n_bytes, flops=n_flops, shape=shape))
            if name == "event_arrival":
                # the op's accesses at its events' random synapses alone
                # (w and plastic gathered, last_arr written), as PyTorch
                # indexing calls on the same restored inputs
                syn = (eve + torch.arange(H)[:, None] * E)[listed].cuda()

                def touch():
                    work["w"].view(-1).index_select(0, syn)
                    pg["plastic"].view(-1).index_select(0, syn)
                    work["last_arr"].view(-1).index_fill_(0, syn, float(t))
                rows[-1].update(
                    target_lookup=ARRIVAL_TARGETS[lookup[0]],
                    place_device_ms=device_ms(
                        launch, restore=again, kernel="arrival_place"),
                    synapse_access_device_ms=device_ms(touch, restore=again))
            if name == "event_arrival" and label != "10x_small_caps":
                # the op built with the other target lookup: the same bits,
                # timed on the same restored inputs
                def alt():
                    with _kernel_library(lookup[2]):
                        return launch()
                restore(*state)
                alt_equal = all(bit_equal(a, b) for a, b in zip(alt(), got))
                if not alt_equal:
                    failed.append(f"{name} target from "
                                  f"{ARRIVAL_TARGETS[lookup[1]]} ({label})")
                rows[-1].update(
                    other_lookup=ARRIVAL_TARGETS[lookup[1]],
                    other_lookup_equal=alt_equal,
                    other_lookup_device_ms=device_ms(
                        alt, restore=again, kernel=EVENT_KERNEL_NAMES[name]),
                    other_lookup_place_device_ms=device_ms(
                        alt, restore=again, kernel="arrival_place"))
            if name == "event_neurons":
                def sequence():
                    # what the event path ran from i_syn to the list before
                    # the neuron pass (`event_engine.phase_a`)
                    row = ctr[1:]
                    i_ext = kref.stim_current(
                        work["stim_idx"].index_select(0, row)[0],
                        work["stim_amp"].index_select(0, row)[0], N)
                    v, u, spiked = kizh.izhikevich_update(
                        work["v"], work["u"], work["i_syn"] + i_ext, *coeffs,
                        v_peak=izh.v_peak, dt=izh.dt,
                        substeps=izh.v_substeps)
                    work["v"].copy_(v)
                    work["u"].copy_(u)
                    spiked = spiked & pg["neuron_valid"]
                    count = spiked.sum(1)
                    ids, drop = aer.compact_indices(spiked, c_post, fill=N)
                    return spiked, count, ids.contiguous(), drop

                def tail():
                    # from i_syn to the end of LTP: the neuron pass, LTP
                    out = neurons(kev, work, pg)
                    kev.event_ltp(out[2], out[1], pg["row_ptr"],
                                  pg["plastic"], work["last_arr"], work["w"],
                                  ctr, **ltp_kw)
                    return (out[0], work["v"], work["u"], work["w"],
                            work["last_post"], work["sat"])

                def replaced_tail():
                    spiked, count, ids, drop = sequence()
                    kev.event_ltp_rows(ids, drop, spiked, pg["row_ptr"],
                                       pg["plastic"], work["last_arr"],
                                       work["w"], work["last_post"],
                                       work["sat"], ctr, **ltp_kw)
                    return (spiked, work["v"], work["u"], work["w"],
                            work["last_post"], work["sat"])
                again()
                seq = sequence()
                seq_equal = all(bit_equal(a, b) for a, b in zip(
                    seq[:3] + (work["v"], work["u"]),
                    tuple(got[:3]) + (got[3], got[4])))
                tail_state = state + ("w",)
                again_tail = lambda: restore(*tail_state)
                again_tail()
                a = [x.clone() for x in tail()]
                again_tail()
                tail_equal = all(bit_equal(x, y)
                                 for x, y in zip(a, replaced_tail()))
                if not (seq_equal and tail_equal):
                    failed.append(f"{name} against what it replaced "
                                  f"({label})")
                rows[-1].update(
                    replaced="index_select x2 (the window's row), "
                             "stim_current (zeros, scatter_add_), the add, "
                             "izhikevich_update, copy_ x2, & neuron_valid, "
                             "the spike sum, compact_indices, contiguous",
                    replaced_equal=seq_equal,
                    replaced_ms=in_place_ms(sequence, again),
                    replaced_device_ms=device_ms(sequence, restore=again),
                    replaced_device_ops=device_ops(sequence, again),
                    tail="event_neurons then event_ltp: phase A from i_syn "
                         "to the end of LTP",
                    replaced_tail="the replaced sequence then "
                                  "event_ltp_rows (last_post, sat, LTP)",
                    tail_equal=tail_equal,
                    tail_ms=in_place_ms(tail, again_tail),
                    tail_device_ms=device_ms(tail, restore=again_tail),
                    tail_device_ops=device_ops(tail, again_tail),
                    replaced_tail_ms=in_place_ms(replaced_tail, again_tail),
                    replaced_tail_device_ms=device_ms(replaced_tail,
                                                      restore=again_tail),
                    replaced_tail_device_ops=device_ops(replaced_tail,
                                                        again_tail))
            if name == "event_ltp":
                # what does the LTP's work now (event_compact, then
                # event_ltp) against its plain versions on a CPU copy and
                # on the card, and the kernel it replaced (a warp a listed
                # row; it also set last_post and sat), on the same inputs
                rows_state = ("w", "last_post", "sat")
                again_rows = lambda: restore(*rows_state)

                def compact_ltp_with(impl, d, p):
                    count, ids = impl.event_compact(
                        d["spiked"], d["last_post"], d["sat"], t,
                        c_post=c_post)
                    impl.event_ltp(ids, count, p["row_ptr"], p["plastic"],
                                   d["last_arr"], d["w"], t, **ltp_kw)
                    return count, ids, d["w"], d["last_post"], d["sat"]

                def rows_kernel():
                    kev.event_ltp_rows(work["rows_ids"], work["rows_drop"],
                                       work["spiked"], pg["row_ptr"],
                                       pg["plastic"], work["last_arr"],
                                       work["w"], work["last_post"],
                                       work["sat"], t, **ltp_kw)
                    return work["w"], work["last_post"], work["sat"]

                compact_ltp = lambda: compact_ltp_with(kev, work, pg)
                again_rows()
                a = [x.clone() for x in rows_kernel()]
                again_rows()
                b = [x.clone() for x in compact_ltp()]
                cpu = {k: v.clone() for k, v in st.items()}
                with kref.flush_denormal():
                    want_cl = compact_ltp_with(kref, cpu, pc)
                again_rows()
                want_cl_gpu = compact_ltp_with(kref, work, pg)
                compact_equal = all(
                    bit_equal(x, y) and bit_equal(x, z)
                    for x, y, z in zip(b, want_cl, want_cl_gpu))
                if not compact_equal:
                    failed.append(f"{name} event_compact then event_ltp "
                                  f"against the plain versions ({label})")
                rows_equal = (all(bit_equal(x, y) for x, y in zip(a, b[2:]))
                              and bit_equal(b[2], got[0]))
                if not rows_equal:
                    failed.append(f"{name} against event_ltp_rows ({label})")
                rows[-1].update(
                    compact_and_ltp_equal=compact_equal,
                    compact_and_ltp_max_abs_err=max(
                        max(max_abs_err(x, y), max_abs_err(x, z))
                        for x, y, z in zip(b, want_cl, want_cl_gpu)),
                    rows_kernel="event_ltp_rows (csrc/stdp.cu::"
                                "event_ltp_kernel: a warp a "
                                "listed row; last_post and sat)",
                    rows_kernel_equal=rows_equal,
                    rows_kernel_device_ms=device_ms(
                        rows_kernel, restore=again_rows,
                        kernel=EVENT_KERNEL_NAMES["event_ltp_rows"]),
                    compact_and_ltp_device_ms=device_ms(
                        compact_ltp, restore=again_rows,
                        kernel=("neuron_scan", "ltp_synapses")),
                    compact_device_ms=device_ms(
                        compact_ltp, restore=again_rows,
                        kernel="neuron_scan"))
            if name == "event_emit":
                # its loads at random synapses alone: each emitted event's
                # delay, as one PyTorch indexing call on restored inputs
                hh = torch.arange(H)[:, None, None].expand_as(fwd)
                dsyn = (fwd.to(torch.int64) + hh * E)[
                    (fwd >= 0) & ok[:, :, None]].cuda()
                rows[-1]["delay_access_device_ms"] = device_ms(
                    lambda: pg["delay"].view(-1).index_select(0, dsyn),
                    restore=again)
        del saved, work
    return rows, failed


def _t_base_rows(sp, lookup):
    """The per-shard step forms (`t_base`) of the six ops of the two
    paths at a folded shape the service launches: T_BASE_SLOTS slots of
    `sp`'s plan (H = 1; its event plan and capacities for the event ops)
    folded onto [T_BASE_SLOTS, ...], as simserve_timed's 8-tenant group,
    shard h at step t + h, so that the shards' ring slots and time
    differences all differ.  Each shard's inputs are drawn at its own step
    at the main path's density (2.15%).  Each op runs once on the whole
    fold (t from a zero step counter, t_base the shards' steps) and must
    be bit-equal, in every output and updated state tensor, to its plain
    version with the same per-shard steps on a CPU copy and on the card,
    and each shard's rows to that shard's solo launch at its own step, on
    a copy of its inputs.  Timed beside those T_BASE_SLOTS solo launches
    (in turns, on the same restored inputs), its plain version, its bound
    (the solo rows' models summed over the shards, and t_base read once)
    and, for the arrivals, `index_add_`.  (`lookup`: `phase_build`'s.)"""
    dev = sp.plan.gid.device
    B = T_BASE_SLOTS
    spec = sp.spec
    stdp, izh = spec.stdp, spec.izh
    fold = lambda x: x.repeat((B,) + (1,) * (x.dim() - 1)).contiguous()
    plan = engine.map_state(fold, sp.plan)
    eplan = engine.map_state(fold, sp.eplan)
    H, E = plan.syn_valid.shape                     # one shard a slot
    N, S = plan.gid.shape[1], plan.src_gid.shape[1]
    D = spec.cfg.n_delay_slots
    c_post, c_src = sp.caps["c_post"], sp.caps["c_src"]
    ts = [1003 + h for h in range(B)]
    tb = torch.tensor(ts, dtype=torch.int64, device=dev)
    ctr0 = torch.zeros(2, dtype=torch.int64, device=dev)
    # each shard's step counter, as its solo event neuron pass reads it
    ctrs = {t: torch.tensor([t, 0], dtype=torch.int64, device=dev)
            for t in ts}
    half_neg = engine.NEG_TIME / 2
    ltd_kw = dict(a_minus=stdp.a_minus, tau_minus=stdp.tau_minus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    ltp_kw = dict(a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    pa_kw = dict(izh=izh, stdp=stdp, neg_time=engine.NEG_TIME,
                 with_ltp=True)
    pg = dict(valid=plan.syn_valid, tgt=plan.syn_tgt,
              plastic=plan.syn_plastic, row_ptr=plan.row_ptr,
              exc=plan.exc_mask, neuron_valid=plan.neuron_valid,
              src=plan.syn_src, delay=plan.syn_delay, fwd_ptr=plan.fwd_ptr,
              fwd_ids=plan.fwd_ids, fwd_delay=plan.fwd_delay,
              fwd=eplan.fwd_rows)
    pc = {k: v.cpu() for k, v in pg.items()}
    # each shard's plan alone (its solo launch's), on the host and device
    rows_of = lambda d, h: {k: v[h:h + 1] for k, v in d.items()
                            if k != "seg"}
    pc_h = [rows_of(pc, h) for h in range(B)]
    pg_h = [{k: v.clone() for k, v in rows_of(pg, h).items()}
            for h in range(B)]
    for p in [pg, pc] + pg_h:
        p["seg"] = kref.make_segments(p["row_ptr"], E)

    rng = np.random.default_rng(2027)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def dense_inputs(h):
        t, p = ts[h], pc_h[h]
        st = _stdp_state(rng, p, D, t % D, float(t), STDP_DENSITY)
        idx, amp = engine.stim_rows(spec, sp.plan, t, 1)
        st = _phase_a_inputs(rng, p, st, (idx[0], amp[0]), STDP_DENSITY)
        st["spiked_src"] = torch.from_numpy(rng.random((1, S))
                                            < STDP_DENSITY)
        return st

    def event_inputs(h):
        t, p = ts[h], pc_h[h]
        st = _event_state(rng, p, t, STDP_DENSITY, sp.cap_ev, D)
        st["spiked"] = torch.from_numpy(rng.random((1, N)) < STDP_DENSITY)
        st["spiked_src"] = torch.from_numpy(rng.random((1, S))
                                            < STDP_DENSITY)
        st["post_count"], st["post_ids"] = kref.event_compact(
            st["spiked"], st["last_post"].clone(), st["sat"].clone(), t,
            c_post=c_post)
        ids, drop = aer.compact_indices(st["spiked_src"], c_src, fill=S)
        st["src_ids"], st["src_drop"] = ids.contiguous(), drop
        st["i_syn"] = f(rng.uniform(-5.0, 20.0, (1, N)))
        st["v"] = f(np.where(rng.random((1, N)) < STDP_DENSITY,
                             rng.uniform(30.0, 40.0, (1, N)),
                             rng.uniform(-80.0, -60.0, (1, N))))
        st["u"] = f(rng.uniform(-20.0, 10.0, (1, N)))
        idx, amp = engine.stim_rows(spec, sp.plan, t, 1)
        st["stim_idx"], st["stim_amp"] = idx[0].cpu(), amp[0].cpu()
        return st

    def per_shard(draw):
        parts = [draw(h) for h in range(B)]
        return parts, {k: torch.cat([q[k] for q in parts])
                       for k in parts[0]}

    def steps(impl, d, t):
        """(t argument, keywords): an int t is a solo launch at t; None
        the fold (the kernel's zero step counter and t_base, the plain
        version's per-shard steps)."""
        if t is not None:
            return t, {}
        if impl is kref:
            return torch.tensor(ts, dtype=torch.int64,
                                device=d["w"].device), {}
        return ctr0, {"t_base": tb}

    def window(impl, t, x):
        # the kernels read the stimulus from a window when t is a counter
        return x[None] if impl is not kref and (t is None or impl is kev) \
            else x

    def phase_a(impl, d, p, t=None):
        step, kw = steps(impl, d, t)
        r = None if impl is kstdp and t is None else (t or 0) % D
        out = impl.stdp_phase_a(
            d["ring"], r, p["seg"], *(
                (p["valid"], p["tgt"]) if impl is kref else ()),
            p["plastic"], p["exc"], p["neuron_valid"],
            window(impl, t, d["stim_idx"]), window(impl, t, d["stim_amp"]),
            d["v"], d["u"], d["last_post"], d["w"], d["last_arr"], step,
            **pa_kw, **kw)
        return (*out, d["v"], d["u"], d["w"], d["last_arr"],
                d["last_post"], d["ring"])

    def arborize(impl, d, p, t=None):
        step, kw = steps(impl, d, t)
        csr = ((p["fwd_ptr"], p["fwd_ids"], p["fwd_delay"])
               if impl is karb else ())
        return (impl.arborize(d["ring"], d["spiked_src"], p["src"],
                              p["delay"], p["valid"], *csr, step, **kw),)

    def arrival(impl, d, p, t=None):
        step, kw = steps(impl, d, t)
        if impl is kref:
            out = kref.event_arrival(
                d["ev_ring"], d["ev_count"], (t or 0) % D, p["tgt"],
                p["plastic"], d["last_post"], d["w"], d["last_arr"], step,
                **ltd_kw)
        else:
            out = kev.event_arrival(
                d["ev_ring"], d["ev_count"], p["tgt"], p["row_ptr"],
                p["plastic"], d["last_post"], d["w"], d["last_arr"], step,
                **ltd_kw, **kw)
        return (*out, d["w"], d["last_arr"], d["ev_ring"], d["ev_count"])

    def neurons(impl, d, p, t=None):
        # the kernel as the path calls it: t and the stimulus row from a
        # step counter, the stimulus a window
        step, kw = steps(impl, d, t)
        if impl is kev and t is not None:
            step = ctrs[t]
        out = impl.event_neurons(
            d["i_syn"], window(impl, t, d["stim_idx"]),
            window(impl, t, d["stim_amp"]), p["exc"], p["neuron_valid"],
            d["v"], d["u"], d["last_post"], d["sat"], step, izh=izh,
            c_post=c_post, **kw)
        return (*out, d["v"], d["u"], d["last_post"], d["sat"])

    def ltp(impl, d, p, t=None):
        step, kw = steps(impl, d, t)
        impl.event_ltp(d["post_ids"], d["post_count"], p["row_ptr"],
                       p["plastic"], d["last_arr"], d["w"], step, **ltp_kw,
                       **kw)
        return (d["w"],)

    def emit(impl, d, p, t=None):
        step, kw = steps(impl, d, t)
        impl.event_emit(d["src_ids"], d["src_drop"], p["fwd"], p["delay"],
                        d["ev_ring"], d["ev_count"], d["sat"], step, **kw)
        return d["ev_ring"], d["ev_count"], d["sat"]

    n = lambda m: int(m.sum())
    dense_h, dense = per_shard(dense_inputs)
    event_h, event = per_shard(event_inputs)
    # the work each shard's inputs make each op do (the solo rows' models)
    ev_traffic = [_event_traffic(pc_h[h], event_h[h], ts[h] % D, lookup)
                  for h in range(B)]
    summed = lambda name: tuple(map(sum, zip(*(tr[name] for tr, _, _ in
                                              ev_traffic))))
    lib_tgt = torch.cat([(aux["tgt_ev"] + h * N)[aux["listed"]]
                         for h, (_, _, aux) in enumerate(ev_traffic)]).to(dev)
    lib_w = torch.cat([torch.gather(event_h[h]["w"], 1, aux["eve"])[
        aux["listed"]] for h, (_, _, aux) in enumerate(ev_traffic)]).to(dev)
    cases = (
        ("stdp_phase_a", phase_a, kstdp, dense,
         ("ring", "w", "last_arr", "v", "u", "last_post"),
         STDP_KERNEL_NAMES["stdp_phase_a"], "src/repro_torch/csrc/stdp.cu",
         STDP_REPLACES["stdp_phase_a"]),
        ("arborize", arborize, karb, dense, ("ring",), "arborize_rows",
         "src/repro_torch/csrc/arborize.cu", "src/repro/core/engine.py:315"),
        *((name, fn, kev, event, state, EVENT_KERNEL_NAMES[name],
           EVENT_SOURCES[name], EVENT_REPLACES[name])
          for name, fn, state in (
              ("event_arrival", arrival,
               ("ev_ring", "ev_count", "w", "last_arr")),
              ("event_neurons", neurons, ("v", "u", "last_post", "sat")),
              ("event_ltp", ltp, ("w",)),
              ("event_emit", emit, ("ev_ring", "ev_count", "sat")))))
    rows, failed = [], []
    on_dev = {}
    for name, fn, kimpl, st, state, kernel, source, replaces in cases:
        if id(st) not in on_dev:
            on_dev.clear()
            torch.cuda.empty_cache()
            saved = {k: v.to(dev) for k, v in st.items()}
            on_dev[id(st)] = (saved, {k: v.clone() for k, v in saved.items()},
                              [{k: v[h:h + 1].clone() for k, v in
                                saved.items()} for h in range(B)])
        saved, work, solo_work = on_dev[id(st)]

        def restore(*names):
            for k in names:
                work[k].copy_(saved[k])

        def solo_restore(names=state):
            for h in range(B):
                for k in names:
                    solo_work[h][k].copy_(saved[k][h:h + 1])

        again = lambda: restore(*state)
        launch = lambda: fn(kimpl, work, pg)
        solo_all = lambda: [fn(kimpl, solo_work[h], pg_h[h], ts[h])
                            for h in range(B)]
        restore(*saved)
        got = [x.clone() for x in launch()]
        torch.cuda.synchronize()
        cpu = {k: v.clone() for k, v in st.items()}
        with kref.flush_denormal():
            want = fn(kref, cpu, pc)
        restore(*state)
        want_dev = fn(kref, work, pg)
        solo_restore(saved)
        solo = [[x.clone() for x in out] for out in solo_all()]
        equal_plain = all(bit_equal(a, b) and bit_equal(a, c)
                          for a, b, c in zip(got, want, want_dev))
        equal_solo = all(bit_equal(a[h:h + 1], solo[h][i])
                         for i, a in enumerate(got) for h in range(B))
        err = max(max(max_abs_err(a, b), max_abs_err(a, c),
                      *(max_abs_err(a[h:h + 1], solo[h][i])
                        for h in range(B)))
                  for i, (a, b, c) in enumerate(zip(got, want, want_dev)))
        if not (equal_plain and equal_solo):
            failed.append(f"{name}[t_base]")
        if name == "stdp_phase_a":
            n_bytes = n_flops = 0
            for h in range(B):
                r = ts[h] % D
                tr, _ = _stdp_traffic(pc_h[h], dense_h[h], r, half_neg)
                b_, f_, _ = _phase_a_traffic(
                    pc_h[h], dense_h[h], want[0][h:h + 1], r, ts[h],
                    half_neg, tr["stdp_arrival_current"][0])
                n_bytes, n_flops = n_bytes + b_, n_flops + f_
        elif name == "arborize":
            # the spike flags, the two row pointers of each spiking
            # source, per synapse it sets its id and delay in, its flag out
            n_active = n(torch.gather(st["spiked_src"], 1, pc["src"])
                         & pc["valid"])
            n_bytes = H * S + n(st["spiked_src"]) * 8 + n_active * (4 + 4 + 1)
            n_flops = 0
        elif name == "event_neurons":
            n_bytes = (H * N * (16 + 4 + 2 + 1) + n(want[0]) * 4
                       + H * c_post * 4
                       + nbytes(st["stim_idx"], st["stim_amp"]) + H * 12)
            n_flops = H * N * 20
        else:
            n_bytes, n_flops = summed(name)
        n_bytes += 8 * H                                 # t_base
        bms, by = bound(n_bytes, n_flops)
        forms = {"t_base": [], "solo": []}
        for _ in range(2):
            forms["t_base"].append(device_ms(launch, restore=again,
                                             kernel=kernel))
            forms["solo"].append(device_ms(solo_all, restore=solo_restore,
                                           kernel=kernel))
        rows.append(dict(
            name=name + "[t_base]", route="cuda", source=source,
            replaces=replaces, launches=None, max_abs_err=err,
            ms=in_place_ms(launch, again),
            solo_ms=in_place_ms(solo_all, solo_restore),
            device_ms=forms["t_base"][0],
            t_base_device_ms=forms["t_base"],
            solo_device_ms=forms["solo"],
            plain_ms=in_place_ms(lambda: fn(kref, work, pg), again,
                                 calls=3, warmup=1),
            bound_ms=bms, bound_by=by,
            library_ms=(cuda_ms(lambda: torch.zeros(
                H * N, device=dev).index_add_(0, lib_tgt, lib_w))
                if name == "event_arrival" else None),
            equal=equal_plain and equal_solo, equal_to_plain=equal_plain,
            equal_to_solo=equal_solo,
            form="one launch over the fold: t from a step counter at 0, "
                 "t_base[h] the shard's step (int64 [H]), as simserve's "
                 "round launches it; solo_*: the slots' own launches, one "
                 "a shard at its step",
            tolerance="bit-equal (every output and updated state tensor, "
                      "0 ulp), to the plain version with the same "
                      "per-shard steps on a CPU copy and on the card, and "
                      "each shard's rows to its solo launch",
            density="main", bytes=n_bytes, flops=n_flops,
            shape=dict(slots=B, tenant_shards=1, H=H, E=E, N=N, S=S, D=D,
                       steps=ts, cap_ev=sp.cap_ev, c_post=c_post,
                       c_src=c_src)))
    return rows, failed


def _event_emit_long_rings():
    """`event_emit` on rings of 21 and 40 slots (delay_max 20 and 39; the
    kernel scans 16 slots a pass): a 2x2 event plan at full width (800,000
    synapses), ring slots listing a share of the valid synapses as phase B
    left them, 2.15% of the sources spiking, all listed (c_src = S):
    bit-equal to its plain version on a CPU copy and on the card in ring,
    counts and sat, timed beside its bound and its plain version."""
    rows, failed = [], []
    rng = np.random.default_rng(2023)
    for label, delay_max in (("d21", 20), ("d40", 39)):
        sp = StepProgram(GridConfig(grid_x=2, grid_y=2, delay_max=delay_max),
                         EngineConfig(delivery="event"), device="cuda")
        plan, eplan = sp.plan, sp.eplan
        H, E = plan.syn_valid.shape
        S = plan.src_gid.shape[1]
        D, cap, t = sp.spec.cfg.n_delay_slots, sp.cap_ev, 1003
        pg = dict(fwd=eplan.fwd_rows, delay=plan.syn_delay)
        pc = {k: v.cpu() for k, v in pg.items()}
        st = _event_state(rng, dict(valid=plan.syn_valid.cpu(),
                                    row_ptr=plan.row_ptr.cpu()),
                          t + 1, STDP_DENSITY, cap, D)
        spiked_src = torch.from_numpy(rng.random((H, S)) < STDP_DENSITY)
        ids, drop = aer.compact_indices(spiked_src, S, fill=S)
        ins = dict(src_ids=ids.contiguous(), src_drop=drop,
                   ev_ring=st["ev_ring"], ev_count=st["ev_count"],
                   sat=st["sat"])
        saved = {k: v.cuda() for k, v in ins.items()}
        work = {k: v.clone() for k, v in saved.items()}

        def restore():
            for k in ("ev_ring", "ev_count", "sat"):
                work[k].copy_(saved[k])

        def emit_op(impl, d, p):
            impl.event_emit(d["src_ids"], d["src_drop"], p["fwd"],
                            p["delay"], d["ev_ring"], d["ev_count"],
                            d["sat"], t)
            return d["ev_ring"], d["ev_count"], d["sat"]

        got = [x.clone() for x in emit_op(kev, work, pg)]
        torch.cuda.synchronize()
        want = emit_op(kref, {k: v.clone() for k, v in ins.items()}, pc)
        restore()
        want_gpu = emit_op(kref, work, pg)
        equal = all(bit_equal(a, b) and bit_equal(a, c)
                    for a, b, c in zip(got, want, want_gpu))
        if not equal:
            failed.append(f"event_emit ({label})")
        err = max(max(max_abs_err(a, b), max_abs_err(a, c))
                  for a, b, c in zip(got, want, want_gpu))
        listed = ids < S
        fwd = torch.gather(pc["fwd"], 1, torch.clamp(ids, max=S - 1).to(
            torch.int64)[:, :, None].expand(-1, -1, pc["fwd"].shape[2]))
        emitted = int(((fwd >= 0) & listed[:, :, None]).sum())
        # the list; per emitted event its row entry and delay in and its
        # id out; the counts and sat
        n_bytes = ids.numel() * 4 + emitted * (4 + 4 + 4) + H * D * 8
        bms, by = bound(n_bytes, 0)
        launch = lambda: emit_op(kev, work, pg)
        rows.append(dict(
            name="event_emit", route="cuda", source=EVENT_SOURCES["event_emit"],
            replaces=EVENT_REPLACES["event_emit"], launches=None,
            max_abs_err=err, ms=in_place_ms(launch, restore),
            device_ms=device_ms(launch, restore=restore, kernel="emit_scan"),
            plain_ms=in_place_ms(lambda: emit_op(kref, work, pg), restore,
                                 calls=3, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=None,
            library_note="no single PyTorch call does this", equal=equal,
            tolerance="bit-equal (ring, counts, sat), to the plain version "
                      "on a CPU copy and on the card",
            density=label, bytes=n_bytes, flops=0,
            shape=dict(H=H, E=E, S=S, D=D, cap_ev=cap, t=t,
                       max_delay=int(plan.syn_delay.max()),
                       listed_sources=int(listed.sum()), emitted=emitted,
                       sat=int(got[2].sum()))))
        del sp, plan, eplan, pg, saved, work
    return rows, failed


def phase_kernels(plan8, spec8, sp8e, lookup):
    """Each kernel against its plain version at the 8x8 shapes (`lookup`:
    `phase_build`'s arrivals yardstick); returns the rows of the `kernels`
    line (the STDP passes at the main density)."""
    H, E = plan8.syn_valid.shape
    N = plan8.gid.shape[1]
    rng = np.random.default_rng(2013)
    neuron = {k: v.view(H, N) for k, v in _neuron_inputs(rng, H * N).items()}
    izh = spec8.izh
    gn = {k: v.cuda() for k, v in neuron.items()}
    izh_kw = dict(v_peak=izh.v_peak, dt=izh.dt, substeps=izh.v_substeps)
    nargs = lambda d: (d["v"], d["u"], d["current"], d["a"], d["b"], d["c"],
                       d["d"])
    contrib_cpu = torch.from_numpy(
        rng.uniform(-5.0, 10.0, (H, E)).astype(np.float32))
    contrib = contrib_cpu.cuda()
    seg_cpu = kref.make_segments(plan8.row_ptr.cpu(), E)
    seg = kref.make_segments(plan8.row_ptr, E)
    n_valid = int(plan8.row_ptr[:, -1].sum())
    # index_add_'s operands: the valid synapses' flat targets and values
    valid = torch.nonzero(plan8.syn_valid.reshape(-1)).reshape(-1)
    lib_tgt = (plan8.syn_tgt + (torch.arange(H, device="cuda") * N)[:, None]
               ).reshape(-1)[valid]
    lib_contrib = contrib.reshape(-1)[valid]

    cases = [
        dict(name="izhikevich_update",
             source="src/repro_torch/csrc/izhikevich.cu",
             replaces="src/repro/kernels/izhikevich.py:37",
             kernel=lambda: kizh.izhikevich_update(*nargs(gn), **izh_kw),
             plain_gpu=lambda: kref.izhikevich_update(*nargs(gn), **izh_kw),
             plain_cpu=lambda: kref.izhikevich_update(*nargs(neuron),
                                                      **izh_kw),
             bytes=nbytes(*nargs(gn)) + H * N * (4 + 4 + 1),
             flops=H * N * 20, library=None),
        dict(name="segment_sum_ordered",
             source="src/repro_torch/csrc/segment_sum.cu",
             replaces="src/repro/core/engine.py:230",
             kernel=lambda: kseg.segment_sum_ordered(contrib, seg),
             plain_gpu=lambda: kref.segment_sum_ordered(contrib, seg),
             plain_cpu=lambda: kref.segment_sum_ordered(contrib_cpu,
                                                        seg_cpu),
             bytes=n_valid * 4 + nbytes(plan8.row_ptr) + H * N * 4,
             flops=n_valid,
             library=lambda: torch.zeros(H * N, device="cuda").index_add_(
                 0, lib_tgt, lib_contrib)),
    ]
    rows, failed = [], []
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    for c in cases:
        got = c["kernel"]()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        with kref.flush_denormal():
            want = c["plain_cpu"]()
        want = want if isinstance(want, tuple) else (want,)
        equal = all(bit_equal(a, b) for a, b in zip(got, want))
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if c["name"] == "segment_sum_ordered":
            equal &= bit_equal(got[0], c["plain_gpu"]())
        if not equal:
            failed.append(c["name"])
        bms, by = bound(c["bytes"], c["flops"])
        rows.append(dict(
            name=c["name"], route="cuda", source=c["source"],
            replaces=c["replaces"], launches=None, max_abs_err=err,
            ms=cuda_ms(c["kernel"]), device_ms=device_ms(c["kernel"]),
            plain_ms=cuda_ms(c["plain_gpu"], calls=3),
            bound_ms=bms, bound_by=by,
            library_ms=(cuda_ms(c["library"]) if c["library"] else None),
            equal=equal, tolerance="bit-equal (every output, 0 ulp)",
            shape={"E": H * E, "N": H * N,
                                "synapses_summed": n_valid}))
    part("izhikevich_segment_sum")
    stdp_rows, stdp_failed = _stdp_rows(plan8, spec8)
    rows[1:1] = stdp_rows
    failed += stdp_failed
    part("stdp")
    arb_rows, arb_failed = _arborize_rows(plan8, spec8)
    rows += arb_rows
    failed += arb_failed
    part("arborize")
    ev_rows, ev_failed = _event_rows(sp8e, lookup)
    rows += ev_rows
    failed += ev_failed
    part("event")
    long_rows, long_failed = _event_emit_long_rings()
    rows += long_rows
    failed += long_failed
    part("event_emit_long_rings")
    with _shared_tables():
        sp4e = _program(GridConfig(grid_x=4, grid_y=4),
                        EngineConfig(delivery="event"))
    tb_rows, tb_failed = _t_base_rows(sp4e, lookup)
    del sp4e
    torch.cuda.empty_cache()
    rows += tb_rows
    failed += tb_failed
    part("t_base")
    # registers, shared memory and spills of the STDP kernels (row_kernel<
    # true> is phase A, row_kernel<false> the fused arrival pass) and of
    # phase B's
    emit({"phase": "kernels", "stdp_ptxas": _inspect("stdp.cu")["ptxas"],
          "arborize_ptxas": _inspect("arborize.cu")["ptxas"],
          "event_ptxas": _inspect("event.cu")["ptxas"],
          "event_phase_a_ptxas": _inspect("event_phase_a.cu")["ptxas"],
          "seconds_by_part": parts, "rows": rows})
    if failed:
        raise PhaseFailed(f"kernels differ from their plain versions: "
                          f"{failed}")
    return [r for r in rows if r.get("density", "main") == "main"]


def _first_divergence(a: np.ndarray, b: np.ndarray):
    diff = np.nonzero((a != b).reshape(a.shape[0], -1).any(axis=1))[0]
    return int(diff[0]) if diff.size else None


def _snn_counted(kops=None) -> tuple:
    """The SNN kernels whose launches `check` and `timed` read: the dense
    path's, those it replaced (off the path: `izhikevich_update`, the
    pair, `arborize_elements`), the event path's, the split schedule's
    `event_compact`, the LTP kernel the event path's replaced, and the
    streamed path's.  (`kops`: the ops module, where the caller is a rank
    that imported it itself.)"""
    kops = kops or ops
    return (kops.SNN_KERNELS + kops.PHASE_A_KERNELS + kops.PAIR_KERNELS
            + kops.PHASE_B_KERNELS + kops.EVENT_KERNELS
            + kops.EVENT_SPLIT_KERNELS + kops.EVENT_YARDSTICKS
            + kops.STREAM_KERNELS + kops.STREAM_SPLIT_KERNELS)


def _path_kernels(delivery: str) -> tuple:
    """The kernels a step of `delivery` launches once each."""
    return ops.SNN_KERNELS if delivery == "dense" else ops.EVENT_KERNELS


def _main_path_counts(steps: int, delivery: str = "dense") -> dict:
    """Each kernel of the delivery's path once a step, every other SNN
    kernel never."""
    return dict(dict.fromkeys(_snn_counted(), 0),
                **dict.fromkeys(_path_kernels(delivery), steps))


#: how many layouts' host tables `_shared_tables` keeps (a 4x4 full-width
#: layout's are about 90 MB)
TABLES_KEPT = 12
_TABLES: dict = {}


@contextlib.contextmanager
def _shared_tables():
    """Inside the block, each layout's host connectivity tables
    (`connectivity.build_all_shards`) are built once and handed out as
    copies.  The checks build the same 4x4 layouts again and again (each
    program, each checkpoint's synapse keys, each solo run beside the
    service), and the tables are a pure function of the grid, the shard
    count and the placement, so a copy is what the build would give.
    The phases that time a build (`build_8x8`, mesh_timed, the 8x8
    checkpoint keys, simserve_timed, the bench suites) run outside it."""
    real = connectivity.build_all_shards

    def shared(cfg, eng):
        key = (cfg, eng.n_shards, eng.placement)
        if key in _TABLES:
            _TABLES[key] = _TABLES.pop(key)          # the newest
        else:
            _TABLES[key] = real(cfg, eng)
            while len(_TABLES) > TABLES_KEPT:
                del _TABLES[next(iter(_TABLES))]     # the oldest
        return copy.deepcopy(_TABLES[key])
    connectivity.build_all_shards = shared
    try:
        yield
    finally:
        connectivity.build_all_shards = real


def _program(cfg, eng, device: str = "cuda") -> "StepProgram":
    """The program of (cfg, eng) on the card (or `device`); under event
    delivery with capacities that drop nothing
    (`event_engine.no_drop_caps`, a ring of E events a slot), as the
    committed reference's event runs."""
    sp = StepProgram(cfg, eng, device=device)
    if eng.delivery == "event":
        state0 = event_engine.init_event_state(
            sp.spec, sp.init_state().base, sp.spec.e_cap)
        sp = StepProgram.from_parts(sp.spec, sp.plan, state0, eplan=sp.eplan,
                                    caps=event_engine.no_drop_caps(sp.spec))
    return sp


def _signatures(sp, state, raster) -> tuple:
    raster_np = raster.cpu().numpy()
    return (observables.raster_signature(
        raster_np, sp.plan.gid.cpu().numpy()).hex(),
        sp.weight_signature(state).hex(), raster_np)


def _same_run(a, b) -> bool:
    """Two runs' outputs (state, raster, timings) bit for bit."""
    return (torch.equal(a[1], b[1])
            and all(bit_equal(x, y) for x, y in zip(
                engine.state_tensors(a[0]), engine.state_tensors(b[0])))
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def _graph_replays_sync_debug(sp, state, t0: int, n_steps: int):
    """A whole run of the captured graph's replays (state in, windows,
    outputs, state out) under sync-debug "error", its stimulus drawn
    before; None, or the error's text."""
    index, amp = engine.stim_rows(sp.spec, sp.plan, t0, n_steps)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sp.runner.run(state, t0, n_steps, index, amp)
        return None
    except RuntimeError as e:
        return str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def phase_check():
    """4x4 full width, 150 steps, three layouts, dense and event delivery,
    against the committed AVX-pinned JAX reference; the graph run again
    (replays only) and the eager loop give the same bits; whole replays
    and whole steps of every exchange raise nothing under sync-debug."""
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    cfg = GridConfig(**ref["grid"],
                     neurons_per_column=ref["neurons_per_column"],
                     synapses_per_neuron=ref["synapses_per_neuron"])
    steps = ref["steps"]
    results, failed = {}, []
    cases = [("dense", name, r) for name, r in ref["runs"].items()]
    cases += [("event", name, r) for name, r in ref["event_runs"].items()]
    for delivery, name, r in cases:
        key = name if delivery == "dense" else f"event_{name}"
        eng = EngineConfig(n_shards=r["n_shards"], placement=r["placement"],
                           delivery=delivery)
        sp = _program(cfg, eng)
        state0 = sp.init_state()
        t0 = time.perf_counter()
        first, graph_counts = _counted_run(sp, state0, steps, True)
        wall = time.perf_counter() - t0
        rsig, wsig, raster_np = _signatures(sp, first[0], first[1])
        per_step = raster_np.sum(axis=(1, 2)).astype(int)
        replayed = sp.run(state0, 0, steps)
        eager, counts = _counted_run(sp, state0, steps, False)
        same = _same_run(first, replayed) and _same_run(first, eager)
        sat = (first[0].sat.cpu().tolist() if delivery == "event" else None)
        want = _main_path_counts(steps, delivery)
        ok = (rsig == r["raster_signature"] and wsig == r["weight_signature"]
              and counts["counted"] == want and graph_counts["total"] == want
              and same
              and (sat is None or (sat == r["sat"] and not any(sat))))
        res = dict(raster_equal=rsig == r["raster_signature"],
                   weights_equal=wsig == r["weight_signature"],
                   graph_equal_to_replays_and_eager=same, sat=sat,
                   spikes=int(per_step.sum()), launches=counts["counted"],
                   graph_launches=graph_counts, wall_s=wall,
                   window=engine.RUN_WINDOW)
        if not ok:
            failed.append(key)
            res["first_step_spike_count_differs"] = _first_divergence(
                per_step, np.asarray(r["spikes_per_step"]))
            cpu = StepProgram(cfg, eng, device="cpu", caps=sp.caps)
            _, raster_cpu, _ = cpu.run(cpu.init_state(), 0, steps)
            res["first_step_gpu_differs_from_cpu_port"] = _first_divergence(
                raster_np, raster_cpu.numpy())
        err = _graph_replays_sync_debug(sp, state0, 0, steps)
        res["graph_replays_sync_debug_error"] = err
        if err is not None:
            failed.append(f"{key} (graph replays, sync-debug)")
        if r["n_shards"] > 1:
            # the exchange wires across several shards and at group stride
            errs = _whole_steps_sync_debug(sp.spec, sp.plan, first[0], steps,
                                           hier_groups=2, eplan=sp.eplan,
                                           caps=sp.caps)
            res["whole_steps_sync_debug_errors"] = errs
            if any(e is not None for e in errs.values()):
                failed.append(f"{key} (sync-debug)")
        results[key] = res
        del sp, first, replayed, eager
    emit({"phase": "check", "grid": "4x4", "steps": steps,
          "runs": results})
    if failed:
        raise PhaseFailed(f"main path differs from the JAX reference: "
                          f"{failed}")


def _whole_steps_sync_debug(spec, plan, s, t0: int, hier_groups,
                            eplan=None, caps=None) -> dict:
    """No step may synchronise with the host: a few whole steps (phase A,
    the exchange, phase B) through the phase handles of each exchange
    wire under sync-debug "error" (a pageable copy or a read of a device
    value raises), from state `s` (updated in place) at step t0.
    Returns each wire's error text, or None."""
    errors = {}
    for ex in EXCHANGES:
        sp = StepProgram.from_parts(
            spec._replace(eng=dataclasses.replace(spec.eng, exchange=ex)),
            plan, s, eplan=eplan, caps=caps, hier_groups=hier_groups)
        pp = sp.phase_fns()
        # one step outside: it draws the stimulus window of t0
        s, spiked, _ = pp.phase_a(s, t0)
        s = pp.phase_b(s, pp.exchange(spiked), t0)
        t0 += 1
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t_ in range(t0, t0 + SYNC_DEBUG_STEPS):
                s, spiked, _ = pp.phase_a(s, t_)
                s = pp.phase_b(s, pp.exchange(spiked), t_)
            errors[ex] = None
        except RuntimeError as e:
            errors[ex] = str(e)[:300]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t0 += SYNC_DEBUG_STEPS
        del sp, pp
    return errors


def _counted_run(sp, state0, steps: int, graph: bool):
    """`sp.run` with its launches -> (outputs, {"counted": the SNN
    kernels' launches the wrappers counted (the eager steps'), "replayed":
    the replays' (`CapturedRun.replayed_launches`), "total": their sum})."""
    ops.reset_launch_counts()
    out = sp.run(state0, 0, steps, graph=graph)
    torch.cuda.synchronize()
    counted = {k: ops.launch_counts()[k] for k in _snn_counted()}
    replayed = sp.runner.replayed_launches()
    total = {k: n + replayed.get(k, 0) for k, n in counted.items()}
    return out, dict(counted=counted, replayed=replayed, total=total)


def _timed_run(sp, state0, graph: bool) -> dict:
    """MAIN_STEPS steps of `sp.run` after a warm-up run that captures the
    graph: the run's outputs, wall, launches and peak memory."""
    sp.run(state0, 0, 2 * engine.RUN_WINDOW, graph=graph)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, counts = _counted_run(sp, state0, MAIN_STEPS, graph)
    wall = time.perf_counter() - t0
    return dict(out=out, wall=wall, counts=counts,
                peak=torch.cuda.max_memory_allocated())


def phase_timed(sp8, sp8e):
    """The 8x8 main path, H=1, MAIN_STEPS steps, for each delivery: the
    captured graph's run and the eager loop's (the same bits), ms/step,
    the synchronised phase split, the sync-debug steps of each exchange.
    Returns the launches of each delivery's path kernels in its eager run,
    as the wrappers counted them."""
    cfg = sp8.spec.cfg
    launches, dense_raster = {}, None
    for delivery, sp in (("dense", sp8), ("event", sp8e)):
        state0 = sp.init_state()
        runs = {"graph": _timed_run(sp, state0, True),
                "eager": _timed_run(sp, state0, False)}
        g = runs["graph"]["out"]
        same = _same_run(g, runs["eager"]["out"])
        raster_np = g[1].cpu().numpy()
        rate = observables.mean_rate_hz(raster_np, cfg.n_neurons)
        events = int(g[2].arrivals.sum())
        line = dict(phase="timed", delivery=delivery,
                    grid=f"{cfg.grid_x}x{cfg.grid_y}",
                    neurons=cfg.n_neurons, synapses=cfg.n_synapses,
                    shards=sp.spec.eng.n_shards, steps=MAIN_STEPS,
                    window=engine.RUN_WINDOW, caps=sp.caps,
                    graph_equal_to_eager=same, rate_hz=rate,
                    synaptic_events=events,
                    raster_signature=observables.raster_signature(
                        raster_np, sp.plan.gid.cpu().numpy()).hex(),
                    weight_signature=sp.weight_signature(g[0]).hex())
        want = _main_path_counts(MAIN_STEPS, delivery)
        for mode, r in runs.items():
            counts = r["counts"]
            line[mode] = dict(
                wall_s=r["wall"], ms_per_step=r["wall"] / MAIN_STEPS * 1e3,
                s_per_synapse_per_sim_s_per_hz=timing.norm_seconds(
                    r["wall"], cfg.n_synapses, MAIN_STEPS, rate),
                synaptic_events_per_s=events / r["wall"],
                max_memory_allocated_bytes=r["peak"],
                launches=counts["counted"],
                replayed_launches=counts["replayed"],
                launches_once_a_step=counts["total"] == want)
        # the eager loop's launches, each counted where it was made
        line["eager"]["launches_once_a_step"] &= (
            runs["eager"]["counts"]["counted"] == want)
        if delivery == "event":
            line["sat"] = g[0].sat.cpu().tolist()
            line["raster_equal_to_dense"] = bool(np.array_equal(
                raster_np, dense_raster))
        else:
            dense_raster = raster_np
        # separate synchronised pass: the per-phase split (paper Table 2),
        # through StepProgram.time_phases under the 'sync' schedule; it
        # works on a copy of state0 and returns the state after
        n_split = 100
        s, split, _, _ = sp.time_phases(state0, 0, n_split)
        line["split_sync_pass"] = {
            k.replace("_s", "_ms_per_step"): v / n_split * 1e3
            for k, v in split.items()}
        errs = _whole_steps_sync_debug(sp.spec, sp.plan, s, n_split,
                                       hier_groups=1, eplan=sp.eplan,
                                       caps=sp.caps)
        line["whole_steps_sync_debug_steps"] = SYNC_DEBUG_STEPS
        line["whole_steps_sync_debug_errors"] = errs
        emit(line)
        if any(e is not None for e in errs.values()):
            raise PhaseFailed(f"a {delivery} step synchronised with the "
                              f"host under sync-debug 'error': {errs}")
        if not same:
            raise PhaseFailed(f"the {delivery} graph run differs from the "
                              f"eager loop")
        if not all(line[m]["launches_once_a_step"] for m in runs):
            raise PhaseFailed(f"{delivery}: kernels not launched once per "
                              f"step (or another SNN kernel launched): "
                              f"{line['graph']}, {line['eager']}")
        if delivery == "event" and any(line["sat"]):
            raise PhaseFailed(f"the event run dropped events: {line['sat']}")
        launches.update({k: runs["eager"]["counts"]["counted"][k]
                         for k in _path_kernels(delivery)})
        del runs, g
    return launches


def phase_profile(sp8, sp8e, n_steps: int = 20):
    """Device time by kernel (torch.profiler), device busy and idle share,
    and device operations per step: the dense path over its first
    `n_steps` steps from the initial state (nearly silent), and each
    delivery over the timed run's MAIN_STEPS steps (activity comes in
    bursts, so only the whole run gives the kernels' mean), as the
    captured graph's replays and as the eager loop."""
    from torch.profiler import ProfilerActivity, profile
    windows = {}
    cases = [("dense_first", sp8, n_steps, True)]
    cases += [(f"{d}_{m}", sp, MAIN_STEPS, m == "graph")
              for d, sp in (("dense", sp8), ("event", sp8e))
              for m in ("graph", "eager")]
    for label, sp, steps, graph in cases:
        state0 = sp.init_state()
        sp.run(state0, 0, steps, graph=graph)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            c0 = time.perf_counter()
            _, _, tm = sp.run(state0, 0, steps, graph=graph)
            torch.cuda.synchronize()
            wall = time.perf_counter() - c0
        rows = sorted(((us, k, c) for k, us, c in device_kernel_events(prof)),
                      reverse=True)
        busy_us = sum(r[0] for r in rows)
        windows[label] = dict(
            steps=steps, graph=graph, wall_s=wall,
            arrivals_per_step=int(tm.arrivals.sum()) / steps,
            spikes_per_step=int(tm.spikes.sum()) / steps,
            device_busy_s=busy_us * 1e-6 if rows else None,
            device_busy_ms_per_step=busy_us * 1e-3 / steps if rows
            else None,
            device_idle_share=(1.0 - busy_us * 1e-6 / wall) if rows
            else None,
            device_ops_per_step=sum(r[2] for r in rows) / steps,
            top=[dict(name=k[:90], device_ms_per_step=us * 1e-3 / steps,
                      calls=c) for us, k, c in rows[:15]])
    emit({"phase": "profile", "windows": windows})


def _report_line(suite: str, rep: dict, **more) -> None:
    emit({"phase": "bench", "suite": suite, "env": rep["env"],
          "config": rep["config"], "deterministic": rep["deterministic"],
          "wall": rep["wall"], **more})


def _run_cluster_scaling():
    """`cluster_scaling` quick on the card (its ranks are other processes,
    so it may run on a thread) -> its report, or the error's text (a
    failed launch or unequal rasters)."""
    try:
        return cluster_cli.sweep_report(quick=True, device="cuda")
    except Exception as e:
        return str(e)[-3000:] or repr(e)


def phase_bench(scaling=None):
    """The ported bench suites on the card (`repro_torch.bench`), one line
    per report: `table1` quick (its 4x4 row's raster signature and spike
    count must be the committed JAX reference's h1_block run: the same
    grid, layout and 150 steps), `table1` at TABLE1_ROWS and its 300
    steps (build seconds and peak memory by row), `table2` under
    `sync` and its cell again under `pipelined` (equal raster
    signatures), `profile` (which raises unless every exchange x
    placement cell gives the same raster and totals), `event_vs_dense`'s
    single-device rows, `cluster_scaling` quick (`scaling`: its report or
    error, run beside the checkpoint and service checks), and
    `connectivity_sweep`
    quick (each profile's spikes and raster signature equal to
    `jax_reference.json`'s connectivity_sweep entries) and at its full
    size (12x12, H = 8, 100 steps)."""
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    want = ref["runs"]["h1_block"]
    quick = table1.run_suite(quick=True, device="cuda")
    det = quick["deterministic"]
    quick_ok = (det["sig_4x4"] == want["raster_signature"]
                and det["spikes_4x4"] == want["spikes"])
    _report_line("table1_quick", quick, rows=quick["extra"]["rows"],
                 equal_to_jax_reference=quick_ok)
    full = table1.run_suite(device="cuda", rows=TABLE1_ROWS)
    _report_line("table1", full, rows=full["extra"]["rows"])
    t2 = table2.run_suite(device="cuda")
    row = t2["extra"]["row"]
    pipelined = bench_profile.profile_cell(
        GridConfig(grid_x=2, grid_y=2, neurons_per_column=1000),
        EngineConfig(n_shards=1, exchange="halo",
                     exchange_schedule="pipelined"), row["steps"],
        device="cuda")
    same = (pipelined["raster_sig"] == row["raster_sig"]
            and pipelined["spikes"] == row["spikes"])
    _report_line("table2", t2, row=row, pipelined=pipelined,
                 schedules_equal=same)
    prof = bench_profile.run_profile(device="cuda")
    _report_line("profile", prof, cells=prof["extra"]["cells"])
    evd = event_vs_dense.run_suite(device="cuda", distributed=False)
    _report_line("event_vs_dense", evd, rows=evd["extra"]["rows"])
    cs = scaling or _run_cluster_scaling()
    if isinstance(cs, str):
        raise PhaseFailed(f"cluster_scaling: {cs}")
    _report_line("cluster_scaling", cs, points=cs["extra"]["points"],
                 contended_by=None if scaling is None else
                 "ckpt_check, simserve_check, the plan phase's cells and "
                 "cluster_check's ranks")
    sweep_want = ref["connectivity_sweep"]["profiles"]
    t0 = time.perf_counter()
    sweep_q = connectivity_sweep.run_suite(quick=True, device="cuda")
    sweep_q_s = time.perf_counter() - t0
    sdet = sweep_q["deterministic"]
    sweep_ok = {p: (sdet[f"{connectivity_sweep._key(p)}_raster_sig"]
                    == w["raster_signature"]
                    and sdet[f"{connectivity_sweep._key(p)}_spikes"]
                    == w["spikes"]) for p, w in sweep_want.items()}
    _report_line("connectivity_sweep_quick", sweep_q,
                 rows=sweep_q["extra"]["rows"], seconds=sweep_q_s,
                 equal_to_jax_reference=sweep_ok)
    t0 = time.perf_counter()
    sweep = connectivity_sweep.run_suite(device="cuda")
    _report_line("connectivity_sweep", sweep, rows=sweep["extra"]["rows"],
                 seconds=time.perf_counter() - t0)
    if not all(sweep_ok.values()) or len(sweep_ok) != 4:
        raise PhaseFailed(f"connectivity_sweep quick differs from the JAX "
                          f"reference: {sweep_ok}")
    if not cs["deterministic"]["identical_across_procs"]:
        raise PhaseFailed("cluster_scaling's rasters differ across process "
                          "counts")
    if not quick_ok:
        raise PhaseFailed(f"table1's 4x4 row differs from the JAX "
                          f"reference: {det}")
    if not same:
        raise PhaseFailed("table2 differs between the sync and pipelined "
                          "schedules")


# ----------------------------------------------------------------------------
# the multi-tenant simulation service (repro_torch.simserve)
# ----------------------------------------------------------------------------


def _simserve_fleet(cfg0, H: int) -> list:
    """simserve_check's tenants at H shards: SIMSERVE_SEEDS alternating
    dense and event delivery, then seed 2013 under event delivery (the
    reference's other run).  The event tenants carry capacities at which
    nothing drops: each shard's neurons listed, as many sources as the
    grid has neurons (no shard has more), and a ring of twice a shard's
    mean synapses a slot (each synapse is in a slot at most once)."""
    caps = (cfg0.n_neurons // H, cfg0.n_neurons)
    cap_ev = 2 * cfg0.n_synapses // H
    fleet = list(enumerate(SIMSERVE_SEEDS)) + [(len(SIMSERVE_SEEDS), 2013)]
    reqs = []
    for i, seed in fleet:
        cfg = dataclasses.replace(cfg0, seed=seed)
        if i % 2 or i == len(SIMSERVE_SEEDS):
            reqs.append(simserve.TenantRequest(
                f"t{i}", cfg, EngineConfig(n_shards=H, delivery="event"),
                SIMSERVE_STEPS, caps=caps, cap_ev=cap_ev))
        else:
            reqs.append(simserve.TenantRequest(
                f"t{i}", cfg, EngineConfig(n_shards=H), SIMSERVE_STEPS))
    return reqs


def phase_simserve_check(card: str, beside: str = "") -> dict:
    """The service on the card at 4x4 full width (3.2 M synapses a
    tenant): the fleet of `_simserve_fleet` at H = 2 in 2 slots, rounds of
    SIMSERVE_ROUND steps, SIMSERVE_STEPS steps each; the first running
    tenant evicted after round 2 and resumed a round later at H = 4
    (through its checkpoint).  Every tenant's streamed signature must equal
    its solo `StepProgram.run` on the card (the captured graph), the seed
    2013 tenants `jax_reference.json`'s h1_block runs (dense and event),
    sat 0 everywhere, one capture per shape key over 3 keys, preemptions
    > 0, and every kernel of both deliveries' paths launched (the
    wrappers' counts, set to 0 before the service and read after it: each
    program's first round runs eagerly, then is captured).  Returns those
    counts.  `beside` names what ran on the card at the same time: the
    line then marks its seconds as contended."""
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    cfg0 = GridConfig(**ref["grid"],
                      neurons_per_column=ref["neurons_per_column"],
                      synapses_per_neuron=ref["synapses_per_neuron"])
    reqs = _simserve_fleet(cfg0, 2)
    svc = simserve.SimService(slots=SIMSERVE_SLOTS,
                              round_steps=SIMSERVE_ROUND, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        svc.submit(r)
    svc.step_round()
    svc.step_round()
    victim = next(v for v in svc.sessions.values()
                  if v.status == simserve.RUNNING)
    svc.evict(victim.name)
    svc.step_round()
    svc.resume(victim.name, eng=dataclasses.replace(
        victim.eng, n_shards=2 * victim.eng.n_shards))
    snap = svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    tenants, failed = {}, []
    t0 = time.perf_counter()
    for r in reqs:
        sess = svc.sessions[r.name]
        sig = sess.stream.signature().hex()
        solo_sig, solo_sat = simserve.batcher.solo_run(
            r.cfg, r.eng, r.n_steps, r.caps, r.cap_ev, device="cuda")
        res = dict(seed=r.cfg.seed, delivery=r.eng.delivery,
                   shards=sess.eng.n_shards, status=sess.status,
                   equal_to_solo=sig == solo_sig.hex(), sat=sess.sat_total,
                   solo_sat=solo_sat, evictions=sess.evictions,
                   resumes=sess.resumes, events=sess.stream.n_events,
                   queue_wait_rounds=sess.queue_wait_rounds)
        if r.cfg.seed == 2013:
            runs = ref["runs" if r.eng.delivery == "dense" else "event_runs"]
            res["equal_to_jax_reference"] = (
                sig == runs["h1_block"]["raster_signature"])
            if not res["equal_to_jax_reference"]:
                failed.append(f"{r.name} against jax_reference.json")
        if not (res["equal_to_solo"] and sess.status == simserve.DONE
                and sess.sat_total == 0 and solo_sat == 0):
            failed.append(r.name)
        tenants[r.name] = res
    solo_s = time.perf_counter() - t0
    traces = snap["program_cache"]["traces"]
    unlaunched = [k for k in ops.SNN_KERNELS + ops.EVENT_KERNELS
                  if not counts.get(k)]
    emit({"phase": "simserve_check", "card": card,
          "grid": f"{cfg0.grid_x}x{cfg0.grid_y}",
          "synapses_per_tenant": cfg0.n_synapses, "slots": SIMSERVE_SLOTS,
          "round_steps": SIMSERVE_ROUND, "steps": SIMSERVE_STEPS,
          "victim": victim.name, "tenants": tenants,
          "snapshot": {k: v for k, v in snap.items()
                       if k != "program_cache"},
          "program_cache": snap["program_cache"], "launches": counts,
          "wall_s": wall, "solo_runs_s": solo_s,
          "host_tables": "each layout's built once (_shared_tables)",
          "contended_by": beside or None})
    if failed:
        raise PhaseFailed(f"simserve: tenants differ from their solo runs "
                          f"or the reference, or dropped events: {failed}")
    if len(traces) != 3 or any(n != 1 for n in traces.values()) \
            or snap["program_cache"]["builds"] != 3:
        raise PhaseFailed(f"simserve: not one capture per shape key: "
                          f"{snap['program_cache']}")
    if not snap["preemptions"]:
        raise PhaseFailed("simserve: the overloaded slots preempted nobody")
    if unlaunched:
        raise PhaseFailed(f"simserve: the service's rounds launched no "
                          f"{unlaunched}")
    return counts


def phase_simserve_timed(card: str) -> None:
    """`simserve_throughput` on the card at 4x4 full width, dense, H = 1:
    1, 4 and 8 tenants in as many slots, 300 steps in rounds of 50
    (`size="full"`; tenant-steps/s, wall, the host's table builds, the
    paper's time per synaptic event, the device's idle share over a
    profiled round), beside the same tenants run one after another alone
    through `StepProgram.run`; every tenant equal to its solo run, one
    build and one capture a cell."""
    rep = simserve_throughput.run_suite(device="cuda", size="full")
    rows = rep["extra"]["rows"]
    for r in rows:
        r.pop("tenant_sigs")
    emit({"phase": "simserve_timed", "card": card, "env": rep["env"],
          "config": rep["config"], "deterministic": rep["deterministic"],
          "wall": rep["wall"], "rows": rows, "solo": rep["extra"]["solo"]})
    bad = [r["tenants"] for r in rows
           if not (r["solo_equal"] and r["cache_builds"] == 1
                   and r["traces"] == 1)]
    if bad:
        raise PhaseFailed(f"simserve_timed: cells of {bad} tenants differ "
                          f"from their solo runs or were recaptured")


# ----------------------------------------------------------------------------
# the LM serving path (recurrentgemma-2b)
# ----------------------------------------------------------------------------


def _scan_inputs(rng, shape):
    B, T, D = shape
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return (f(rng.uniform(0.5, 0.999, shape)),
            f(rng.standard_normal(shape) * 0.1),
            f(rng.standard_normal((B, D))))


def _on_card(x, offset: int):
    """A copy of x on the card whose first element lies `offset` bytes past
    an aligned address (a view into a larger buffer)."""
    k = offset // x.element_size()
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device="cuda")
    view = buf[k:].view(x.shape)
    view.copy_(x)
    return view


def phase_lm_kernels():
    """The RG-LRU scan kernel against its plain version at three shapes."""
    rng = np.random.default_rng(12)
    rows, failed = [], []
    for label, shape, offset in LM_SCAN_SHAPES:
        cpu = _scan_inputs(rng, shape)
        gpu = tuple(_on_card(x, offset) for x in cpu)
        got = krg.rg_lru_scan(*gpu)
        torch.cuda.synchronize()
        with kref.flush_denormal():
            want_cpu = kref.rg_lru_scan(*cpu)
        want_gpu = kref.rg_lru_scan(*gpu)
        equal = bit_equal(got, want_cpu) and bit_equal(got, want_gpu)
        if not equal:
            failed.append(label)
        B, T, D = shape
        bms, by = bound(nbytes(*gpu) + B * T * D * 4, 2 * B * T * D)
        rows.append(dict(
            name="rg_lru_scan", route="cuda",
            source="src/repro_torch/csrc/rg_lru.cu",
            replaces="src/repro/kernels/rg_lru.py:39", launches=None,
            max_abs_err=max(max_abs_err(got, want_cpu),
                            max_abs_err(got, want_gpu)),
            ms=cuda_ms(lambda: krg.rg_lru_scan(*gpu)),
            device_ms=device_ms(lambda: krg.rg_lru_scan(*gpu)),
            plain_ms=cuda_ms(lambda: kref.rg_lru_scan(*gpu), calls=3),
            bound_ms=bms, bound_by=by, library_ms=None, equal=equal,
            tolerance="bit-equal (0 ulp), to the plain version on a CPU "
                      "copy and on the card",
            shape={"label": label, "B": B, "T": T, "D": D,
                   "offset_bytes": offset}))
    emit({"phase": "lm_kernels", "rows": rows})
    if failed:
        raise PhaseFailed(f"rg_lru_scan differs from its plain version at "
                          f"{failed}")
    return rows


def _attn_inputs(rng, c):
    """numpy-seeded fp32 q [BH, T, D] and k, v [B * kv_heads, S, D], cast
    to the row's dtype and the KV heads repeated to BH (GQA)."""
    bh, g = c["B"] * c["heads"], c["heads"] // c["kv_heads"]
    dtype = getattr(torch, c["dtype"])
    f = lambda shape, scale: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
    q = f((bh, c["T"], c["D"]), c["qk_scale"])
    kv_shape = (c["B"] * c["kv_heads"], c["S"], c["D"])
    k = f(kv_shape, c["qk_scale"]).repeat_interleave(g, 0).contiguous()
    v = f(kv_shape, 1.0).repeat_interleave(g, 0).contiguous()
    return q, k, v


def _attn_mask(c):
    """The [T, S] visibility mask of the contract (kernels.ref.attention)."""
    T, S = c["T"], c["S"]
    q_pos = torch.arange(T)[:, None] + (S - T)
    k_pos = torch.arange(S)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool)
    if c["causal"]:
        mask &= k_pos <= q_pos
    if c["window"] is not None:
        mask &= k_pos > q_pos - c["window"]
    return mask


def _within(got, want, tol) -> bool:
    rtol, atol = tol
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _sdpa(q, k, v, c, mask, scale):
    """(fn, how) for scaled_dot_product_attention at the same function, or
    (None, reason).  PyTorch's is_causal aligns the mask top-left, the
    contract bottom-right (q_pos = i + S - T): is_causal only where the
    two agree, an explicit boolean mask otherwise."""
    import torch.nn.functional as F
    if c["softcap"] is not None:
        return None, "no PyTorch call applies a logit softcap"
    q4, k4, v4 = q[None], k[None], v[None]
    if bool(mask.all()):
        kw, how = {}, "no mask (every key visible)"
    elif c["T"] == c["S"] and torch.equal(mask, torch.ones_like(mask).tril()):
        kw, how = dict(is_causal=True), "is_causal=True"
    else:
        kw, how = dict(attn_mask=mask.cuda()), "explicit boolean mask"
    return (lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale,
                                                   **kw)[0]), how


def phase_attn_kernels():
    """The attention kernels through `ops.attention` at seven shapes: one
    call each with the launch counts reset before and read after, the kernel
    each call took against the rule's, then each output against the plain
    version and the kernel timed."""
    rng = np.random.default_rng(13)
    cases = []
    for label, c in ATTN_SHAPES:
        cpu = _attn_inputs(rng, c)
        cases.append((label, c, cpu, tuple(x.cuda() for x in cpu)))
    kw = lambda c: dict(causal=c["causal"], window=c["window"],
                        softcap=c["softcap"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs, taken = [], []
    for _, c, _, gpu in cases:
        before = dict(kfa.variant_launches)
        outs.append(ops.attention(*gpu, **kw(c)))
        taken.append([k for k, n in kfa.variant_launches.items()
                      if n != before[k]])
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_attention"]
    variant_launches = dict(kfa.variant_launches)
    rows, failed = [], []
    for (label, c, cpu, gpu), got, kinds in zip(cases, outs, taken):
        rule = kfa.variant(gpu[0].dtype, c["T"], c["S"], c["D"], all(
            x.data_ptr() % 16 == 0 for x in gpu))
        kind = kinds[0] if len(kinds) == 1 else None
        if kind != rule or kind != ATTN_VARIANTS[label]:
            failed.append(f"{label} took {kinds}, the rule names {rule}")
        tol = ATTN_TOL[c["dtype"]]
        want_cpu = kref.attention(*cpu, **kw(c))
        want_gpu = kref.attention(*gpu, **kw(c))
        ok = (got.dtype == gpu[0].dtype and bool(torch.isfinite(got).all())
              and _within(got, want_cpu, tol) and _within(got, want_gpu, tol))
        err = max(max_abs_err(got, want_cpu), max_abs_err(got, want_gpu))
        del want_cpu
        if not ok:
            failed.append(label)
        scale = c["D"] ** -0.5
        kkw = dict(kw(c), scale=scale)
        mask = _attn_mask(c)
        bh = c["B"] * c["heads"]
        pairs = bh * int(mask.sum())
        peak = PEAK_BF16_PER_S if c["dtype"] == "bfloat16" else PEAK_FP32_PER_S
        bms, by = bound(nbytes(*gpu) + nbytes(got), 4 * c["D"] * pairs, peak)
        lib, how = _sdpa(*gpu, c, mask, scale)
        lib_err = max_abs_err(lib(), want_gpu) if lib else None
        ms = cuda_ms(lambda: kfa.flash_attention(*gpu, **kkw))
        dev_ms = device_ms(lambda: kfa.flash_attention(*gpu, **kkw))
        lib_ms = cuda_ms(lib) if lib else None
        lib_dev_ms = device_ms(lib) if lib else None
        rows.append(dict(
            name="flash_attention", route="cuda",
            source=ATTN_SOURCES[rule], variant=kind,
            replaces="src/repro/kernels/flash_attention.py:92",
            launches=None,
            max_abs_err=err,
            ms=ms, device_ms=dev_ms,
            plain_ms=cuda_ms(lambda: kref.attention(*gpu, **kw(c)), calls=3),
            bound_ms=bms, bound_by=by,
            library_ms=lib_ms, library_device_ms=lib_dev_ms,
            ms_over_library=ms / lib_ms if lib else None,
            device_ms_over_library=(dev_ms / lib_dev_ms
                                    if lib and dev_ms and lib_dev_ms
                                    else None),
            library_call=("torch.nn.functional.scaled_dot_product_attention, "
                          + how) if lib else None,
            library_max_abs_err=lib_err,
            library_note=None if lib else how, within_tolerance=ok,
            tolerance=f"rtol = {tol[0]}, atol = {tol[1]} against the plain "
                      f"version on a CPU copy and on the card",
            visible_pairs=pairs, flops=4 * c["D"] * pairs,
            bytes=nbytes(*gpu) + nbytes(got),
            shape=dict(label=label, BH=bh, T=c["T"], S=c["S"], D=c["D"],
                       dtype=c["dtype"], causal=c["causal"],
                       window=c["window"], softcap=c["softcap"],
                       kv_heads=c["B"] * c["kv_heads"])))
        del want_gpu
    emit({"phase": "attn_kernels", "launches": launches,
          "variant_launches": variant_launches, "rows": rows})
    del cases, outs
    torch.cuda.empty_cache()
    if launches != len(ATTN_SHAPES):
        raise PhaseFailed(f"ops.attention launched the kernel {launches} "
                          f"times for {len(ATTN_SHAPES)} calls")
    if failed:
        raise PhaseFailed(f"flash_attention differs from its plain version "
                          f"or took another kernel than its rule's at "
                          f"{failed}")
    return rows, launches


def _n_rg(cfg) -> int:
    return sum(kinds[0] == "rg" for kinds in cfg.layers)


def _requests(prompts, max_new):
    return [serve_engine.Request(prompt=np.asarray(p), max_new=m)
            for p, m in zip(prompts, max_new)]


def _lm_reference() -> dict:
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "lm_reference.json")) as f:
        return json.load(f)


@contextlib.contextmanager
def _routed(log: list, forced=None):
    """Record every MoE routing decision (`moe.top_k`): per call, the
    experts the run chose, the margin between the k-th and (k+1)-th router
    probability, and the probabilities, all on the CPU.  With `forced` (a
    log of another run) each call then takes that run's experts instead,
    its gates read from its own probabilities there."""
    real = moe_mod.top_k

    def top_k(probs, k):
        vals, idx = real(probs, k)
        srt = torch.sort(probs, dim=-1, descending=True).values
        margin = srt[..., k - 1] - srt[..., k] if k < probs.shape[-1] \
            else torch.full_like(srt[..., 0], float("inf"))
        log.append((idx.cpu(), margin.cpu(), probs.cpu()))
        if forced is not None:
            idx = forced[len(log) - 1][0].to(probs.device)
            vals = torch.gather(probs, -1, idx)
        return vals, idx

    moe_mod.top_k = top_k
    try:
        yield log
    finally:
        moe_mod.top_k = real


def _routing_check(cfg, params, ref: dict, r: dict) -> dict:
    """bf16 routing on the card against the port's run on the CPU (whose
    logits are held to the same tolerance of the reference; on the test
    host they equal granite's bit for bit), over request 0's
    teacher-forced pass.  A decision (a token's set of experts) may differ
    only where the CPU run's k-th and (k+1)-th probabilities are closer
    than the two devices' probabilities for that token differ, twice
    over: a tie within the devices' bf16 rounding, not a fault.  With the
    CPU run's experts forced, the card's logits must be within the bf16
    tolerance of the reference, as must the CPU run's."""
    prompt, toks = ref["requests"][0]["prompt"], r["tokens"][0]
    want = torch.tensor(r["teacher_forced_logits"])
    tf = lambda p: serve_engine.teacher_forced_logits(
        cfg, p, prompt, toks, ref["t_pad"], ref["s_max"])
    cpu = convert.lm_params_from_jax(
        convert.numpy_params(cfg, ref["weights_seed"]), cfg, "cpu")
    with _routed([]) as cpu_log:
        cpu_err = max_abs_err(tf(cpu), want)
    with _routed([]) as card_log:
        card_err = max_abs_err(tf(params), want)
    with _routed([], forced=cpu_log):
        forced_err = max_abs_err(tf(params), want)
    decisions, flips, unexplained = 0, [], 0
    for n, ((ic, mc, pc), (ig, _, pg)) in enumerate(zip(cpu_log, card_log)):
        differ = (ic.sort(-1).values != ig.sort(-1).values).any(-1)
        noise = (pc - pg).abs().amax(-1)
        decisions += differ.numel()
        for t in differ.nonzero().flatten().tolist():
            ok = float(mc[t]) <= 2 * float(noise[t])
            unexplained += not ok
            flips.append(dict(call=n, token=t, cpu_margin=float(mc[t]),
                              prob_gap=float(noise[t]), tie=ok))
    return dict(decisions=decisions, flips=flips[:20], n_flips=len(flips),
                unexplained_flips=unexplained, cpu_err=cpu_err,
                card_err=card_err, card_err_cpu_routing=forced_err,
                same_calls=len(card_log) == len(cpu_log))


def _serve_against(ref: dict) -> tuple:
    """One architecture's SMOKE serving in fp32 and bf16 against its entry
    of the committed JAX reference: (results by dtype, failed dtypes)."""
    prompts = [q["prompt"] for q in ref["requests"]]
    max_new = [q["max_new"] for q in ref["requests"]]
    results, failed = {}, []
    for dtype, r in ref["variants"].items():
        cfg = get_smoke_config(ref["arch"]).scaled(dtype=dtype)
        params = convert.lm_params_from_jax(
            convert.numpy_params(cfg, ref["weights_seed"]), cfg, "cuda")
        eng = serve_engine.ServeEngine(cfg, params, batch=ref["batch"],
                                       s_max=ref["s_max"], device="cuda")
        ops.reset_launch_counts()
        done = eng.run(_requests(prompts, max_new))
        launches = ops.launch_counts()["rg_lru_scan"]
        calls = eng.stats["admissions"] + eng.stats["decode_steps"]
        tokens = [q.out.tolist() for q in done]
        solo = eng.run(_requests(prompts[:1], max_new[:1]))[0].out.tolist()
        ops.reset_launch_counts()
        tf = serve_engine.teacher_forced_logits(
            cfg, params, prompts[0], r["tokens"][0], ref["t_pad"],
            ref["s_max"])
        tf_launches = ops.launch_counts()["rg_lru_scan"]
        err = max_abs_err(tf, torch.tensor(r["teacher_forced_logits"]))
        res = dict(
            tokens_equal=tokens == r["tokens"], solo_equal=solo == tokens[0],
            teacher_forced_max_abs_err=err, tolerance=LM_TOL[dtype],
            finite=bool(torch.isfinite(tf).all()),
            launches=launches, forward_calls=calls,
            expected_launches=_n_rg(cfg) * calls,
            teacher_forced_launches=tf_launches,
            teacher_forced_expected=_n_rg(cfg) * (len(r["tokens"][0]) + 1))
        within = err <= LM_TOL[dtype]
        if cfg.moe is not None and dtype == "bfloat16":
            # a top-k over router probabilities turns a one-ulp bf16
            # difference at a near-tie into another expert: the logits
            # are held with the reference's routing, and every routing
            # difference must be such a tie
            rc = res["routing"] = _routing_check(cfg, params, ref, r)
            within = (rc["same_calls"] and rc["unexplained_flips"] == 0
                      and max(rc["cpu_err"],
                              rc["card_err_cpu_routing"]) <= LM_TOL[dtype]
                      and (err <= LM_TOL[dtype] or rc["n_flips"] > 0))
        ok = (res["solo_equal"] and res["finite"] and within
              and launches == res["expected_launches"]
              and tf_launches == res["teacher_forced_expected"]
              and (res["tokens_equal"] or dtype != "float32"))
        if not ok:
            failed.append(dtype)
        results[dtype] = res
    return results, failed


def phase_lm_check():
    """SMOKE serving in fp32 and bf16 against the committed JAX
    reference."""
    results, failed = _serve_against(_lm_reference()[LM_ARCH])
    emit({"phase": "lm_check", "arch": LM_ARCH, "config": "SMOKE",
          "runs": results})
    if failed:
        raise PhaseFailed(f"LM serving differs from the JAX reference: "
                          f"{failed}")


def phase_lm_families_check():
    """The other decoder-only archs (RWKV-6, MoE, qk-norm, untied
    embeddings) at SMOKE, fp32 and bf16, against their entries of the
    committed JAX reference: one line an arch."""
    refs, failed = _lm_reference(), []
    for arch in LM_FAMILIES:
        results, bad = _serve_against(refs[arch])
        emit({"phase": "lm_families_check", "arch": arch, "config": "SMOKE",
              "runs": results})
        failed += [f"{arch} {d}" for d in bad]
    if failed:
        raise PhaseFailed(f"LM serving differs from the JAX reference: "
                          f"{failed}")


def _full_width_requests(cfg, n=8, lo=16, hi=512, max_new=32):
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, n)
    return _requests([rng.integers(0, cfg.vocab_size, int(k)) for k in lens],
                     [max_new] * n)


def phase_lm_serve():
    """recurrentgemma-2b at full width: serve 8 requests."""
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = serve_engine.ServeEngine(cfg, params, batch=4, s_max=1024,
                                   device="cuda")
    eng.run(_requests([np.arange(16)] * 2, [2, 2]))          # warm-up

    captured, finite = {}, []
    real_scan, real_greedy = ops.rg_lru_scan, sampling.greedy

    def capture(a, b, h0=None):
        if not captured:
            captured.update(a=a.clone(), b=b.clone(),
                            h0=None if h0 is None else h0.clone())
        return real_scan(a, b, h0)

    def checked(logits):
        finite.append(torch.isfinite(logits).all())
        return real_greedy(logits)

    reqs = _full_width_requests(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.rg_lru_scan, sampling.greedy = capture, checked
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.rg_lru_scan, sampling.greedy = real_scan, real_greedy
    launches = ops.launch_counts()["rg_lru_scan"]
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats
    calls = st["admissions"] + st["decode_steps"]
    n_tok = sum(r.out.shape[0] for r in done)
    decode_tok = n_tok - st["admissions"]

    a, b, h0 = captured["a"], captured["b"], captured["h0"]
    if h0 is None:
        h0 = a.new_zeros((a.shape[0], a.shape[2]))
    layer0_equal = bit_equal(krg.rg_lru_scan(a, b, h0),
                             kref.rg_lru_scan(a, b, h0))
    all_finite = bool(torch.stack(finite).all())
    n_params = lm.param_count(params)
    emit({"phase": "lm_serve", "arch": LM_ARCH, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "params": n_params,
          "param_bytes": sum(w.numel() * w.element_size()
                             for w in params.parameters()),
          "init_s": init_s, "requests": len(done), "batch": eng.batch,
          "s_max": eng.s_max,
          "prompt_lens": [int(r.prompt.shape[0]) for r in done],
          "padded_prompt_len": st["prompt_tokens"] // st["admissions"],
          "tokens": n_tok, "wall_s": wall,
          "admissions": st["admissions"], "prefill_s": st["prefill_s"],
          "prefill_tokens_per_s": st["prompt_tokens"] / st["prefill_s"],
          "decode_steps": st["decode_steps"], "decode_s": st["decode_s"],
          "decode_ms_per_step": st["decode_s"] / st["decode_steps"] * 1e3,
          "decode_tokens_per_s": decode_tok / st["decode_s"],
          "tokens_per_s": n_tok / wall,
          "max_memory_allocated_bytes": peak,
          "rg_lru_scan_launches": launches,
          "expected_launches": _n_rg(cfg) * calls,
          "all_logits_finite": all_finite,
          "layer0_scan_shape": list(a.shape),
          "layer0_scan_bit_equal": layer0_equal})
    if not (all_finite and layer0_equal
            and launches == _n_rg(cfg) * calls):
        raise PhaseFailed("full-width serving failed its gates")
    return params, launches


def phase_lm_profile(params):
    """Device time by kernel over a short full-width serving run (4
    requests of 128 tokens, 8 new tokens each), and the device's idle
    share: 1 - device busy time (torch.profiler, device activity only)
    over the wall of the same run unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(LM_ARCH)
    eng = serve_engine.ServeEngine(cfg, params, batch=4, s_max=1024,
                                   device="cuda")
    reqs = lambda: _requests([np.arange(128) % cfg.vocab_size] * 4, [8] * 4)
    eng.run(reqs())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs())
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    rows = sorted(((us, k, c) for k, us, c in device_kernel_events(prof)),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    emit({"phase": "lm_profile", "wall_s": wall,
          "wall_profiled_s": wall_profiled, "stats": eng.stats,
          "device_busy_s": busy_us * 1e-6 if rows else None,
          "device_idle_share": (1.0 - busy_us * 1e-6 / wall) if rows
          else None,
          "top": [dict(name=k[:90], device_ms=us * 1e-3, calls=c)
                  for us, k, c in rows[:15]]})


#: the model functions whose device time the LM profiles split out, by
#: the label they get (each call runs inside `record_function(label)`; a
#: pair of labels names the call without and with a `kv_override`
#: argument: self- and cross-attention)
LM_MODULES = (("attention", "attention", "attention"),
              ("rglru", "recurrent", "rglru"),
              ("rwkv_time_mix", "recurrent", "rwkv_time_mix"),
              ("rwkv_channel_mix", "recurrent", "rwkv_channel_mix"),
              ("moe", "moe", "moe"), ("mlp", "mlp", "mlp"))
#: the enc-dec and `embeds` archs' split: the encoder whole (its layers'
#: attention and MLPs are also counted under their own labels), the
#: decoder's self-attention, its cross-attention, the MLPs
LM_ENCDEC_MODULES = (("encoder", "lm", "encode"),
                     (("self_attention", "cross_attention"), "attention",
                      "attention"),
                     ("mlp", "mlp", "mlp"))


def _labels(modules) -> set:
    return {x for label, _, _ in modules
            for x in ((label,) if isinstance(label, str) else label)}


@contextlib.contextmanager
def _labelled_modules(modules=LM_MODULES):
    """Run every function of `modules` inside a profiler label named for
    it (the model looks each up on its module at call time)."""
    from torch.profiler import record_function
    from repro_torch.models import attention, lm, mlp, moe, recurrent
    mods = dict(attention=attention, recurrent=recurrent, moe=moe, mlp=mlp,
                lm=lm)
    saved = []
    for label, mod, fn in modules:
        real = getattr(mods[mod], fn)

        def wrapped(*a, _real=real, _label=label, **kw):
            name = _label if isinstance(_label, str) else \
                _label["kv_override" in kw]
            with record_function(name):
                return _real(*a, **kw)
        saved.append((mods[mod], fn, real))
        setattr(mods[mod], fn, wrapped)
    try:
        yield
    finally:
        for mod, fn, real in saved:
            setattr(mod, fn, real)


def _profiled(fn, modules=LM_MODULES) -> dict:
    """Wall of fn() unprofiled, then the device's kernels over a second,
    profiled fn(): busy seconds, the idle share (1 - busy / the unprofiled
    wall), the device ms under each label of `modules`, and the top 12
    kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with _labelled_modules(modules), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    from torch.autograd import DeviceType
    labels = _labels(modules)
    avgs = prof.key_averages()
    # (the labels' own spans on the device timeline are not kernels)
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in avgs
                   if e.device_type == DeviceType.CUDA
                   and e.key not in labels), reverse=True)
    busy_us = sum(r[0] for r in rows)
    by_module = {e.key: e.device_time_total * 1e-3 for e in avgs
                 if e.key in labels and e.device_type == DeviceType.CPU}
    return dict(wall_s=wall, wall_profiled_s=wall_profiled,
                device_busy_s=busy_us * 1e-6 if rows else None,
                device_idle_share=(1.0 - busy_us * 1e-6 / wall) if rows
                else None,
                module_device_ms=by_module,
                top=[dict(name=k[:90], device_ms=us * 1e-3, calls=c)
                     for us, k, c in rows[:12]])


def _decode_profile(eng, cfg) -> dict:
    """LM_PROFILE_STEPS decode steps of a full batch at full width, each
    step's tokens read on the host as the engine does, profiled.  (A
    profiled step costs seconds of the profiler's own host work, so the
    steps are few.)"""
    B = eng.batch
    toks = torch.arange(LM_FAMILIES_PROMPTS[1], device="cuda")[None] \
        % cfg.vocab_size
    state = {"cache": lm.init_cache(cfg, B, eng.s_max, per_slot=True,
                                    device="cuda")}
    for b in range(B):
        _, state["cache"] = eng.prefill_slot(state["cache"], toks, b)
    state["cur"] = torch.zeros((B, 1), dtype=torch.int64, device="cuda")

    def decode(n=LM_PROFILE_STEPS):
        for _ in range(n):
            logits, state["cache"] = eng.decode(state["cache"], state["cur"])
            tok = sampling.greedy(logits)
            tok.tolist()
            state["cur"] = tok[:, None]

    decode(2)                                        # warm-up
    dec = _profiled(decode)
    dec["steps"] = LM_PROFILE_STEPS
    dec["ms_per_step"] = dec["wall_s"] / LM_PROFILE_STEPS * 1e3
    return dec


def phase_lm_families_serve() -> None:
    """rwkv6-1.6b, granite-moe-3b-a800m and qwen3-0.6b at full width
    (bf16, the port's own init from a seeded CUDA generator): 8 requests
    through `ServeEngine(batch=4)`, one line an arch."""
    failed = []
    for arch, want_params in LM_FAMILIES_FULL.items():
        cfg = get_config(arch)
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = lm.init_params(cfg, gen, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eng = serve_engine.ServeEngine(cfg, params, batch=4,
                                       s_max=LM_FAMILIES_S_MAX,
                                       device="cuda")
        eng.run(_requests([np.arange(8)] * 2, [2, 2]))        # warm-up
        finite, real_greedy = [], sampling.greedy

        def checked(logits):
            finite.append(torch.isfinite(logits).all())
            return real_greedy(logits)

        lo, hi = LM_FAMILIES_PROMPTS
        reqs = _full_width_requests(cfg, lo=lo, hi=hi)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sampling.greedy = checked
        ops.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            done = eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            sampling.greedy = real_greedy
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated()
        st = eng.stats
        n_tok = sum(r.out.shape[0] for r in done)
        decode_tok = n_tok - st["admissions"]
        n_params = lm.param_count(params)
        param_bytes = sum(w.numel() * w.element_size()
                          for w in params.parameters())
        all_finite = bool(torch.stack(finite).all())
        t0 = time.perf_counter()
        dec = _decode_profile(eng, cfg)
        dec["seconds"] = time.perf_counter() - t0
        emit({"phase": "lm_families_serve", "arch": arch, "dtype": cfg.dtype,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size, "params": n_params,
              "params_expected": want_params, "param_bytes": param_bytes,
              "weight_read_floor_ms": param_bytes / PEAK_BYTES_PER_S * 1e3,
              "init_s": init_s, "requests": len(done), "batch": eng.batch,
              "s_max": eng.s_max,
              "prompt_lens": [int(r.prompt.shape[0]) for r in done],
              "padded_prompt_len": st["prompt_tokens"] // st["admissions"],
              "tokens": n_tok, "wall_s": wall,
              "admissions": st["admissions"], "prefill_s": st["prefill_s"],
              "prefill_tokens_per_s": st["prompt_tokens"] / st["prefill_s"],
              "decode_steps": st["decode_steps"], "decode_s": st["decode_s"],
              "decode_ms_per_step": st["decode_s"] / st["decode_steps"] * 1e3,
              "decode_tokens_per_s": decode_tok / st["decode_s"],
              "tokens_per_s": n_tok / wall,
              "max_memory_allocated_bytes": peak,
              "kernel_launches": launches,
              "all_logits_finite": all_finite,
              "decode_profile": dec})
        if not (all_finite and n_params == want_params and not launches):
            failed.append(arch)
        del params, eng
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed(f"full-width serving failed its gates: {failed}")


def _frontend_batch(cfg, fe: dict, device) -> dict:
    """A `frontend` entry's inputs (`lm_reference.json`): from
    `np.random.default_rng(inputs_seed)`, standard normals [batch, length,
    d_model] as float32, then for `enc_embeds` the prompt's tokens,
    integers(0, vocab_size, (batch, prompt_len))."""
    rng = np.random.default_rng(fe["inputs_seed"])
    x = rng.standard_normal((fe["batch"], fe["length"], cfg.d_model)).astype(
        np.float32)
    batch = {fe["input"]: torch.from_numpy(x).to(device)}
    if fe["input"] == "enc_embeds":
        batch["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (fe["batch"], fe["prompt_len"]))).to(device)
    return batch


def _frontend_against(ref: dict) -> tuple:
    """An arch's `frontend` entry on the card, fp32 and bf16: the port's
    prefill from the frontend input, then its decode steps fed the
    reference's greedy tokens.  (results by dtype, failed dtypes)."""
    fe = ref["frontend"]
    results, failed = {}, []
    for dtype, r in fe["variants"].items():
        cfg = get_smoke_config(ref["arch"]).scaled(dtype=dtype)
        params = convert.lm_params_from_jax(
            convert.numpy_params(cfg, ref["weights_seed"]), cfg, "cuda")
        ops.reset_launch_counts()
        got = serve_engine.lockstep_teacher_forced_logits(
            cfg, params, _frontend_batch(cfg, fe, "cuda"), r["tokens"],
            fe["s_max"])
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        err = max_abs_err(got, torch.tensor(r["teacher_forced_logits"]))
        res = dict(input=fe["input"], teacher_forced_max_abs_err=err,
                   tolerance=LM_TOL[dtype],
                   finite=bool(torch.isfinite(got).all()),
                   tokens_equal=got[:-1].argmax(-1).T.tolist() == r["tokens"],
                   kernel_launches=launches)
        if not (res["finite"] and err <= LM_TOL[dtype] and not launches
                and (res["tokens_equal"] or dtype != "float32")):
            failed.append(dtype)
        results[dtype] = res
    return results, failed


def phase_lm_frontends_check():
    """seamless-m4t-medium (enc-dec) and llava-next-34b (`embeds`) at
    SMOKE, fp32 and bf16, against their entries of the committed JAX
    reference: the serving engine's run as lm_check holds it, and the
    frontend's lockstep run.  One line an arch."""
    refs, failed = _lm_reference(), []
    for arch in LM_FRONTENDS_FULL:
        results, bad = _serve_against(refs[arch])
        fe, bad_fe = _frontend_against(refs[arch])
        emit({"phase": "lm_frontends_check", "arch": arch,
              "config": "SMOKE", "runs": results, "frontend": fe})
        failed += [f"{arch} {d}" for d in bad] + [
            f"{arch} {d} frontend" for d in bad_fe]
    if failed:
        raise PhaseFailed(f"LM serving differs from the JAX reference: "
                          f"{failed}")


def _lockstep_profiles(cfg, params, batch: dict, s_max: int) -> dict:
    """The device's idle share and its ms by LM_ENCDEC_MODULES label over
    a prefill of `batch` (the encoder's run included where the batch has
    `enc_embeds`) and over LM_PROFILE_STEPS lockstep decode steps after
    it, each step's tokens read on the host."""
    B = next(iter(batch.values())).shape[0]

    def prefill():
        cache = lm.init_cache(cfg, B, s_max, device="cuda")
        return lm.prefill(cfg, params, cache, batch)

    t0 = time.perf_counter()
    pre = _profiled(prefill, LM_ENCDEC_MODULES)
    pre["seconds"] = time.perf_counter() - t0
    logits, cache = prefill()
    state = {"cache": cache, "tok": logits.argmax(-1)[:, None]}

    def decode(n=LM_PROFILE_STEPS):
        for _ in range(n):
            lg, state["cache"] = lm.decode_step(cfg, params, state["cache"],
                                                state["tok"])
            tok = sampling.greedy(lg[:, 0])
            tok.tolist()
            state["tok"] = tok[:, None]

    decode(1)                                        # warm-up
    t0 = time.perf_counter()
    dec = _profiled(decode, LM_ENCDEC_MODULES)
    dec["seconds"] = time.perf_counter() - t0
    dec["steps"] = LM_PROFILE_STEPS
    dec["ms_per_step"] = dec["wall_s"] / LM_PROFILE_STEPS * 1e3
    return {"prefill_profile": pre, "decode_profile": dec}


def _lockstep_run(cfg, params, batch: dict, s_max: int, n_new: int,
                  enc_frames=None) -> dict:
    """The timed lockstep run at full width: the encoder over `enc_frames`
    (enc-dec: its output goes into the cache), `lm.prefill` of `batch`,
    then `n_new` greedy `lm.decode_step`s, each step's tokens read on the
    host; every sampled logit checked finite; the chunked attention calls
    of the prefill counted."""
    from repro_torch.models import attention
    B = next(iter(batch.values())).shape[0]
    T = next(iter(batch.values())).shape[1]
    finite, chunked = [], []
    real_chunked = attention._chunked_gqa

    def counted(*a, **kw):
        chunked.append(1)
        return real_chunked(*a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = {}
    enc_out = None
    if enc_frames is not None:
        t0 = time.perf_counter()
        enc_out = lm.encode(cfg, params, enc_frames)
        torch.cuda.synchronize()
        out["encode_ms"] = (time.perf_counter() - t0) * 1e3
        out["encode_frames"] = list(enc_frames.shape[:2])
    attention._chunked_gqa = counted
    try:
        t0 = time.perf_counter()
        cache = lm.init_cache(cfg, B, s_max, enc_out=enc_out, device="cuda")
        logits, cache = lm.prefill(cfg, params, cache, batch)
        finite.append(torch.isfinite(logits).all())
        tok = sampling.greedy(logits)
        tok.tolist()
        prefill_s = time.perf_counter() - t0
    finally:
        attention._chunked_gqa = real_chunked
    t0 = time.perf_counter()
    for _ in range(n_new):
        logits, cache = lm.decode_step(cfg, params, cache, tok[:, None])
        finite.append(torch.isfinite(logits).all())
        tok = sampling.greedy(logits[:, 0])
        tok.tolist()
    decode_s = time.perf_counter() - t0
    out.update(prompt=[B, T], prefill_s=prefill_s,
               prefill_tokens_per_s=B * T / prefill_s,
               prefill_chunked_attention_calls=len(chunked),
               decode_steps=n_new, decode_s=decode_s,
               decode_ms_per_step=decode_s / n_new * 1e3,
               decode_tokens_per_s=B * n_new / decode_s,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               kernel_launches={k: v for k, v in
                                ops.launch_counts().items() if v},
               all_logits_finite=bool(torch.stack(finite).all()))
    return out


def _init_full(arch: str) -> tuple:
    """The arch at full width from a seeded CUDA generator: (cfg, params,
    generator, the line's common fields)."""
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    meta = lm.init_params(cfg, device="meta")
    need = sum(w.numel() * w.element_size() for w in meta.parameters())
    if need > free:
        raise PhaseFailed(f"{arch}: {need} B of weights, {free} B free of "
                          f"{total} on the card")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(params)
    param_bytes = sum(w.numel() * w.element_size()
                      for w in params.parameters())
    dec_bytes = param_bytes - (sum(
        w.numel() * w.element_size() for w in params.enc_stack.parameters())
        if cfg.family == "encdec" else 0)
    line = {"arch": arch, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "encoder_layers": cfg.n_encoder_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "params": n_params,
            "params_expected": LM_FRONTENDS_FULL[arch],
            "param_bytes": param_bytes, "mem_free_before_init_bytes": free,
            "mem_total_bytes": total, "init_s": init_s,
            "weight_read_floor_ms": param_bytes / PEAK_BYTES_PER_S * 1e3,
            "decoder_weight_read_floor_ms": dec_bytes / PEAK_BYTES_PER_S
            * 1e3}
    return cfg, params, gen, line


def _seamless_full() -> dict:
    """seamless-m4t-medium at full width: the encoder over B x S frames,
    a lockstep prefill of prompts of 8-24 tokens from the cache's
    encoder output, 32 greedy decode steps; then ServeEngine with 8
    requests; then the profiles."""
    arch = "seamless-m4t-medium"
    cfg, params, gen, line = _init_full(arch)
    B, S = SEAMLESS_FRAMES
    frames = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    lo, hi = LM_FAMILIES_PROMPTS
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, B)
    toks = np.zeros((B, int(lens.max())), np.int64)
    for b, n in enumerate(lens):
        toks[b, toks.shape[1] - n:] = rng.integers(0, cfg.vocab_size, n)
    batch = {"tokens": torch.from_numpy(toks).to("cuda")}
    s_max = toks.shape[1] + FRONTEND_NEW + 2 * LM_PROFILE_STEPS + 1
    _lockstep_run(cfg, params, {"tokens": batch["tokens"][:, :4]}, 8, 1,
                  enc_frames=frames[:, :16])                  # warm-up
    line["prompt_lens"] = lens.tolist()
    line["lockstep"] = _lockstep_run(cfg, params, batch, s_max,
                                     FRONTEND_NEW, enc_frames=frames)
    t0 = time.perf_counter()

    eng = serve_engine.ServeEngine(cfg, params, batch=4,
                                   s_max=LM_FAMILIES_S_MAX, device="cuda")
    eng.run(_requests([np.arange(8)] * 2, [2, 2]))            # warm-up
    finite, real_greedy = [], sampling.greedy

    def checked(logits):
        finite.append(torch.isfinite(logits).all())
        return real_greedy(logits)

    reqs = _full_width_requests(cfg, lo=lo, hi=hi)
    torch.cuda.synchronize()
    sampling.greedy = checked
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sampling.greedy = real_greedy
    st = eng.stats
    n_tok = sum(r.out.shape[0] for r in done)
    line["serve_engine"] = dict(
        requests=len(done), batch=eng.batch, s_max=eng.s_max,
        prompt_lens=[int(r.prompt.shape[0]) for r in done], tokens=n_tok,
        wall_s=wall, admissions=st["admissions"],
        prefill_tokens_per_s=st["prompt_tokens"] / st["prefill_s"],
        decode_steps=st["decode_steps"],
        decode_ms_per_step=st["decode_s"] / st["decode_steps"] * 1e3,
        decode_tokens_per_s=(n_tok - st["admissions"]) / st["decode_s"],
        kernel_launches={k: v for k, v in ops.launch_counts().items() if v},
        all_logits_finite=bool(torch.stack(finite).all()),
        enc_out=None, seconds=time.perf_counter() - t0)
    line.update(_lockstep_profiles(
        cfg, params, dict(batch, enc_embeds=frames), s_max))
    return line


def _llava_full() -> dict:
    """llava-next-34b at full width: batch 2, a prompt of `embeds`
    positions (the chunked attention path), then 32 greedy lockstep
    decode steps; then the profiles."""
    arch = "llava-next-34b"
    cfg, params, gen, line = _init_full(arch)
    B, T = LLAVA_PROMPT
    embeds = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda")
    _lockstep_run(cfg, params, {"embeds": embeds[:, :16]}, 17, 1)  # warm-up
    t0 = time.perf_counter()
    line["lockstep"] = _lockstep_run(cfg, params, {"embeds": embeds},
                                     LLAVA_S_MAX, FRONTEND_NEW)
    line["lockstep"]["seconds"] = time.perf_counter() - t0
    line.update(_lockstep_profiles(cfg, params, {"embeds": embeds},
                                   LLAVA_S_MAX))
    return line


def phase_lm_frontends_serve() -> None:
    """seamless-m4t-medium and llava-next-34b at full width (bf16, the
    port's own init from a seeded CUDA generator; frames and patch
    embeddings from it too, their frontends being stubs): one line an
    arch, each freed before the next."""
    failed = []
    for run in (_seamless_full, _llava_full):
        t0 = time.perf_counter()
        line = run()
        line["seconds"] = time.perf_counter() - t0
        emit(dict({"phase": "lm_frontends_serve"}, **line))
        runs = [line["lockstep"]] + ([line["serve_engine"]]
                                     if "serve_engine" in line else [])
        ok = (line["params"] == line["params_expected"]
              and all(r["all_logits_finite"] and not r["kernel_launches"]
                      for r in runs))
        if line["arch"] == "llava-next-34b":
            ok &= line["lockstep"]["prefill_chunked_attention_calls"] == \
                line["layers"]
        if not ok:
            failed.append(line["arch"])
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed(f"full-width frontend serving failed its gates: "
                          f"{failed}")


# ----------------------------------------------------------------------------
# streamed connectivity
# ----------------------------------------------------------------------------


def _stream_program(cfg, chunk: int, h: int = 1, placement: str = "block"):
    """The streamed program of (cfg, K = chunk) on the card: its plan is
    built on the card (`stream_engine.build`'s chunk counts)."""
    return StepProgram(cfg, EngineConfig(
        n_shards=h, placement=placement,
        connectivity=f"streamed:chunk={chunk}"), device="cuda")


def _stream_counts(steps: int, n_chunks: int) -> dict:
    """A streamed run's launches: per step and chunk, chunk_tables twice,
    the phase-A row kernel and the element walk once; every other SNN
    kernel never."""
    return dict(dict.fromkeys(_snn_counted(), 0),
                chunk_tables=2 * n_chunks * steps,
                stdp_phase_a_chunk=n_chunks * steps,
                arborize_chunk=n_chunks * steps)


def _program_bytes(*trees) -> int:
    """Device bytes of the tensors of NamedTuples of tensors."""
    return sum(nbytes(x) for t in trees for x in engine.state_tensors(t)
               if isinstance(x, torch.Tensor) and x.is_cuda)


def _chunk_tables_ops(source, c: int, tables, kept) -> tuple:
    """(integer operations of the least work, of the reference's draw
    order, bytes, shape) of one chunk_tables call on these inputs, at
    SPLITMIX_OPS a draw lane.  Least work: lane 0 on every excitatory
    slot, lane 2 on every inhibitory one, lane 1 on the slots whose ring
    can reach the chunk and lane 2 on those whose target column lies in
    it (`kref.chunk_prefilter` on this chunk), lane 3 on each kept
    excitatory synapse.  The reference's draw order: lanes 0-2 on every
    excitatory slot, lane 2 on every inhibitory one, lane 3 on each kept
    excitatory synapse.  Bytes: the candidates read, their gids gathered,
    the tables written."""
    g = source.geom
    cand = source.cand[:, c].to(torch.int64)
    ok = cand >= 0
    gid = torch.gather(source.src_gid, 1, torch.where(ok, cand, 0))
    exc = ok & (gid % g.npc < g.nexc)
    n_exc, n_inh = int(exc.sum()), int((ok & ~exc).sum())
    kept_exc = sum(int(tables.plastic[h, :k].sum())
                   for h, k in enumerate(kept))
    pf = kref.chunk_prefilter(source, c)
    excm = exc[:, :, None]
    lane1 = int((pf.lane0 & excm).sum())
    lane2_exc = int((pf.lane1 & excm).sum())
    del pf
    lanes = g.M * (n_exc + n_inh) + lane1 + lane2_exc + kept_exc
    ops_ = SPLITMIX_OPS * lanes
    draw_order_ops = SPLITMIX_OPS * (g.M * (3 * n_exc + n_inh) + kept_exc)
    n_bytes = (nbytes(source.cand[:, c]) + int(ok.sum()) * 8
               + sum(kept) * (4 + 4 + 1) + nbytes(tables.row_ptr))
    exc_slots = max(g.M * n_exc, 1)
    return ops_, draw_order_ops, n_bytes, dict(
        candidates=int(ok.sum()), slots=int(ok.sum()) * g.M,
        kept=sum(kept), kept_excitatory=kept_exc, lanes=lanes,
        lane1_draws=lane1, lane2_excitatory_draws=lane2_exc,
        prefilter_lane0_share_of_excitatory=lane1 / exc_slots,
        prefilter_lane1_share_of_excitatory=lane2_exc / exc_slots,
        prefilter_lane1_share=(lane2_exc + g.M * n_inh)
        / max(int(ok.sum()) * g.M, 1))


def _chunk_tables_rows(sp8s, sp4r) -> tuple:
    """`chunk_tables` on the 8x8 streamed plan's first, an interior and
    the last chunk, and the last (ragged) chunk of a 4x4 K = 3 plan at H =
    4: bit-equal (row pointers, and each shard's kept entries) to the plain
    version on the card and, for the interior and the ragged chunk, on a
    CPU copy; its flag clear.  Timed beside its plain version, stage by
    stage (CHUNK_KERNELS; a stage that reads no device time fails), and
    beside two bounds (operations: the draw lanes at the int32 issue
    rate): the least work and the reference's draw order
    (`_chunk_tables_ops`)."""
    rows, failed = [], []
    n8 = sp8s.spec.stream.n_chunks
    cases = [("first", sp8s, 0), ("interior", sp8s, n8 // 2),
             ("last", sp8s, n8 - 1),
             ("ragged_k3", sp4r, sp4r.spec.stream.n_chunks - 1)]
    for label, sp, c in cases:
        live = stream_engine.ChunkStream(sp.spec, sp.plan, sp.splan)
        src, K = live.source, live.tables.src.shape[1]
        got = live.regenerate(c)
        torch.cuda.synchronize()
        want_gpu = kref.chunk_tables(src, c, K)
        want = [want_gpu]
        if label in ("interior", "ragged_k3"):
            src_cpu = kref.ChunkSource(*(x.cpu() if isinstance(
                x, torch.Tensor) else x for x in src))
            want.append(kref.chunk_tables(src_cpu, c, K))
        kept = (want_gpu.row_ptr[:, -1] - want_gpu.row_ptr[:, 0]).tolist()
        equal = int(live.status[0]) == 0
        for w in want:
            equal &= bit_equal(got.row_ptr, w.row_ptr)
            for h, e in enumerate(kept):
                equal &= all(bit_equal(a[h, :e], b[h, :e])
                             for a, b in zip(got[1:], w[1:]))
        if not equal:
            failed.append(f"chunk_tables ({label})")
        n_ops, draw_ops, n_bytes, shape = _chunk_tables_ops(src, c, got,
                                                            kept)
        bms, by = bound(n_bytes, n_ops, PEAK_INT32_PER_S)
        launch = lambda: live.regenerate(c)
        by_kernel = {k: device_ms(launch, kernel=k) for k in CHUNK_KERNELS}
        if not all(by_kernel.values()):
            failed.append(f"chunk_tables ({label}): a stage read no device "
                          f"time: {by_kernel}")
        rows.append(dict(
            name="chunk_tables", route="cuda",
            source="src/repro_torch/csrc/stream.cu",
            replaces="src/repro/core/stream_engine.py:172", launches=None,
            max_abs_err=0.0 if equal else float("nan"),
            ms=cuda_ms(launch), device_ms=device_ms(
                launch, kernel=CHUNK_KERNELS),
            device_ms_by_kernel=by_kernel,
            plain_ms=cuda_ms(lambda: kref.chunk_tables(src, c, K), calls=2,
                             reps=3, warmup=1),
            bound_ms=bms, bound_by=by,
            bound_note=f"operations, the least work: {SPLITMIX_OPS} integer "
                       f"instructions a splitmix64 lane (counted in the "
                       f"SASS), lane 0 on every excitatory slot, lane 2 on "
                       f"every inhibitory one, lanes 1 and 2 where the "
                       f"prefilter passes, lane 3 a kept excitatory "
                       f"synapse, at the int32 issue rate "
                       f"{PEAK_INT32_PER_S:.4g}/s",
            draw_order_bound_ms=bound(n_bytes, draw_ops,
                                      PEAK_INT32_PER_S)[0],
            draw_order_note="the reference's draw order: lanes 0-2 on every "
                            "excitatory slot, as a thread a slot draws them",
            ops=n_ops, draw_order_ops=draw_ops, bytes=n_bytes,
            library_ms=None,
            library_note="no PyTorch call regenerates the tables",
            equal=equal, status=int(live.status[0]),
            tolerance="bit-equal (row pointers and every kept entry) to the "
                      "plain version on the card"
                      + (" and on a CPU copy" if len(want) > 1 else ""),
            density="main" if label == "interior" else label,
            shape=dict(shape, chunk=c, H=sp.spec.eng.n_shards,
                       K=sp.spec.stream.chunk_cols, q=sp.spec.stream.q,
                       c_cap=sp.spec.stream.c_cap, live_width=K)))
        del live, got, want, want_gpu
    return rows, failed


def _window_rows(sp8s) -> tuple:
    """The chunk windows of the phase-A row kernel (with LTP, as `run`
    calls it, t from the step counter), of LTP (`stdp_ltp_chunk`) and of
    the element walk (`arborize_chunk`, t from the counter) on the 8x8
    streamed plan's interior chunk, its synapses' flags and the neurons'
    spikes drawn at the main density: bit-equal (the whole state, the
    spikes and counts) to their plain versions on a CPU copy, timed on
    restored inputs beside their plain versions on the card and bounds
    from the bytes these inputs make them move."""
    spec, plan, splan = sp8s.spec, sp8s.plan, sp8s.splan
    H, N = plan.gid.shape
    D = spec.cfg.n_delay_slots
    ss = spec.stream
    c = ss.n_chunks // 2
    lo = c * ss.q
    live = stream_engine.ChunkStream(spec, plan, splan)
    tb = live.regenerate(c)
    tb_cpu = kref.ChunkTables(*(x.cpu() for x in tb))
    e0 = int(tb_cpu.row_ptr[0, 0])
    kept = int(tb_cpu.row_ptr[0, -1]) - e0
    t = 1003
    rng = np.random.default_rng(2023)
    state = sp8s.init_state()
    E = state.w.shape[1]
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    ring = np.zeros((H, D, E), bool)
    ring[:, :, e0:e0 + kept] = rng.random((H, D, kept)) < STDP_DENSITY
    times = lambda shape: f(np.where(rng.random(shape) < 0.7,
                                     rng.uniform(t - 2000.0, t, shape),
                                     -1.0e9))
    cpu = dict(ring=torch.from_numpy(ring),
               w=f(rng.uniform(0, 10, (H, E))), last_arr=times((H, E)),
               last_post=times((H, N)),
               v=f(np.where(rng.random((H, N)) < STDP_DENSITY, 35.0,
                            rng.uniform(-80.0, 0.0, (H, N)))),
               u=f(rng.uniform(-20.0, 10.0, (H, N))),
               spiked=torch.from_numpy(rng.random((H, N)) < STDP_DENSITY),
               spiked_src=torch.from_numpy(
                   rng.random(tuple(plan.src_gid.shape)) < STDP_DENSITY),
               out=torch.zeros((H, N), dtype=torch.bool),
               counts=torch.zeros((2, H), dtype=torch.int64),
               ctr=torch.tensor([t, 0], dtype=torch.int64))
    index, amp = engine.stim_rows(spec, plan, t, 1)
    cpu.update(stim_idx=index.cpu(), stim_amp=amp.cpu())
    gpu = {k: v.cuda() for k, v in cpu.items()}
    exc, nv = plan.exc_mask, plan.neuron_valid
    kw = dict(izh=spec.izh, stdp=spec.stdp, neg_time=engine.NEG_TIME)
    ltp_kw = dict(a_plus=spec.stdp.a_plus, tau_plus=spec.stdp.tau_plus,
                  w_min=spec.stdp.w_min, w_max=spec.stdp.w_max,
                  neg_time=engine.NEG_TIME)

    def phase_a(d, tables, counter: bool):
        step = d["ctr"] if counter else t
        stim = ((d["stim_idx"], d["stim_amp"]) if counter else
                (d["stim_idx"][0], d["stim_amp"][0]))
        ops.stdp_phase_a_chunk(
            d["ring"], None if counter else t % D, tables, lo,
            exc.to(d["w"].device), nv.to(d["w"].device), *stim, d["v"],
            d["u"], d["last_post"], d["w"], d["last_arr"], step, d["out"],
            d["counts"], accumulate=False, with_ltp=True, **kw)

    def ltp(d, tables):
        ops.stdp_ltp_chunk(d["spiked"], tables, lo, d["last_arr"], d["w"],
                           d["last_post"], t, **ltp_kw)

    def arb(d, tables, counter: bool):
        ops.arborize_chunk(d["ring"], d["spiked_src"], tables,
                           d["ctr"] if counter else t)

    keys = ("ring", "w", "last_arr", "last_post", "v", "u", "out",
            "counts")
    rows, failed = [], []
    cases = (("stdp_phase_a_chunk", phase_a, True,
              "src/repro/kernels/izhikevich.py:37, src/repro/kernels/"
              "stdp.py:57, src/repro/kernels/stdp.py:81",
              "row_kernel<true, true>", "src/repro_torch/csrc/stdp.cu"),
             ("stdp_ltp_chunk", ltp, None, "src/repro/kernels/stdp.py:81",
              "ltp_kernel<true>", "src/repro_torch/csrc/stdp.cu"),
             ("arborize_chunk", arb, True,
              "src/repro/core/stream_engine.py:389", "arborize_chunk",
              "src/repro_torch/csrc/arborize.cu"))
    for name, fn, counter, replaces, kname, source in cases:
        args = (counter,) if counter is not None else ()
        g = {k: v.clone() for k, v in gpu.items()}
        fn(g, tb, *args)
        torch.cuda.synchronize()
        w = {k: v.clone() for k, v in cpu.items()}
        with kref.flush_denormal():
            fn(w, tb_cpu, *((False,) if counter else ()))
        equal = all(bit_equal(g[k], w[k]) for k in keys)
        err = max(max_abs_err(g[k], w[k]) for k in keys if k != "ring")
        if not equal:
            failed.append(name)
        # bytes these inputs make it move
        rp = tb_cpu.row_ptr[0].to(torch.int64)
        rows_n = min(ss.q, N - lo)
        spk_rows = torch.nonzero(w["out"][0, lo:lo + rows_n] if name
                                 == "stdp_phase_a_chunk" else
                                 cpu["spiked"][0, lo:lo + rows_n]).reshape(-1)
        syn_spk = int((rp[spk_rows + 1] - rp[spk_rows]).sum())
        arrived = int(cpu["ring"][0, t % D, e0:e0 + kept].sum())
        active = int(cpu["spiked_src"][0][tb_cpu.src[0, :kept].long()].sum())
        if name == "stdp_phase_a_chunk":
            n_bytes = (kept + (ss.q + 1) * 4 + rows_n * 19
                       + arrived * (1 + 4 + 4 + 1 + 4)
                       + spk_rows.numel() * 8 + syn_spk * 13)
        elif name == "stdp_ltp_chunk":
            n_bytes = rows_n + spk_rows.numel() * 8 + syn_spk * 13
        else:
            n_bytes = (ss.q + 1) * 4 + kept * (4 + 4) + active * 1
        bms, by = bound(n_bytes, 0)
        restore = lambda: [g[k].copy_(gpu[k]) for k in keys]
        launch = lambda: fn(g, tb, *args)
        plain = lambda: fn(g, tb, *((False,) if counter else ()))
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=None, max_abs_err=err,
            ms=in_place_ms(launch, restore),
            device_ms=device_ms(launch, restore=restore, kernel=kname.split(
                "<")[0]),
            plain_ms=None, bound_ms=bms, bound_by=by, library_ms=None,
            library_note="no PyTorch call does it", equal=equal,
            tolerance="bit-equal (ring, w, last_arr, last_post, v, u, spikes "
                      "and counts) to the plain version on a CPU copy",
            kernel=kname, density="main", bytes=n_bytes,
            shape=dict(chunk=c, rows=rows_n, kept=kept, arrived=arrived,
                       spiking_rows=int(spk_rows.numel()),
                       synapses_of_spiking=syn_spk, active=active, t=t)))
        # the plain version on the card (the same ops on CUDA tensors)
        rows[-1]["plain_ms"] = _plain_on_card_ms(name, g, tb, lo, t, D, exc,
                                                 nv, kw, ltp_kw, restore)
        del g, w
    return rows, failed


def _plain_on_card_ms(name, g, tb, lo, t, D, exc, nv, kw, ltp_kw, restore):
    """The plain version's ms on the card, on restored inputs (its ops on
    CUDA tensors; t an int)."""
    if name == "stdp_phase_a_chunk":
        fn = lambda: kref.stdp_phase_a_chunk(
            g["ring"], t % D, tb, lo, exc, nv, g["stim_idx"][0],
            g["stim_amp"][0], g["v"], g["u"], g["last_post"], g["w"],
            g["last_arr"], t, g["out"], g["counts"], accumulate=False,
            with_ltp=True, **kw)
    elif name == "stdp_ltp_chunk":
        fn = lambda: kref.stdp_ltp_chunk(g["spiked"], tb, lo, g["last_arr"],
                                         g["w"], g["last_post"], t, **ltp_kw)
    else:
        fn = lambda: kref.arborize_chunk(g["ring"], g["spiked_src"], tb, t)
    return in_place_ms(fn, restore, calls=3, warmup=1)


#: Row S's device ms at the 8x8 interior chunk before the kernel took the
#: rows' shard ids (run XF3, isolated; H100 80GB HBM3, 700 W)
ROW_S_XF3_DEVICE_MS = 0.0402743
SHARD_ID_ROWS = (2, 3)      # the block of the [shard_id] row, of 4 shards


def _shard_id_row(sp8x) -> tuple:
    """`chunk_tables` on a block of scatter rows named by their shard ids
    (SHARD_ID_ROWS of the 8x8 streamed plan at H = 4, scatter, K = 1, as
    a rank of two holds them), at the interior chunk: bit-equal to its
    plain version on the card and to those rows of the all-shard plain
    call, flag clear; timed beside its plain version and its bound
    (`_chunk_tables_ops`)."""
    ss = sp8x.spec.stream
    idx = torch.tensor(SHARD_ID_ROWS, device="cuda")
    full = stream_engine.chunk_source(sp8x.spec, sp8x.plan, sp8x.splan)
    src = stream_engine.make_chunk_source(
        sp8x.spec.cfg, sp8x.spec.eng, ss.q, sp8x.plan.src_gid[idx],
        sp8x.splan.cand[idx], sp8x.splan.e_start[idx], ss.row_cap,
        shard_id=sp8x.plan.shard_id[idx])
    K = stream_engine.live_width(sp8x.splan)
    z = lambda n, dt: torch.zeros((len(SHARD_ID_ROWS), n), dtype=dt,
                                  device="cuda")
    tables = kref.ChunkTables(row_ptr=z(ss.q + 1, torch.int32),
                              src=z(K, torch.int32), delay=z(K, torch.int32),
                              plastic=z(K, torch.bool))
    status = torch.zeros(1, dtype=torch.int32, device="cuda")
    c = ss.n_chunks // 2
    launch = lambda: ops.chunk_tables(src, c, tables, status)
    got = launch()
    torch.cuda.synchronize()
    want = kref.chunk_tables(src, c, K)
    whole = kref.chunk_tables(full, c, K)
    kept = (want.row_ptr[:, -1] - want.row_ptr[:, 0]).tolist()
    equal = (int(status[0]) == 0 and min(kept) > 0
             and bit_equal(got.row_ptr, want.row_ptr)
             and bit_equal(want.row_ptr, whole.row_ptr[idx]))
    for i, (h, e) in enumerate(zip(SHARD_ID_ROWS, kept)):
        equal &= all(bit_equal(a[i, :e], b[i, :e]) and
                     bit_equal(b[i, :e], w[h, :e])
                     for a, b, w in zip(got[1:], want[1:], whole[1:]))
    n_ops, _, n_bytes, shape = _chunk_tables_ops(src, c, got, kept)
    bms, by = bound(n_bytes, n_ops, PEAK_INT32_PER_S)
    row = dict(
        name="chunk_tables[shard_id]", route="cuda",
        source="src/repro_torch/csrc/stream.cu",
        replaces="src/repro/core/stream_engine.py:172", launches=None,
        max_abs_err=0.0 if equal else float("nan"),
        ms=cuda_ms(launch),
        device_ms=device_ms(launch, kernel=CHUNK_KERNELS),
        plain_ms=cuda_ms(lambda: kref.chunk_tables(src, c, K), calls=2,
                         reps=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        library_note="no PyTorch call regenerates the tables",
        equal=equal, status=int(status[0]),
        tolerance="bit-equal (row pointers and every kept entry) to the "
                  "plain version on the card and to those rows of the "
                  "all-shard plain call",
        shape=dict(shape, chunk=c, H=4, rows=list(SHARD_ID_ROWS),
                   placement="scatter", K=ss.chunk_cols, q=ss.q,
                   c_cap=ss.c_cap, live_width=K))
    return row, [] if equal else ["chunk_tables[shard_id]"]


def phase_stream_kernels(sp8s):
    """`chunk_tables` and the chunk-window kernels against their plain
    versions (`_chunk_tables_rows`, `_window_rows`), and the shard-id form
    of `chunk_tables` on a block of scatter rows (`_shard_id_row`, on the
    8x8 streamed plan at H = 4, scatter); returns the rows of the
    `kernels` line (chunk_tables at the 8x8 interior chunk, its shard-id
    form, the windows).  Row S's device ms is printed beside run XF3's."""
    t0 = time.perf_counter()
    sp4r = _stream_program(GridConfig(grid_x=4, grid_y=4), 3, 4, "block")
    build_s = time.perf_counter() - t0
    rows, failed = _chunk_tables_rows(sp8s, sp4r)
    del sp4r
    t0 = time.perf_counter()
    sp8x = _stream_program(GridConfig(grid_x=8, grid_y=8), 1, 4, "scatter")
    scatter_build_s = time.perf_counter() - t0
    sid_row, sid_failed = _shard_id_row(sp8x)
    del sp8x
    sid_row["density"] = "main"
    rows.append(sid_row)
    failed += sid_failed
    w_rows, w_failed = _window_rows(sp8s)
    rows += w_rows
    failed += w_failed
    row_s = next(r for r in rows if r["name"] == "chunk_tables"
                 and r.get("density") == "main")
    emit({"phase": "stream_kernels", "ragged_plan_build_s": build_s,
          "scatter_plan_build_s": scatter_build_s,
          "row_s_device_ms": row_s["device_ms"],
          "row_s_xf3_device_ms": ROW_S_XF3_DEVICE_MS,
          "row_s_vs_xf3": (row_s["device_ms"] / ROW_S_XF3_DEVICE_MS
                           if row_s["device_ms"] else None),
          "stream_ptxas": _inspect("stream.cu")["ptxas"],
          "rows": rows})
    if failed:
        raise PhaseFailed(f"streamed kernels differ from their plain "
                          f"versions: {failed}")
    return [r for r in rows if r.get("density") == "main"]


def _host_build_equal(sp) -> dict:
    """The reference's host builder (`connectivity.build_all_streamed`,
    numpy) on sp's configuration, timed, against the plan and initial
    weights `stream_engine.build` made on the card."""
    t0 = time.perf_counter()
    shards = connectivity.build_all_streamed(
        sp.spec.cfg, sp.spec.eng, sp.spec.stream.chunk_cols)
    seconds = time.perf_counter() - t0
    w = sp.init_state().w.cpu().numpy()
    e_start = sp.splan.e_start.cpu().numpy()
    equal = all(
        np.array_equal(e_start[h], s.e_start)
        and np.array_equal(sp.splan.cand[h].cpu().numpy(), s.cand)
        and np.array_equal(sp.plan.src_gid[h].cpu().numpy(), s.src_gid)
        and np.array_equal(w[h, :s.n_valid], s.weight0)
        and not w[h, s.n_valid:].any() for h, s in enumerate(shards))
    return dict(equal=equal, host_builder_s=seconds)


def phase_stream_check():
    """Streamed connectivity at 4x4 full width, 150 steps, K = 1 and K = 3
    (at H = 4 a shard owns 4 columns: the last chunk is ragged), three
    layouts: the captured graph's run, a second run (replays only) and the
    eager loop give the same bits, and the raster and weight signatures
    of the committed JAX reference's (materialized) runs, the modes being
    bit-identical; each chunk regenerated twice a step, the phase-A row
    kernel and the element walk once a chunk, no other SNN kernel; the
    flag clear; a whole run of replays under sync-debug "error"."""
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    cfg = GridConfig(**ref["grid"],
                     neurons_per_column=ref["neurons_per_column"],
                     synapses_per_neuron=ref["synapses_per_neuron"])
    steps = ref["steps"]
    results, failed = {}, []
    for chunk in STREAM_CHECK_CHUNKS:
        for name, r in ref["runs"].items():
            key = f"k{chunk}_{name}"
            t0 = time.perf_counter()
            sp = _stream_program(cfg, chunk, r["n_shards"], r["placement"])
            build_s = time.perf_counter() - t0
            host = None
            if (chunk, name) == (1, "h1_block"):
                host = _host_build_equal(sp)
            state0 = sp.init_state()
            t0 = time.perf_counter()
            first, graph_counts = _counted_run(sp, state0, steps, True)
            wall = time.perf_counter() - t0
            rsig, wsig, raster_np = _signatures(sp, first[0], first[1])
            per_step = raster_np.sum(axis=(1, 2)).astype(int)
            replayed = sp.run(state0, 0, steps)
            eager, counts = _counted_run(sp, state0, steps, False)
            torch.cuda.synchronize()
            status = int(sp.runner.chunks.status[0])
            same = _same_run(first, replayed) and _same_run(first, eager)
            want = _stream_counts(steps, sp.spec.stream.n_chunks)
            ok = (rsig == r["raster_signature"]
                  and wsig == r["weight_signature"]
                  and counts["counted"] == want
                  and graph_counts["total"] == want and same and status == 0)
            err = _graph_replays_sync_debug(sp, state0, 0, steps)
            res = dict(raster_equal=rsig == r["raster_signature"],
                       weights_equal=wsig == r["weight_signature"],
                       graph_equal_to_replays_and_eager=same, status=status,
                       spikes=int(per_step.sum()),
                       n_chunks=sp.spec.stream.n_chunks,
                       live_width=sp.runner.chunks.tables.src.shape[1],
                       launches=counts["counted"],
                       graph_launches=graph_counts, wall_s=wall,
                       build_s=build_s, host_build=host,
                       graph_replays_sync_debug_error=err)
            if host is not None and not host["equal"]:
                failed.append(f"{key} (the card's build differs from the "
                              f"host builder's)")
            if not ok:
                failed.append(key)
                res["first_step_spike_count_differs"] = _first_divergence(
                    per_step, np.asarray(r["spikes_per_step"]))
            if err is not None:
                failed.append(f"{key} (graph replays, sync-debug)")
            results[key] = res
            del sp, first, replayed, eager
            torch.cuda.empty_cache()
    emit({"phase": "stream_check", "grid": "4x4", "steps": steps,
          "chunks": list(STREAM_CHECK_CHUNKS), "runs": results})
    if failed:
        raise PhaseFailed(f"the streamed path differs from the JAX "
                          f"reference: {failed}")


def phase_stream_timed(sp8s, sp8, build_s: float):
    """The streamed 8x8 program (K = 1, H = 1, 64 chunks), STREAM_STEPS
    steps after a warm-up that captures the graph, as the graph's run and
    as the eager loop (the same bits): ms a step, the capture's seconds,
    launches, device busy, operations a step and idle share over the graph
    run (torch.profiler), and device memory beside the materialized
    program's (sp8, this script's dense 8x8 program): the program's own
    bytes (plan, streamed plan, state, live tables) and the run's peak
    above what was allocated before it.  Returns the eager run's launches
    of the streamed kernels."""
    from torch.profiler import ProfilerActivity, profile
    cfg = sp8s.spec.cfg
    n_chunks = sp8s.spec.stream.n_chunks
    state0 = sp8s.init_state()
    W = engine.RUN_WINDOW
    runs = {}
    for mode in ("graph", "eager"):
        graph = mode == "graph"
        sp8s.run(state0, 0, 2 * W, graph=graph)     # warm (and capture)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, counts = _counted_run(sp8s, state0, STREAM_STEPS, graph)
        wall = time.perf_counter() - t0
        runs[mode] = dict(out=out, wall=wall, counts=counts,
                          peak_above=torch.cuda.max_memory_allocated() - base)
    runner = sp8s.runner
    sp8s.runner.chunks.check()
    # the capture alone: the same window's steps captured again
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (torch.cuda.stream(runner.stream),
          _build.own_scratch(runner.scratch)):
        runner._capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    same = _same_run(runs["graph"]["out"], runs["eager"]["out"])
    sp8s.run(state0, 0, STREAM_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        c0 = time.perf_counter()
        sp8s.run(state0, 0, STREAM_STEPS)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - c0
    ev = sorted(((us, k, c) for k, us, c in device_kernel_events(prof)),
                reverse=True)
    busy_us = sum(e[0] for e in ev)
    g = runs["graph"]["out"]
    raster_np = g[1].cpu().numpy()
    rate = observables.mean_rate_hz(raster_np, cfg.n_neurons)
    dense_state = sp8.init_state()
    dense = sp8.run(dense_state, 0, STREAM_STEPS)
    equal_dense = (torch.equal(dense[1], g[1]) and sp8.weight_signature(
        dense[0]) == sp8s.weight_signature(g[0]))
    want = _stream_counts(STREAM_STEPS, n_chunks)
    line = dict(
        phase="stream_timed", grid=f"{cfg.grid_x}x{cfg.grid_y}",
        neurons=cfg.n_neurons, synapses=cfg.n_synapses, chunk=1,
        n_chunks=n_chunks, steps=STREAM_STEPS, window=W,
        graph_nodes_per_window=sum(runner.recorded.values()),
        capture_s=capture_s, build_s=build_s,
        graph_equal_to_eager=same, rate_hz=rate,
        synaptic_events=int(g[2].arrivals.sum()),
        raster_signature=observables.raster_signature(
            raster_np, sp8s.plan.gid.cpu().numpy()).hex(),
        weight_signature=sp8s.weight_signature(g[0]).hex(),
        raster_and_weights_equal_to_materialized=equal_dense,
        profile=dict(
            wall_s=prof_wall,
            device_busy_ms_per_step=busy_us * 1e-3 / STREAM_STEPS,
            device_idle_share=1.0 - busy_us * 1e-6 / prof_wall,
            device_ops_per_step=sum(e[2] for e in ev) / STREAM_STEPS,
            top=[dict(name=k[:90], device_ms_per_step=us * 1e-3
                      / STREAM_STEPS, calls=c) for us, k, c in ev[:10]]),
        memory=dict(
            streamed_program_bytes=_program_bytes(
                sp8s.plan, sp8s.splan, state0, runner.chunks.tables),
            streamed_live_table_bytes=stream_engine.live_table_bytes(
                sp8s.spec, sp8s.splan),
            reference_streamed_table_bytes=stream_engine.
            streamed_table_bytes(sp8s.spec),
            materialized_table_bytes=stream_engine.materialized_table_bytes(
                sp8.spec.e_cap),
            materialized_program_bytes=_program_bytes(sp8.plan,
                                                      dense_state)))
    for mode, r in runs.items():
        line[mode] = dict(
            wall_s=r["wall"], ms_per_step=r["wall"] / STREAM_STEPS * 1e3,
            s_per_synapse_per_sim_s_per_hz=timing.norm_seconds(
                r["wall"], cfg.n_synapses, STREAM_STEPS, rate),
            run_peak_above_program_bytes=r["peak_above"],
            launches=r["counts"]["counted"],
            replayed_launches=r["counts"]["replayed"],
            launches_as_expected=r["counts"]["total"] == want)
    line["eager"]["launches_as_expected"] &= (
        runs["eager"]["counts"]["counted"] == want)
    emit(line)
    if not same or not equal_dense:
        raise PhaseFailed(f"the streamed 8x8 run differs from its eager "
                          f"loop ({same}) or from the materialized run "
                          f"({equal_dense})")
    if not all(line[m]["launches_as_expected"] for m in runs):
        raise PhaseFailed(f"streamed: kernels not launched as expected: "
                          f"{line['graph']}, {line['eager']}")
    return {k: runs["eager"]["counts"]["counted"][k]
            for k in ops.STREAM_KERNELS + ops.STREAM_SPLIT_KERNELS}


# ----------------------------------------------------------------------------
# the mesh: torch.distributed ranks on the card
# ----------------------------------------------------------------------------

MESH_STEPS_8X8 = 200
MESH_SHARDS = 4
# each rank joins the job (cluster.runtime), then runs one function of this
# script, imported as a module: it imports what it needs itself
_MESH_RANK_CODE = """
import sys
sys.path[:0] = [{here!r}, {src!r}]
from repro_torch.cluster import runtime
runtime.ensure_initialized()
import chip_smoke
chip_smoke.{fn}({args!r})
"""


def _mesh_launches(kops, delivery: str, n_chunks, pipelined: bool,
                   n: int) -> dict:
    """The SNN kernels one rank launches in an eager run of n steps (the
    pipelined schedule: the split phase A and one phase B more, the
    prologue's all-False one)."""
    b = n + 1 if pipelined else n
    if n_chunks:
        # chunk_tables before each chunk of phase A, of LTP and of phase B
        want = dict(chunk_tables=n_chunks * (n + (n if pipelined else 0)
                                             + b),
                    stdp_phase_a_chunk=n_chunks * n,
                    arborize_chunk=n_chunks * b)
        if pipelined:
            want["stdp_ltp_chunk"] = n_chunks * n
    elif delivery == "event":
        want = dict.fromkeys(kops.EVENT_KERNELS, n)
        want["event_emit"] = b
        if pipelined:
            want["event_compact"] = n
    else:
        want = dict(stdp_phase_a=n, arborize=b)
        if pipelined:
            want["stdp_ltp"] = n
    return dict(dict.fromkeys(_snn_counted(kops), 0), **want)


def mesh_rank(args: dict) -> None:
    """Inside each rank of a mesh job on the card: each group of cells
    builds once (every rank the full host plan; its block on its card),
    then each cell runs `args["steps"]` steps through `StepProgram.run`
    over the mesh; the primary emits, a cell, whether the gathered raster
    and weights equal the reference's, the gathered `sat`, every rank's
    launches against what the path launches, and the wall."""
    import torch
    from repro_torch.bench.subproc import emit as emit_result
    from repro_torch.cluster import runtime
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  event_engine, observables)
    from repro_torch.dist.mesh import make_snn_mesh
    from repro_torch.kernels import ops as kops
    names = _snn_counted(kops)
    cfg, steps, H = GridConfig(**args["grid"]), args["steps"], MESH_SHARDS
    for g in args["groups"]:
        t0 = time.perf_counter()
        mesh = make_snn_mesh(H)
        sp0 = StepProgram(cfg, EngineConfig(n_shards=H, **g["build"]),
                          mesh=mesh)
        state0, caps = sp0.init_state(), None
        if sp0.eplan is not None:
            state0 = event_engine.init_event_state(
                sp0.spec, state0.base, sp0.spec.e_cap)
            caps = event_engine.no_drop_caps(sp0.spec)
        build_s = time.perf_counter() - t0
        for c in g["cells"]:
            eng = dataclasses.replace(sp0.spec.eng, exchange=c["exchange"],
                                      exchange_schedule=c["schedule"])
            sp = StepProgram.from_parts(
                sp0.spec._replace(eng=eng), sp0.plan, state0,
                eplan=sp0.eplan, splan=sp0.splan, caps=caps, mesh=mesh)
            block = sp.place(state0)
            torch.cuda.synchronize()
            kops.reset_launch_counts()
            t1 = time.perf_counter()
            st, raster, _ = sp.run(block, 0, steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = kops.launch_counts()
            ranks = runtime.gather(torch.tensor([[counts[k]
                                                  for k in names]]))
            raster, full = sp.gather_raster(raster), sp.gather(st)
            if not runtime.is_primary():
                continue
            want = _mesh_launches(
                kops, eng.delivery,
                sp.spec.stream.n_chunks if sp.splan is not None else 0,
                eng.exchange_schedule == "pipelined", steps)
            ranks = [dict(zip(names, r)) for r in ranks.tolist()]
            ref = c["want"]
            rsig = observables.raster_signature(
                raster.numpy(), sp.plan.gid.numpy()).hex()
            sat = (full.sat.tolist() if sp.eplan is not None else None)
            emit_result(dict(
                name=c["name"], wire=mesh.backend, ranks=mesh.world,
                raster_equal=rsig == ref["raster_signature"],
                weights_equal=(sp.weight_signature(full).hex()
                               == ref["weight_signature"]),
                spikes=int(raster.sum()), sat=sat,
                sat_equal=sat is None or (sat == ref["sat"]
                                          and not any(sat)),
                launches_as_expected=all(r == want for r in ranks),
                launches={k: v for k, v in ranks[0].items() if v},
                wall_s=wall, build_s=build_s))


def mesh_timing_rank(args: dict) -> None:
    """Inside each rank: the 8x8 dense halo program at H = MESH_SHARDS,
    under each schedule: `time_phases` (the primary's phase walls, the
    exchange's fence including the wire) and the eager run's wall from a
    barrier to the last rank's end, each after a warm-up; the gathered
    raster's signature."""
    import torch
    from repro_torch.bench.subproc import emit as emit_result
    from repro_torch.cluster import runtime
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  observables)
    from repro_torch.dist.mesh import make_snn_mesh
    cfg, steps = GridConfig(**args["grid"]), args["steps"]
    t0 = time.perf_counter()
    mesh = make_snn_mesh(MESH_SHARDS)
    sp0 = StepProgram(cfg, EngineConfig(n_shards=MESH_SHARDS,
                                        exchange="halo"), mesh=mesh)
    build_s = time.perf_counter() - t0

    def barrier():
        torch.cuda.synchronize()
        mesh.wire.all_reduce_sum(torch.zeros(1, device=mesh.device))

    for sched in ("sync", "pipelined"):
        eng = dataclasses.replace(sp0.spec.eng, exchange_schedule=sched)
        sp = StepProgram.from_parts(sp0.spec._replace(eng=eng), sp0.plan,
                                    sp0.init_state(), mesh=mesh)
        block = sp.place(sp0.init_state())
        _, times, _, counts = sp.time_phases(block, 0, steps)
        sp.run(block, 0, 10)                         # warm-up
        barrier()
        t1 = time.perf_counter()
        _, raster, _ = sp.run(block, 0, steps)
        barrier()
        wall = time.perf_counter() - t1
        raster = sp.gather_raster(raster)
        if runtime.is_primary():
            total = sum(times.values())
            emit_result(dict(
                schedule=sched, ranks=mesh.world, wire=mesh.backend,
                run_ms_per_step=wall / steps * 1e3,
                phases_ms_per_step={k: v / steps * 1e3
                                    for k, v in times.items()},
                exchange_share=times["exchange_s"] / total,
                spikes=counts["spikes"], build_s=build_s,
                raster_signature=observables.raster_signature(
                    raster.numpy(), sp.plan.gid.numpy()).hex()))


def _start_mesh_job(fn: str, args: dict, n_ranks: int, timeout: float):
    from repro_torch.bench import subproc
    code = _MESH_RANK_CODE.format(here=HERE, src=os.path.join(HERE, "src"),
                                  fn=fn, args=args)
    return subproc.Ranks(code, n_ranks, device="cuda", timeout=timeout)


def _stacked_program(grid: dict) -> tuple:
    """R = 1: the 8x8 halo program at H = MESH_SHARDS stacked on the card
    in this process -> (the program, its build seconds)."""
    t0 = time.perf_counter()
    sp0 = StepProgram(GridConfig(**grid), EngineConfig(
        n_shards=MESH_SHARDS, exchange="halo"), device="cuda")
    return sp0, time.perf_counter() - t0


def _stacked_timing(sp0, build_s: float, steps: int) -> list:
    """R = 1: `_stacked_program`'s program, `time_phases` under each
    schedule and the captured graph's run, after a warm-up."""
    state0 = sp0.init_state()
    out = []
    for sched in ("sync", "pipelined"):
        eng = dataclasses.replace(sp0.spec.eng, exchange_schedule=sched)
        sp = StepProgram.from_parts(sp0.spec._replace(eng=eng), sp0.plan,
                                    state0)
        _, times, _, counts = sp.time_phases(state0, 0, steps)
        sp.run(state0, 0, 2 * engine.RUN_WINDOW)   # warm-up, capture
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, raster, _ = sp.run(state0, 0, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        total = sum(times.values())
        out.append(dict(
            schedule=sched, ranks=1, wire="stacked (one process)",
            run_ms_per_step=wall / steps * 1e3, run="captured graph",
            phases_ms_per_step={k: v / steps * 1e3
                                for k, v in times.items()},
            exchange_share=times["exchange_s"] / total,
            spikes=counts["spikes"], build_s=build_s,
            raster_signature=observables.raster_signature(
                raster.cpu().numpy(), sp.plan.gid.cpu().numpy()).hex()))
    return out


def phase_mesh(card: str):
    """The mesh on the card: R = 2 and R = 4 ranks of a torch.distributed
    job sharing the one GPU (the wire gloo, staged through pinned host
    memory), and one rank under NCCL; at 4x4 full width, 150 steps, each
    cell's gathered raster and weights equal to `jax_reference.json`, and
    every rank's kernels launched as the path launches them; then the 8x8
    dense halo program at H = 4, MESH_STEPS_8X8 steps, stacked (R = 1) and
    over 4 ranks, under each schedule: ms a step and the exchange's share
    of `time_phases`, beside the card's name and power limit."""
    from repro_torch.bench import subproc
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    grid = dict(ref["grid"], neurons_per_column=ref["neurons_per_column"],
                synapses_per_neuron=ref["synapses_per_neuron"])
    dense, scatter = ref["runs"]["h4_block"], ref["runs"]["h4_scatter"]
    event = ref["event_runs"]["h4_block"]

    def cells(want, pairs):
        return [dict(name=f"{ex}_{sc}", exchange=ex, schedule=sc,
                     want=want) for ex, sc in pairs]
    every = [(ex, sc) for ex in EXCHANGES for sc in ("sync", "pipelined")]
    groups = [
        dict(build=dict(delivery="dense"), cells=cells(dense, every)),
        dict(build=dict(placement="scatter"),
             cells=cells(scatter, [("allgather", "sync")])),
        dict(build=dict(delivery="event"), cells=[
            dict(c, name="event_" + c["name"]) for c in cells(
                event, [("allgather", "sync"), ("halo", "pipelined")])]),
        dict(build=dict(connectivity="streamed:chunk=1"), cells=[
            dict(c, name="streamed_" + c["name"]) for c in cells(
                dense, [("halo", "sync"), ("halo", "pipelined")])]),
        # a rank's block of scatter shards regenerates its chunks from the
        # plan's shard ids (the chunk kernel's shard-id argument)
        dict(build=dict(placement="scatter",
                        connectivity="streamed:chunk=1"),
             cells=[dict(c, name="streamed_scatter_" + c["name"])
                    for c in cells(scatter, [("halo", "sync"),
                                             ("hier", "pipelined")])])]
    nccl_groups = [dict(build=dict(delivery="dense"), cells=cells(
        dense, [("halo", "sync"), ("allgather", "sync")]))]
    # one rank holding every shard: streamed scatter under NCCL
    nccl_r1_groups = nccl_groups + [
        dict(build=dict(placement="scatter",
                        connectivity="streamed:chunk=1"),
             cells=[dict(c, name="streamed_scatter_" + c["name"])
                    for c in cells(scatter, [("halo", "sync")])])]
    args = dict(grid=grid, steps=ref["steps"], groups=groups)
    n_dev = torch.cuda.device_count()
    grid8 = dict(grid_x=8, grid_y=8)
    t0 = time.perf_counter()
    jobs = {f"R{R}": _start_mesh_job("mesh_rank", args, R, 420)
            for R in (2, 4)}
    jobs["nccl_R1"] = _start_mesh_job(
        "mesh_rank", dict(args, groups=nccl_r1_groups), 1, 420)
    if n_dev >= 2:
        jobs["nccl_R2"] = _start_mesh_job(
            "mesh_rank", dict(args, groups=nccl_groups), 2, 420)
    # the 8x8 stacked program's host build (about 20 s) while the ranks
    # run: mesh_check's seconds are then contended, not its bits
    try:
        stacked8 = _stacked_program(grid8)
    except BaseException:
        for job in jobs.values():
            subproc.reap(job.procs)
        raise
    results, failed = {}, []
    for key, job in jobs.items():
        try:
            results[key] = subproc.results(job.wait())
        except subproc.RanksError as e:
            failed.append(key)
            results[key] = str(e)[-3000:]
    check_s = time.perf_counter() - t0
    for key, rows in results.items():
        if isinstance(rows, str):
            continue
        # NCCL where every rank has a GPU of its own (cluster.runtime)
        R = int(key.rsplit("R", 1)[1])
        want_wire = "nccl" if R <= n_dev else "gloo, host-staged"
        n_cells = sum(len(g["cells"]) for g in dict(
            nccl_R1=nccl_r1_groups, nccl_R2=nccl_groups).get(key, groups))
        ok = len(rows) == n_cells and all(
            r["raster_equal"] and r["weights_equal"] and r["sat_equal"]
            and r["launches_as_expected"] and r["wire"] == want_wire
            for r in rows)
        if not ok:
            failed.append(key)
    emit({"phase": "mesh_check", "grid": "4x4", "shards": MESH_SHARDS,
          "steps": ref["steps"], "device_count": n_dev,
          "beside": "the 8x8 stacked program's build",
          "nccl_multi_rank": ("run: R = 2" if n_dev >= 2
                              else "not run: 1 device"),
          "seconds": check_s, "jobs": results})
    if failed:
        raise PhaseFailed(f"mesh cells failed or differ from the JAX "
                          f"reference: {failed}")
    # the shard-id form's launches: rank 0's chunk_tables in the streamed
    # scatter cells over 2 and 4 ranks (each rank's block of scatter rows)
    shard_id_launches = sum(
        r["launches"].get("chunk_tables", 0) for key in ("R2", "R4")
        for r in results[key] if r["name"].startswith("streamed_scatter_"))

    # 8x8 full width (12.8 M synapses): R = 1 stacked, then R = 4 ranks
    t0 = time.perf_counter()
    timing_rows = _stacked_timing(*stacked8, MESH_STEPS_8X8)
    del stacked8
    torch.cuda.empty_cache()
    try:
        timing_rows += subproc.results(_start_mesh_job(
            "mesh_timing_rank", dict(grid=grid8, steps=MESH_STEPS_8X8),
            MESH_SHARDS, 420).wait())
    except subproc.RanksError as e:
        raise PhaseFailed(f"the 8x8 mesh timing failed: {str(e)[-3000:]}")
    print(card, flush=True)
    same = len({r["raster_signature"] for r in timing_rows}) == 1
    emit({"phase": "mesh_timed", "card": card, "grid": "8x8",
          "synapses": 12_800_000, "shards": MESH_SHARDS, "exchange": "halo",
          "steps": MESH_STEPS_8X8, "seconds": time.perf_counter() - t0,
          "rasters_equal": same, "rows": timing_rows})
    if not same or len(timing_rows) != 4:
        raise PhaseFailed("the 8x8 mesh runs differ from the stacked one")
    return shard_id_launches



# ----------------------------------------------------------------------------
# checkpoints and the supervised cluster runtime
# ----------------------------------------------------------------------------

CKPT_SAVE_T = 50        # ckpt_check's cases save at this step
CKPT_ODD_T = 30         # and one restores off the captured graph's window
# (name, saving layout, restoring layout, t): a layout is (delivery, H,
# placement, chunk K or None for materialized connectivity)
CKPT_CASES = (
    ("dense_h1_to_h4_block", ("dense", 1, "block", None),
     ("dense", 4, "block", None), CKPT_SAVE_T),
    ("dense_h4_block_to_h4_scatter", ("dense", 4, "block", None),
     ("dense", 4, "scatter", None), CKPT_SAVE_T),
    ("event_h4_block_to_h1", ("event", 4, "block", None),
     ("event", 1, "block", None), CKPT_SAVE_T),
    ("streamed_k1_to_k2_h4", ("dense", 4, "block", 1),
     ("dense", 4, "block", 2), CKPT_SAVE_T),
    ("dense_h4_block_to_h1_t30", ("dense", 4, "block", None),
     ("dense", 1, "block", None), CKPT_ODD_T))
CLUSTER_FAULTS = (("crash", "crash@step=50:rank=1"),
                  ("corrupt_ckpt", "corrupt_ckpt@step=100"))


def _ckpt8_state(sp8) -> tuple:
    """(spec, plan, state, t) of the dense 8x8 program after CKPT_SAVE_T
    steps, plan and state copied to the host: ckpt_check times a save and
    a load of it."""
    state, _, _ = sp8.run(sp8.init_state(), 0, CKPT_SAVE_T)
    cpu = lambda tree: engine.map_state(torch.Tensor.cpu, tree)
    return sp8.spec, cpu(sp8.plan), cpu(state), CKPT_SAVE_T


def _ckpt_program(cfg, layout, cache: dict, device: str = "cuda"):
    """The program of a CKPT_CASES layout on `device`, built once."""
    key = (layout, device)
    if key not in cache:
        delivery, h, placement, chunk = layout
        if chunk is None:
            cache[key] = _program(cfg, EngineConfig(
                n_shards=h, placement=placement, delivery=delivery),
                device=device)
        else:
            cache[key] = _stream_program(cfg, chunk, h, placement)
    return cache[key]


def _ckpt_want(ref: dict, layout) -> dict:
    """The reference run whose layout a restore has."""
    delivery, h, placement, _ = layout
    runs = ref["event_runs"] if delivery == "event" else ref["runs"]
    return runs[f"h{h}_{placement}"]


def _digest(path: str) -> str:
    with np.load(path) as z:
        return str(z["payload_sha256"])


def ckpt_rank(args: dict) -> None:
    """Inside each rank: H = 4 dense block shards over the job's ranks.
    "save": run 0 -> t, the primary saves the gathered state with the
    gathered raster's events; "load": every rank restores the file and
    places its block, runs t -> steps, and the primary reports the
    signatures of the file's events followed by its own, and the
    weights'."""
    from repro_torch.bench.subproc import emit as emit_result
    from repro_torch.cluster import runtime
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  checkpoint, observables)
    from repro_torch.dist.mesh import make_snn_mesh
    cfg, t = GridConfig(**args["grid"]), args["t"]
    mesh = make_snn_mesh(4)
    sp = StepProgram(cfg, EngineConfig(n_shards=4), mesh=mesh)
    gid = sp.plan.gid.numpy()
    if args["mode"] == "save":
        state, raster, _ = sp.run(sp.place(sp.init_state()), 0, t)
        raster, full = sp.gather_raster(raster), sp.gather(state)
        if runtime.is_primary():
            checkpoint.save(args["path"], sp.spec, sp.plan, full, t,
                            raster_events=observables.raster_events(
                                raster.numpy(), gid))
            emit_result(dict(saved=args["path"], ranks=mesh.world,
                             wire=mesh.backend))
        return
    state, t0 = sp.load(args["path"])
    state, raster, _ = sp.run(sp.place(state), t0, args["steps"] - t0)
    raster, full = sp.gather_raster(raster), sp.gather(state)
    if runtime.is_primary():
        ev_t, ev_g = checkpoint.load_raster_events(args["path"])
        ct, cg = observables.raster_events(raster.numpy(), gid, t0=t0)
        emit_result(dict(
            t=t0, ranks=mesh.world, wire=mesh.backend,
            raster_signature=observables.events_signature(
                np.concatenate([ev_t, ct]), np.concatenate([ev_g, cg])).hex(),
            weight_signature=sp.weight_signature(full).hex()))


def phase_ckpt(card: str, ckpt8: tuple, beside: str = ""):
    """Checkpoints on the card (`core.checkpoint`, `StepProgram.load`) at
    the full width of `jax_reference.json` (4x4, 150 steps): each case of
    CKPT_CASES runs 0 -> t on the card through the graph, saves, loads
    into a fresh program of another layout and runs t -> 150; the two
    windows' events give the reference's raster signature and the final
    weights the weight signature of the reference run of the restoring
    layout.  At 2x2 full width the file the card writes at t = 50 (dense
    and event) has the payload digest of the one the CPU plain path
    writes.  Over ranks, an R = 2 job saves and an R = 4 job restores
    (both sharing the card).  At 8x8 dense: save and load seconds and
    the file's bytes (host work), beside the card and the host's CPUs."""
    import tempfile
    from repro_torch.bench import subproc
    from repro_torch.core import checkpoint
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    grid = dict(ref["grid"], neurons_per_column=ref["neurons_per_column"],
                synapses_per_neuron=ref["synapses_per_neuron"])
    cfg, steps = GridConfig(**grid), ref["steps"]
    tmp = tempfile.mkdtemp(prefix="ckpt_check_")
    t_phase = time.perf_counter()
    rank_args = dict(grid=grid, t=CKPT_SAVE_T, steps=steps,
                     path=os.path.join(tmp, "ranks.npz"))
    job = _start_mesh_job("ckpt_rank", dict(rank_args, mode="save"), 2, 420)
    programs, cases, failed = {}, {}, []
    with _shared_tables():
        for name, a, b, t in CKPT_CASES:
            spa = _ckpt_program(cfg, a, programs)
            spb = _ckpt_program(cfg, b, programs)
            s_a, r_a, _ = spa.run(spa.init_state(), 0, t)
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            path = checkpoint.save(os.path.join(tmp, f"{name}.npz"), spa.spec,
                                   spa.plan, s_a, t)
            save_s = time.perf_counter() - c0
            c0 = time.perf_counter()
            state, t_back = spb.load(path)
            load_s = time.perf_counter() - c0
            s_b, r_b, _ = spb.run(state, t_back, steps - t_back)
            ev = [observables.raster_events(r.cpu().numpy(),
                                            sp.plan.gid.cpu().numpy(), t0=t0)
                  for r, sp, t0 in ((r_a, spa, 0), (r_b, spb, t_back))]
            rsig = observables.events_signature(
                np.concatenate([e[0] for e in ev]),
                np.concatenate([e[1] for e in ev])).hex()
            want = _ckpt_want(ref, b)
            res = dict(t=t_back, raster_equal=rsig == want["raster_signature"],
                       weights_equal=(spb.weight_signature(s_b).hex()
                                      == want["weight_signature"]),
                       restore_replays=spb.runner.replays, save_s=save_s,
                       load_s=load_s, file_bytes=os.path.getsize(path))
            if a[0] == "event":
                res["sat"] = int(s_b.sat.sum())
            cases[name] = res
            if not (res["raster_equal"] and res["weights_equal"]
                    and t_back == t and not res.get("sat")):
                failed.append(name)
        del programs
        torch.cuda.empty_cache()

        # the card's file and the CPU plain path's, 2x2 full width, t = 50
        cfg2, devices = GridConfig(grid_x=2, grid_y=2), {}
        for delivery in ("dense", "event"):
            layout = (delivery, 2, "block", None)
            digests = []
            for device in ("cuda", "cpu"):
                sp = _ckpt_program(cfg2, layout, {}, device=device)
                s, _, _ = sp.run(sp.init_state(), 0, CKPT_SAVE_T)
                digests.append(_digest(checkpoint.save(os.path.join(
                    tmp, f"cross_{delivery}_{device}.npz"), sp.spec, sp.plan,
                    s, CKPT_SAVE_T)))
            devices[delivery] = dict(card=digests[0][:16],
                                     equal=digests[0] == digests[1])
            if not devices[delivery]["equal"]:
                failed.append(f"card vs cpu file ({delivery})")

    # R = 2 saves, R = 4 restores
    ranks = {}
    try:
        ranks["save"] = subproc.results(job.wait())
        ranks["load"] = subproc.results(_start_mesh_job(
            "ckpt_rank", dict(rank_args, mode="load"), 4, 420).wait())
        got, want = ranks["load"][0], ref["runs"]["h4_block"]
        ranks["equal"] = (got["raster_signature"] == want["raster_signature"]
                          and got["weight_signature"]
                          == want["weight_signature"]
                          and got["t"] == CKPT_SAVE_T)
    except (subproc.RanksError, IndexError, KeyError) as e:
        ranks["error"] = str(e)[-3000:]
    if not ranks.get("equal"):
        failed.append("R2 -> R4")

    # 8x8 dense, 12.8 M synapses: host work
    spec8, plan8, state8, t8 = ckpt8
    path8 = os.path.join(tmp, "dense_8x8.npz")
    c0 = time.perf_counter()
    checkpoint._global_keys(spec8, plan8)       # the layout's keys, once
    keys_s = time.perf_counter() - c0
    c0 = time.perf_counter()
    checkpoint.save(path8, spec8, plan8, state8, t8)
    save_s = time.perf_counter() - c0
    c0 = time.perf_counter()
    back, t_back = checkpoint.load(path8, spec8, plan8)
    load_s = time.perf_counter() - c0
    same8 = t_back == t8 and all(bit_equal(x, y) for x, y in zip(
        engine.state_tensors(back), engine.state_tensors(state8)))
    if not same8:
        failed.append("8x8 round trip")
    print(card, flush=True)
    emit({"phase": "ckpt_check", "card": card, "grid": "4x4",
          "steps": steps, "cases": cases, "card_vs_cpu_file_2x2": devices,
          "ranks_r2_to_r4": ranks,
          "host_tables": "the cases share each layout's "
                         "(_shared_tables); 8x8 builds its own",
          "dense_8x8": dict(
              synapses=int(plan8.row_ptr[:, -1].sum()), t=t8,
              keys_s=keys_s, save_s=save_s, load_s=load_s,
              file_bytes=os.path.getsize(path8), round_trip_equal=same8,
              note="host work; keys_s builds the layout's synapse keys "
                   "and their canonical order (once a process), which "
                   "the save and the load then reuse",
              host_cpus=os.cpu_count(),
              host_cpus_usable=len(os.sched_getaffinity(0))),
          "seconds": time.perf_counter() - t_phase,
          "contended_by": beside or None})
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise PhaseFailed(f"checkpoint cases failed: {failed}")


def run_cluster() -> tuple:
    """The cluster check's work, printing nothing (it may run on a thread
    beside `simserve_check`: every rank is another process):
    `repro_torch.cluster run --supervise --ckpt-every 50` at 4x4 full
    width, H = 4 over 2 ranks sharing the card, 150 steps, once with each
    fault of CLUSTER_FAULTS (the two launches at once): a crash of rank 1
    at step 50 restarts and restores at t = 50; the epoch at t = 100
    truncated after its write fails its sha256 and recovery falls back to
    t = 50.  Each recovered run's raster and weight signatures must be
    `jax_reference.json`'s h4_block run's -> (the line's fields, the
    runs that failed)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.cluster import cli as ccli
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    want = ref["runs"]["h4_block"]
    tmp = tempfile.mkdtemp(prefix="cluster_check_")

    def scenario(item):
        name, fault = item
        args = ccli.workload_namespace(
            grid="x".join(str(ref["grid"][k]) for k in ("grid_x", "grid_y")),
            neurons_per_column=ref["neurons_per_column"],
            synapses=ref["synapses_per_neuron"], seed=GridConfig().seed,
            steps=ref["steps"], shards=4, phase_steps=0,
            ckpt_dir=os.path.join(tmp, name), ckpt_every=CKPT_SAVE_T,
            supervise=True, fault=fault, max_restarts=2,
            stall_timeout=240.0, device="cuda")
        t0 = time.perf_counter()
        try:
            row = ccli.run_point(args, 2, timeout=600)
        except Exception as e:          # a LaunchError, with its history
            return name, dict(error=str(e)[-4000:])
        return name, dict(row=row, wall_s=time.perf_counter() - t0)

    t_phase = time.perf_counter()
    with ThreadPoolExecutor(len(CLUSTER_FAULTS)) as ex:
        got = dict(ex.map(scenario, CLUSTER_FAULTS))
    results, failed = {}, []
    for name, fault in CLUSTER_FAULTS:
        g = got[name]
        if "error" in g:
            results[name] = g
            failed.append(name)
            continue
        row, rec = g["row"], g["row"]["recovery"]
        res = dict(fault=fault, restarts=rec["restarts"],
                   restored_t=rec["restored_t"],
                   steps_salvaged=rec["recovered_steps"],
                   attempts=rec["attempts"], wall_s=g["wall_s"],
                   run_wall_s=row["wall_s"], ckpt_wall_s=row["ckpt_wall_s"],
                   wire=row["wire"],
                   raster_equal=row["raster_sig"] == want["raster_signature"],
                   weights_equal=(row["weights_sig"]
                                  == want["weight_signature"]))
        results[name] = res
        if not (res["raster_equal"] and res["weights_equal"]
                and res["restarts"] >= 1 and res["restored_t"] == CKPT_SAVE_T
                and res["steps_salvaged"] == CKPT_SAVE_T):
            failed.append(name)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(grid=f"{ref['grid']['grid_x']}x{ref['grid']['grid_y']}",
                shards=4, ranks=2, steps=ref["steps"],
                ckpt_every=CKPT_SAVE_T, runs=results,
                seconds=time.perf_counter() - t_phase), failed


def phase_cluster(card: str, result: tuple = None, beside: str = ""):
    """Print `run_cluster`'s result (running it first when not given):
    per fault the restarts, the steps salvaged and the wall seconds
    beside the card; fail if a run failed or differs.  `beside` names
    what ran on the card at the same time: the line then marks its walls
    as contended."""
    fields, failed = result or run_cluster()
    print(card, flush=True)
    emit({"phase": "cluster_check", "card": card, **fields,
          "contended_by": beside or None})
    if failed:
        raise PhaseFailed(f"supervised recovery failed or differs from the "
                          f"JAX reference: {failed}")


# ----------------------------------------------------------------------------
# experiment plans (repro_torch.bench.plans)
# ----------------------------------------------------------------------------

#: (a) full width: the 4x4 check's physics (`jax_reference.json` h1_block)
#: over both residencies, halo and hier, both placements, 1 and 2 processes
#: (2-process cells hier only): 8 cells, among them 2 processes, hier,
#: streamed, scatter
PLAN_FULL = dict(
    name="chip_full_width",
    workload=dict(neurons_per_column=1000, synapses_per_neuron=200,
                  steps=150, phase_steps=10, seed=2013),
    axes=dict(grid=["4x4"], connectivity=["materialized",
                                          "streamed:chunk=1"],
              delivery=["dense"], exchange=["halo", "hier"],
              placement=["block", "scatter"], shards=[4], nprocs=[1, 2]),
    exclude=[{"nprocs": 2, "exchange": "halo"}],
    budgets=dict(timeout_s=600, reps=2))
#: (b) the committed quick plan's content (benchmarks/plans/quick.yaml),
#: inline: 15 cells in one physics group (`jax_reference.json` plan_quick)
PLAN_QUICK = dict(
    name="quick",
    workload=dict(neurons_per_column=40, synapses_per_neuron=16, steps=40,
                  phase_steps=10, seed=7),
    axes=dict(grid=["2x2"], connectivity=["materialized",
                                          "streamed:chunk=1"],
              delivery=["dense", "event"], exchange=["halo", "allgather"],
              exchange_schedule=["sync", "pipelined"], shards=[2],
              nprocs=[1, 2]),
    exclude=[{"nprocs": 2, "exchange": "allgather"},
             {"nprocs": 2, "exchange_schedule": "pipelined"}],
    budgets=dict(timeout_s=600, reps=2))
PLAN_CELL_KEYS = ("wall_s", "wall_reps_s", "phase_a_s", "exchange_s",
                  "phase_b_s", "phase_steps", "time_per_syn_event_s",
                  "spikes", "rate_hz", "saturated")


def _plan_check(doc: dict, want: dict, n_cells: int, tmp: str) -> tuple:
    """Run plan `doc` (written as JSON under `tmp`) twice on the card, the
    second time with `assert_complete`, then `write_report` and the
    dashboard -> (what the plan line prints, whether every gate held):
    n_cells executed then none, every cell's raster signature and spikes
    `want`'s, the report valid with every `identical_*` flag true."""
    from repro_torch.bench import plans
    from repro_torch.bench import report as bench_report
    from repro_torch.bench.plans import dashboard
    name = doc["name"]
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    plan = plans.load(path)
    store_root = os.path.join(tmp, "store")
    log = []
    t0 = time.perf_counter()
    first = plans.run_plan(plan, store_root, device="cuda", log=log.append)
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = plans.run_plan(plan, store_root, device="cuda",
                            assert_complete=True, log=log.append)
    resume_s = time.perf_counter() - t0
    failures = [ln for ln in log if "FAILED" in ln][:8]
    try:
        _, rep = plans.write_report(plan, store_root)
    except plans.PlanError as e:
        return dict(first=first, error=str(e)[-2000:], log=failures), False
    html = dashboard.write(os.path.join(tmp, f"{name}.html"),
                           plan.to_config(), rep["extra"]["cells"],
                           summary=first)
    cells = {}
    for c in rep["extra"]["cells"]:
        res = c["result"]
        cells[c["key"]] = dict(
            {k: res[k] for k in PLAN_CELL_KEYS if k in res},
            elapsed_s=c["elapsed_s"],
            raster_equal=res["raster_sig"] == want["raster_signature"],
            spikes_equal=res["spikes"] == want["spikes"])
    idents = {k: v for k, v in rep["deterministic"].items()
              if k.startswith("identical_")}
    errors = bench_report.validate(rep)
    ok = (first["ok"] and first["executed"] == n_cells
          and second["ok"] and second["executed"] == 0
          and second["skipped"] == n_cells and len(cells) == n_cells
          and all(c["raster_equal"] and c["spikes_equal"]
                  for c in cells.values())
          and bool(idents) and all(idents.values()) and not errors
          and os.path.getsize(html) > 1000)
    return dict(cells=cells, identical=idents, run_s=run_s,
                resume_s=resume_s, executed=first["executed"],
                failed_cells=first["failed_keys"],
                resumed_executed=second["executed"],
                resumed_skipped=second["skipped"],
                excluded=first["excluded"], report_errors=errors,
                dashboard_bytes=os.path.getsize(html),
                want=dict(raster_signature=want["raster_signature"],
                          spikes=want["spikes"]), log=failures), ok


def run_plans(at_once: bool = True) -> tuple:
    """The plan phase's work, printing nothing (it may run on a thread
    beside `simserve_check`): two experiment plans written as JSON into a
    temporary directory and run on the card through `repro_torch.bench.
    plans.run_plan` (each cell a fresh interpreter, or a 2-rank
    `repro_torch.cluster` launch sharing the card; `_plan_check`):
    PLAN_FULL, whose 8 cells must each give `jax_reference.json`'s
    h1_block raster signature and spike count, and PLAN_QUICK, whose 15
    cells must each give its plan_quick entry's; `at_once`, a thread each
    (their cells are mostly interpreter and CUDA start-up on the host),
    else one after the other -> (each plan's line, the plans that failed,
    seconds)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    out, failed = {}, []
    with tempfile.TemporaryDirectory(prefix="plan_check_") as tmp:
        checks = ((PLAN_FULL, ref["runs"]["h1_block"], 8),
                  (PLAN_QUICK, ref["plan_quick"], 15))
        with ThreadPoolExecutor(len(checks) if at_once else 1) as ex:
            done = list(ex.map(lambda c: _plan_check(*c, tmp), checks))
        for (doc, _, _), (res, ok) in zip(checks, done):
            out[doc["name"]] = res
            if not ok:
                failed.append(doc["name"])
    return out, failed, time.perf_counter() - t0


def phase_plan(card: str, result: tuple, beside: str = "") -> None:
    """Print `run_plans`' result: per cell the wall (the fastest of its
    reps, and each rep's), the phase split and the time per synaptic
    event, beside the card's name and power limit; fail if a plan
    failed.  `beside` names what ran on the card at the same time: the
    line then marks its walls and seconds as contended, not the cells'
    own (`scripts/plan_phase.py` runs the plans alone)."""
    out, failed, seconds = result
    emit({"phase": "plan", "card": card, "plans": out, "seconds": seconds,
          "contended_by": beside or None})
    if failed:
        raise PhaseFailed(f"experiment plans failed or differ from the JAX "
                          f"reference: {failed}")


# ----------------------------------------------------------------------------
# training (the train phases)
# ----------------------------------------------------------------------------

#: the backward scan's shapes: (label, shape) on numpy-seeded inputs; the
#: training shape is the full-width run's (B = 4, T = 512)
TRAIN_SCAN_SHAPES = (("prefill", (1, 512, 2560)), ("train", (4, 512, 2560)),
                     ("ragged", (3, 77, 100)))
TRAIN_FULL = dict(batch=4, seq=512, steps=3, lr=3e-4)
TRAIN_FULL_PARAMS = 2_894_574_080    # the JAX package's init_params count
TRAIN_TRAJ_TOL = 1e-4
TRAIN_TOL = {"float32": dict(loss=2e-5, leaf=1e-3),
             "bfloat16": dict(loss=0.05, leaf=0.1)}


def _train_reference() -> dict:
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "train_reference.json")) as f:
        return json.load(f)


def _scan_bwd_row(label, cpu, gpu, shape_kw):
    """One `rg_lru_scan_bwd` row: (a, h0, h, gh) on the CPU and the card;
    bit-equal to the plain version on the CPU copy and on the card."""
    got = krg.rg_lru_scan_bwd(*gpu)
    torch.cuda.synchronize()
    with kref.flush_denormal():
        want_cpu = kref.rg_lru_scan_bwd(*cpu)
    want_gpu = kref.rg_lru_scan_bwd(*gpu)
    equal = all(bit_equal(g, w) and bit_equal(g, v)
                for g, w, v in zip(got, want_cpu, want_gpu))
    a = gpu[0]
    B, T, D = a.shape
    # read gh, a, h and h0, write da, db and dh0; 3 operations an element
    bms, by = bound(nbytes(*gpu) + nbytes(*got), 3 * B * T * D)
    return dict(
        name="rg_lru_scan_bwd", route="cuda",
        source="src/repro_torch/csrc/rg_lru.cu",
        replaces="src/repro/kernels/rg_lru.py:39", launches=None,
        max_abs_err=max(max(max_abs_err(g, w), max_abs_err(g, v))
                        for g, w, v in zip(got, want_cpu, want_gpu)),
        ms=cuda_ms(lambda: krg.rg_lru_scan_bwd(*gpu)),
        device_ms=device_ms(lambda: krg.rg_lru_scan_bwd(*gpu),
                            kernel="rg_lru_scan_bwd"),
        plain_ms=cuda_ms(lambda: kref.rg_lru_scan_bwd(*gpu), calls=2,
                         reps=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None, equal=equal,
        tolerance="bit-equal (0 ulp), to the plain version on a CPU copy "
                  "and on the card",
        note="the JAX package has no backward kernel: jax.grad of its "
             "oracle src/repro/kernels/ref.py:73 (the Pallas forward "
             "src/repro/kernels/rg_lru.py:39 has no VJP)",
        shape=dict(shape_kw, B=B, T=T, D=D))


def phase_train_kernels(layer0=None):
    """The backward scan against its plain version: numpy-seeded inputs at
    three shapes, and layer 0's real inputs from the full-width run."""
    rng = np.random.default_rng(31)
    rows = []
    for label, shape in TRAIN_SCAN_SHAPES:
        a, b, h0 = _scan_inputs(rng, shape)
        h = kref.rg_lru_scan(a, b, h0)
        gh = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        cpu = (a, h0, h, gh)
        rows.append(_scan_bwd_row(label, cpu, tuple(x.cuda() for x in cpu),
                                  {"label": label}))
    if layer0 is not None:
        gpu = tuple(x.contiguous() for x in layer0)
        rows.append(_scan_bwd_row("full_width_layer0",
                                  tuple(x.cpu() for x in gpu), gpu,
                                  {"label": "full_width_layer0"}))
    emit({"phase": "train_kernels", "rows": rows})
    failed = [r["shape"]["label"] for r in rows if not r["equal"]]
    if failed:
        raise PhaseFailed(f"rg_lru_scan_bwd differs from its plain version "
                          f"at {failed}")
    return rows


def _train_batch(cfg, ref: dict, device) -> dict:
    """train_reference.json's loss batch, from the synthetic stream."""
    from repro_torch.data import synthetic
    bk = ref["batch"]
    toks = synthetic.batch_tokens(bk["seed"], bk["index"], bk["B"], bk["T"],
                                  cfg.vocab_size)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    for i, t in bk["masked"]:
        b["labels"][i, t] = -100
    if cfg.modality == "vlm":
        b["embeds"] = synthetic.batch_embeds(bk["seed"], bk["index"],
                                             bk["B"], bk["T"], cfg.d_model)
    if cfg.family == "encdec":
        b["enc_embeds"] = synthetic.batch_embeds(
            bk["seed"], bk["index"], bk["B"], bk["enc_T"], cfg.d_model)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _train_grads(cfg, ref: dict) -> tuple:
    params = convert.lm_params_from_jax(
        convert.numpy_params(cfg, ref["weights_seed"]), cfg, "cuda")
    params.requires_grad_(True)
    loss, metrics = lm.loss_fn(cfg, params, _train_batch(cfg, ref, "cuda"),
                               xent_chunk=ref["xent_chunk"])
    names, ws = zip(*params.named_parameters())
    gs = torch.autograd.grad(loss, ws, allow_unused=True,
                             materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        dict(zip(names, gs))


def _trajectory(arch: str, config: str, traj: dict) -> dict:
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    kw = traj["configs"][config]
    params = convert.lm_params_from_jax(convert.numpy_params(cfg, 0), cfg,
                                        "cuda")
    state = train_state.create(params, use_error_feedback=kw.get(
        "compress_grads", False))
    step = train_step.make_train_step(
        cfg, lr_schedule=schedules.wsd(*traj["wsd"]), **kw)
    data = iter(pipeline.Batcher(cfg, traj["B"], traj["T"],
                                 seed=traj["batcher_seed"], device="cuda"))
    rows = {"loss": [], "grad_norm": [], "lr": [], "xent": []}
    for _ in range(traj["steps"]):
        state, m = step(state, next(data))
        for k in rows:
            rows[k].append(float(m[k]))
    rows["params"] = [w.detach().clone() for w in params.parameters()]
    return rows


def phase_train_check():
    """The SMOKE training gates on the card against train_reference.json:
    each variant's loss, aux, global gradient norm and per-leaf gradient
    (the sampled entries and the largest magnitude within the leaf's
    tolerance of its largest magnitude, the sum within that times the
    leaf's size), its RG-LRU launches (2 forward, 1 backward a layer);
    the three-step trajectories within 1e-4; and each variant and
    trajectory run twice, bit for bit."""
    ref = _train_reference()
    results, failed = [], []
    for v, want in ref["variants"].items():
        arch, dtype = v.split(":")
        cfg = get_smoke_config(arch).scaled(dtype=dtype)
        tol = TRAIN_TOL[dtype]
        ops.reset_launch_counts()
        loss, metrics, grads = _train_grads(cfg, ref)
        counts = ops.launch_counts()
        loss2, _, grads2 = _train_grads(cfg, ref)
        same = bit_equal(loss, loss2) and all(
            bit_equal(grads[k], grads2[k]) for k in grads)
        gnorm = float(optim_grad_utils.global_norm(
            grads, [g.names for g in convert.jax_leaf_groups(cfg)]))
        worst, worst_leaf, finite = 0.0, None, True
        for name, g in grads.items():
            w = want["leaves"][name]
            flat = g.float().flatten()
            finite &= bool(torch.isfinite(flat).all())
            scale = max(w["max_abs"], 1e-30)
            errs = [abs(float(flat[i]) - x) / scale
                    for i, x in zip(w["idx"], w["val"])]
            errs.append(abs(float(flat.abs().max()) - w["max_abs"]) / scale)
            errs.append(abs(float(flat.double().sum()) - w["sum"])
                        / (scale * flat.numel()))
            if max(errs) > worst:
                worst, worst_leaf = max(errs), name
        n_rg = _n_rg(cfg)
        res = dict(variant=v, loss=float(loss), want_loss=want["loss"],
                   loss_err=abs(float(loss) - want["loss"]),
                   aux_err=abs(float(metrics["aux"]) - want["aux"]),
                   grad_norm=gnorm, want_grad_norm=want["grad_norm"],
                   worst_leaf_err=worst, worst_leaf=worst_leaf,
                   leaf_tol=tol["leaf"], finite=finite, two_runs_equal=same,
                   rg_lru_scan=counts["rg_lru_scan"],
                   rg_lru_scan_bwd=counts["rg_lru_scan_bwd"],
                   expected=[2 * n_rg, n_rg])
        ok = (finite and same and res["loss_err"] <= tol["loss"]
              and res["aux_err"] <= tol["loss"] and worst <= tol["leaf"]
              and abs(gnorm - want["grad_norm"]) <= tol["leaf"]
              * want["grad_norm"]
              and [res["rg_lru_scan"], res["rg_lru_scan_bwd"]]
              == res["expected"])
        results.append(dict(res, ok=ok))
        if not ok:
            failed.append(v)
    traj_rows = []
    for key, want in ref["trajectories"].items():
        arch, config = key.split(":")
        a = _trajectory(arch, config, ref["trajectory"])
        b = _trajectory(arch, config, ref["trajectory"])
        same = a["loss"] == b["loss"] and all(
            bit_equal(x, y) for x, y in zip(a["params"], b["params"]))
        err = max(abs(x - y) for x, y in zip(a["loss"], want["loss"]))
        gerr = max(abs(x - y) / y for x, y in zip(a["grad_norm"],
                                                  want["grad_norm"]))
        ok = (same and err <= TRAIN_TRAJ_TOL and gerr <= TRAIN_TRAJ_TOL
              and all(np.isfinite(a["loss"])))
        traj_rows.append(dict(run=key, loss=a["loss"],
                              want_loss=want["loss"], loss_err=err,
                              grad_norm_rel_err=gerr, lr=a["lr"],
                              two_runs_equal=same, ok=ok))
        if not ok:
            failed.append(key)
    emit({"phase": "train_check", "config": "SMOKE",
          "tolerance": {"variants": TRAIN_TOL,
                        "trajectory_loss": TRAIN_TRAJ_TOL},
          "variants": results, "trajectories": traj_rows})
    if failed:
        raise PhaseFailed(f"training differs from the JAX reference: "
                          f"{failed}")


def phase_train_full(params):
    """recurrentgemma-2b at full width: AdamW steps through
    `train.step.make_train_step` with the launcher's WSD schedule, on the
    serving phase's weights, batches from `data.pipeline.Batcher(seed=1)`;
    one warm-up step, then TRAIN_FULL['steps'] timed, each with its RG-LRU
    launches counted (n_rg x 2 forward, n_rg backward), then one step under
    the profiler (device ms by kernel, idle share).  Returns (the backward
    scan's launches in the timed steps, layer 0's backward inputs, the
    phase's main numbers)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(LM_ARCH)
    B, T, n = TRAIN_FULL["batch"], TRAIN_FULL["seq"], TRAIN_FULL["steps"]
    total = n + 2
    sched = schedules.wsd(TRAIN_FULL["lr"], warmup=min(100, total // 10 + 1),
                          stable=total, decay=max(total // 10, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_state.create(params)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    step = train_step.make_train_step(cfg, lr_schedule=sched)
    data = iter(pipeline.Batcher(cfg, B, T, seed=1, device="cuda"))
    last_bwd = {}
    real_bwd = krg.rg_lru_scan_bwd

    def keep(a, h0, h, gh):
        last_bwd.update(a=a, h0=h0, h=h, gh=gh)   # layer 0 is the last
        return real_bwd(a, h0, h, gh)

    losses, lrs, norms, walls, counts = [], [], [], [], []
    try:
        krg.rg_lru_scan_bwd = keep
        t0 = time.perf_counter()
        state, m = step(state, next(data))          # warm-up
        losses.append(float(m["loss"]))
        warm_s = time.perf_counter() - t0
    finally:
        krg.rg_lru_scan_bwd = real_bwd
    layer0 = tuple(last_bwd[k] for k in ("a", "h0", "h", "gh"))
    for _ in range(n):
        batch = next(data)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))             # a sync
        walls.append(time.perf_counter() - t0)
        c = ops.launch_counts()
        counts.append([c["rg_lru_scan"], c["rg_lru_scan_bwd"]])
        lrs.append(float(m["lr"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        prof_wall = time.perf_counter() - t0
    rows = sorted(((us, k, c) for k, us, c in device_kernel_events(prof)),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    scan = {k: sum(us for us, name, _ in rows if k + "(" in name)
            for k in ("rg_lru_scan_kernel", "rg_lru_scan_bwd_kernel")}
    n_rg = _n_rg(cfg)
    ms = statistics.median(walls) * 1e3
    finite = all(np.isfinite(losses))
    launches_ok = all(c == [2 * n_rg, n_rg] for c in counts)
    n_params = lm.param_count(params)
    line = {"phase": "train_full", "arch": LM_ARCH, "dtype": cfg.dtype,
          "params": n_params, "expected_params": TRAIN_FULL_PARAMS,
          "batch": B, "seq": T, "tokens_per_step": B * T,
          "create_s": create_s, "warmup_step_s": warm_s,
          "ms_per_step": ms, "step_walls_s": walls,
          "tokens_per_s": B * T / (ms * 1e-3),
          "max_memory_allocated_bytes": peak,
          "losses": losses, "all_losses_finite": finite, "lr": lrs,
          "grad_norm": norms,
          "launches_per_step": counts, "expected_per_step": [2 * n_rg, n_rg],
          "profiled_step_wall_s": prof_wall,
          "device_busy_ms": busy_us * 1e-3 if rows else None,
          "device_idle_share": (1.0 - busy_us * 1e-6 / prof_wall) if rows
          else None,
          "scan_device_ms": {k: v * 1e-3 for k, v in scan.items()},
          "top": [dict(name=k[:90], device_ms=us * 1e-3, calls=c)
                  for us, k, c in rows[:12]],
          "layer0_scan_shape": list(layer0[0].shape)}
    emit(line)
    del state, m
    if not (finite and launches_ok and n_params == TRAIN_FULL_PARAMS):
        raise PhaseFailed("full-width training failed its gates")
    keep = ("ms_per_step", "tokens_per_s", "max_memory_allocated_bytes",
            "losses", "launches_per_step", "device_busy_ms",
            "device_idle_share", "scan_device_ms")
    return sum(c[1] for c in counts), layer0, {k: line[k] for k in keep}


def main() -> int:
    from concurrent.futures import ThreadPoolExecutor
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        card = phase_card()
        lookup = phase_build()
        phase_attn_sass()
        t0 = time.perf_counter()
        # one connectivity build for both deliveries: the event program's
        # plan and initial state are the dense program's
        sp8e = _program(GridConfig(grid_x=8, grid_y=8),
                        EngineConfig(delivery="event"))
        sp8 = StepProgram.from_parts(
            sp8e.spec._replace(eng=EngineConfig()), sp8e.plan,
            sp8e.init_state().base)
        emit({"phase": "build_8x8", "seconds": time.perf_counter() - t0,
              "synapses": int(sp8.plan.row_ptr[:, -1].sum()),
              "cap_ev": sp8e.cap_ev,
              "fwd_rows": list(sp8e.eplan.fwd_rows.shape),
              "in_rows": list(sp8e.eplan.in_rows.shape)})
        rows = phase_kernels(sp8.plan, sp8.spec, sp8e, lookup)
        with _shared_tables():
            phase_check()
        launches = phase_timed(sp8, sp8e)
        phase_profile(sp8, sp8e)
        t0 = time.perf_counter()
        sp8s = _stream_program(GridConfig(grid_x=8, grid_y=8), 1)
        build_s = time.perf_counter() - t0
        rows += phase_stream_kernels(sp8s)
        phase_stream_check()
        launches.update(phase_stream_timed(sp8s, sp8, build_s))
        ckpt8 = _ckpt8_state(sp8)
        del sp8, sp8e, sp8s      # so that the later peaks are their own
        torch.cuda.empty_cache()
        shard_id_launches = phase_mesh(card)
        torch.cuda.empty_cache()
        # the plans' cells, the cluster check's ranks and cluster_scaling's
        # are other processes, mostly start-up on the host: they run beside
        # the checkpoint and service checks, which they do not touch (their
        # launch counts are this process's); the lines mark their times as
        # contended
        with ThreadPoolExecutor(2) as ex:
            plans_run = ex.submit(run_plans)
            cluster_run = ex.submit(
                lambda: (run_cluster(), _run_cluster_scaling()))
            phase_ckpt(card, ckpt8,
                       beside="the plan phase's cells, cluster_check's and "
                              "cluster_scaling's ranks")
            del ckpt8
            torch.cuda.empty_cache()
            with _shared_tables():
                simserve_launches = phase_simserve_check(
                    card, beside="the plan phase's cells, cluster_check's "
                                 "and cluster_scaling's ranks")
            _TABLES.clear()
            plans_result = plans_run.result()
            cluster_result, scaling = cluster_run.result()
        phase_cluster(card, cluster_result,
                      beside="ckpt_check, simserve_check and the plan "
                             "phase's cells")
        phase_plan(card, plans_result,
                   beside="ckpt_check, simserve_check, cluster_check, "
                          "cluster_scaling and the other plan")
        torch.cuda.empty_cache()
        phase_simserve_timed(card)
        torch.cuda.empty_cache()
        phase_bench(scaling)
        torch.cuda.empty_cache()
        lm_rows = phase_lm_kernels()
        attn_rows, attn_launches = phase_attn_kernels()
        phase_lm_check()
        params, lm_launches = phase_lm_serve()
        phase_lm_profile(params)
        train_launches, layer0, train_summary = phase_train_full(params)
        del params
        torch.cuda.empty_cache()
        train_rows = phase_train_kernels(layer0)
        del layer0
        torch.cuda.empty_cache()
        phase_train_check()
        phase_lm_families_check()
        phase_lm_families_serve()
        phase_lm_frontends_check()
        phase_lm_frontends_serve()
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for r in rows:
        # the timed eager runs launched every other SNN kernel 0 times
        # (phase_timed checks it); the t_base forms' launches are those of
        # simserve_check's service run, the shard-id form's those of
        # mesh_check's streamed scatter cells (rank 0)
        name = r["name"]
        if name.endswith("[t_base]"):
            r["launches"] = simserve_launches.get(name[:-len("[t_base]")], 0)
        elif name.endswith("[shard_id]"):
            r["launches"] = shard_id_launches
        else:
            r["launches"] = launches.get(name, 0)
    rows.append(dict(lm_rows[0], launches=lm_launches))   # prefill shape
    rows.append(dict(attn_rows[0], launches=attn_launches))  # rg_local_prefill
    # the training shape (B = 4, T = 512); its launches are train_full's
    rows.append(dict(train_rows[1], launches=train_launches))
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    # the training phases' numbers again, and the card's name and power
    # limit, where the end of the output keeps them
    emit({"train_full": train_summary, "train_kernels": [
        {k: r[k] for k in ("ms", "device_ms", "bound_ms", "plain_ms")}
        | {"shape": r["shape"]["label"]} for r in train_rows]})
    print(card, flush=True)
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def import_port() -> None:
    """Import the port as this script's globals, the names its phases use
    (a script that runs some phases alone calls this first).  The CPU
    plain versions are yardsticks, so their bits must not depend on the
    host: ATen's and MKL's CPU kernels otherwise dispatch on the host's
    vector instruction set (AVX-512, AVX2, ...), and the plain attention's
    bits follow it (`tests/test_torch_cuda.py --softcap-isa`).  Pin both
    to the code paths every x86-64 host runs alike, before torch starts."""
    os.environ.update(ATEN_CPU_CAPABILITY="default", MKL_CBWR="COMPATIBLE")
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.bench import profile as bench_profile
    from repro_torch.bench import timing
    from repro_torch import simserve
    from repro_torch.bench.suites import (connectivity_sweep, event_vs_dense,
                                          simserve_throughput, table1, table2)
    from repro_torch.cluster import cli as cluster_cli
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  aer, connectivity, engine, event_engine,
                                  observables, stimulus, stream_engine)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import arborize as karb
    from repro_torch.kernels import event as kev
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import izhikevich as kizh
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rg_lru as krg
    from repro_torch.kernels import segment_sum as kseg
    from repro_torch.kernels import stdp as kstdp
    from repro_torch.data import pipeline
    from repro_torch.models import convert, lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import grad_utils as optim_grad_utils
    from repro_torch.optim import schedules
    from repro_torch.train import step as train_step
    from repro_torch.train import train_state
    from repro_torch.serve import engine as serve_engine
    from repro_torch.serve import sampling
    globals().update(locals())


if __name__ == "__main__":
    import_port()
    sys.exit(main())
