"""Time the stacked exchange wires of two source trees on one card.

    python3 scripts/exchange_ab.py OLD_TREE NEW_TREE [--rounds 2]

Each tree is a checkout of this repo (its `src/` goes first on the
PYTHONPATH of a fresh interpreter).  The trees run alternately, A B B A a
round, each run in its own process: the 8x8 full-width program (12.8 M
synapses) at H = 4 shards on the card, the spike masks of `STEPS` steps of
its phase A, then `StepProgram.phase_fns().exchange` on each mask with the
card synchronised after every call ('halo', and 'hier' in two groups of
two shards), `PASSES` passes.  One JSON line a run and wire: the tree,
ms a call (the median pass), and a digest of the outputs, which must be
equal across trees.  Then the card's name and power limit.
"""
import sys

import _tree_ab

STEPS = 50
PASSES = 5

_CHILD = r"""
import dataclasses, hashlib, json, statistics, sys, time
import torch
from repro_torch.core import EngineConfig, GridConfig, StepProgram
tree, steps, passes = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
sp0 = StepProgram(GridConfig(grid_x=8, grid_y=8),
                  EngineConfig(n_shards=4, exchange="halo"), device="cuda")
pa = sp0.phase_fns().phase_a
state, masks = sp0.init_state(), []
for t in range(steps):
    state, spiked, _ = pa(state, t)
    masks.append(spiked.clone())
for ex, groups in (("halo", None), ("hier", 2)):
    eng = dataclasses.replace(sp0.spec.eng, exchange=ex)
    sp = StepProgram.from_parts(sp0.spec._replace(eng=eng), sp0.plan,
                                sp0.init_state(), hier_groups=groups)
    exchange = sp.phase_fns().exchange
    digest = hashlib.sha256()
    for m in masks:
        digest.update(exchange(m).cpu().numpy().tobytes())
    walls = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in masks:
            exchange(m)
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / len(masks) * 1e3)
    print(json.dumps(dict(tree=tree, exchange=ex,
                          ms_per_call=statistics.median(walls),
                          passes_ms=walls,
                          spikes=int(sum(int(m.sum()) for m in masks)),
                          digest=digest.hexdigest()[:16])), flush=True)
"""


def main(argv=None) -> int:
    return _tree_ab.main(__doc__, _CHILD, (STEPS, PASSES), "exchange",
                         timeout=600, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
