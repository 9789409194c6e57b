"""Time the chunk-regeneration kernel (`ops.chunk_tables`, row S) of two
source trees on one card.

    python3 scripts/stream_ab.py OLD_TREE NEW_TREE [--rounds 2]

Each tree is a checkout of this repo (its `src/` goes first on the
PYTHONPATH of a fresh interpreter, which imports that tree's
`chip_smoke.py` for its timing helpers).  The trees run alternately, A B B
A a round, each run in its own process: the 8x8 full-width streamed
program (K = 1, H = 1, 64 chunks) built on the card, then `chunk_tables`
at its first, interior and last chunk: the device time of the three
stages (gen, scan, sort) by `torch.profiler`, `SESSIONS` sessions of
`CALLS` calls, and each stage alone, and the CUDA-event time of a call.
One JSON line a run and chunk: the tree, each session's device ms, their
median, the stages' medians, the event ms, and a digest of the tables,
which must be equal across trees.  Then the card's name and power limit.
"""
import sys

import _tree_ab

SESSIONS = 7
CALLS = 20

_CHILD = r"""
import hashlib, json, statistics, sys
tree, sessions, calls = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
sys.path.insert(0, tree)
import chip_smoke as cs
cs.import_port()
import torch
from repro_torch.core import stream_engine
sp = cs._stream_program(cs.GridConfig(grid_x=8, grid_y=8), 1)
live = stream_engine.ChunkStream(sp.spec, sp.plan, sp.splan)
n = sp.spec.stream.n_chunks
for label, c in (("first", 0), ("interior", n // 2), ("last", n - 1)):
    launch = lambda: live.regenerate(c)
    got = launch()
    torch.cuda.synchronize()
    rp = got.row_ptr.cpu()
    k = int(rp[0, -1] - rp[0, 0])
    digest = hashlib.sha256(rp.numpy().tobytes())
    for x in got[1:]:
        digest.update(x[:, :k].cpu().numpy().tobytes())
    runs = [cs.device_ms(launch, calls=calls, kernel=cs.CHUNK_KERNELS)
            for _ in range(sessions)]
    stages = {s: statistics.median(
        cs.device_ms(launch, calls=calls, kernel=s) for _ in range(3))
        for s in cs.CHUNK_KERNELS}
    print(json.dumps(dict(
        tree=tree, chunk=label, c=c, device_ms=statistics.median(runs),
        sessions_device_ms=runs, stages_device_ms=stages,
        event_ms=cs.cuda_ms(launch), status=int(live.status[0]),
        digest=digest.hexdigest()[:16])), flush=True)
"""


def main(argv=None) -> int:
    return _tree_ab.main(__doc__, _CHILD, (SESSIONS, CALLS), "chunk",
                         timeout=900, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
