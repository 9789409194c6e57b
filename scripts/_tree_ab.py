"""Run one child program over two source trees on one card, A B B A a
round, and check that their outputs agree (the loop that
`exchange_ab.py` and `stream_ab.py` share).

Each tree is a checkout of this repo: a run is `python -c CHILD TREE
ARGS...` in a fresh interpreter with the tree's `src/` on its PYTHONPATH
and the tree as its working directory.  Every JSON line a run prints is
echoed; its `digest` must be the same, for each value of its `key`,
across all runs.  Then the card's name and power limit, and a last line
`{"outputs_equal_across_trees": ...}`; the exit code is 1 when a run
failed or the digests differ.
"""
import argparse
import json
import os
import subprocess
import sys


def main(doc: str, child: str, child_args, key: str, timeout: float,
         argv=None) -> int:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("trees", nargs=2)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    a, b = (os.path.abspath(t) for t in args.trees)
    digests = {}
    for tree in [a, b, b, a] * args.rounds:
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        out = subprocess.run(
            [sys.executable, "-c", child, tree, *map(str, child_args)],
            env=env, cwd=tree, capture_output=True, text=True,
            timeout=timeout)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                continue
            print(line, flush=True)
            row = json.loads(line)
            digests.setdefault(row[key], set()).add(row["digest"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    same = all(len(d) == 1 for d in digests.values())
    print(json.dumps(dict(outputs_equal_across_trees=same)))
    return 0 if same else 1
