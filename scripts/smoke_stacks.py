"""Run chip_smoke.py under a stack sampler: where its main thread spends
its time.

    python3 scripts/smoke_stacks.py [--out PATH]

Runs chip_smoke.py as `python3 chip_smoke.py` would (its output, its exit
code) while a thread samples the main thread's Python stack every 0.2 s,
and writes to PATH (default `results/smoke_stacks.json` under the
repository) the seconds each function was on the stack (inclusive), the
seconds each was the innermost frame, and the seconds of each chain of
the script's own functions (its last four).  Other processes (rank jobs,
plan cells) are not sampled: their time shows as the waits on them.  The
file is rewritten every 20 s, so a run cut short keeps its samples.
"""
import collections
import json
import os
import runpy
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 0.2
MARKS = ("chip_smoke.py", "repro_torch/", "torch/", "numpy/")


def _key(frame) -> str:
    name = frame.f_code.co_filename
    for mark in MARKS:
        i = name.find(mark)
        if i >= 0:
            name = name[i:]
            break
    else:
        name = os.path.basename(name)
    return f"{name}:{frame.f_code.co_name}"


class Sampler:
    def __init__(self, thread_id: int, out: str):
        self.thread_id, self.out = thread_id, out
        self.incl = collections.Counter()
        self.leaf = collections.Counter()
        self.chains = collections.Counter()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        n = 0
        while not self.stop.wait(DT):
            frame = sys._current_frames().get(self.thread_id)
            if frame is None:
                continue
            stack = []
            while frame is not None:
                stack.append(_key(frame))
                frame = frame.f_back
            self.incl.update(set(stack))
            self.leaf[stack[0]] += 1
            own = [s for s in reversed(stack)
                   if s.startswith("chip_smoke.py")]
            self.chains[" > ".join(own[-4:])] += 1
            n += 1
            if n % 100 == 0:
                self.dump()

    def dump(self) -> None:
        secs = lambda c, k: {key: v * DT for key, v in c.most_common(k)}
        with open(self.out, "w") as f:
            json.dump({"dt": DT, "inclusive_s": secs(self.incl, 400),
                       "leaf_s": secs(self.leaf, 150),
                       "chip_smoke_chains_s": secs(self.chains, 300)},
                      f, indent=0)


def main(argv) -> int:
    out = (argv[argv.index("--out") + 1] if "--out" in argv
           else os.path.join(HERE, "results", "smoke_stacks.json"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    sampler = Sampler(threading.get_ident(), out)
    sampler.thread.start()
    script = os.path.join(HERE, "chip_smoke.py")
    sys.argv = [script]
    sys.path.insert(0, HERE)
    rc = 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        rc = e.code or 0
    finally:
        sampler.stop.set()
        sampler.thread.join()
        sampler.dump()
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
