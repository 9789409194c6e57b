"""Deterministic fault injection + progress beacons for cluster workers
(the port's own copy of `repro.cluster.faults`: the same grammar,
variables, exit codes and beacon protocol).

Every failure mode the supervisor must survive is a *reproducible test
case*, not a flake: the `REPRO_FAULT` environment variable arms exactly
one fault on exactly one worker, keyed to an exact simulation step, and
the supervised launcher (`local.supervised_launch`) injects it into the
FIRST attempt only: recovery attempts run clean, so a recovered run
terminates and its outputs can be compared bit-for-bit against the
fault-free reference.

Injection grammar (`REPRO_FAULT=`):

    crash@step=N[:rank=R]      worker R hard-exits (os._exit, no atexit:
                               a process death, not an exception) at the
                               chunk boundary covering step N
    hang@step=N[:rank=R]       worker R blocks forever at that boundary;
                               its gang-mates stall in the next collective
                               and the parent's beacon stall detector (not
                               a blunt global deadline) catches it
    slow@step=N:ms=M[:rank=R]  worker R sleeps M ms once (a straggler);
                               a supervisor with an adequate stall budget
                               must NOT kill the gang for this
    corrupt_ckpt[@step=N]      after the periodic checkpoint at the first
                               epoch >= N is written, the writer truncates
                               it on disk and hard-exits: recovery must
                               detect the corruption (sha256) and fall
                               back to the previous epoch
    drop_result                the worker runs to completion but never
                               emits its CLUSTER_RESULT line (a lost
                               report, exit code 0)

Faults fire at chunk boundaries (the checkpoint/beacon cadence), which is
what makes them deterministic: "crash at step N" means "crash having
completed exactly the chunks before N", so the surviving state on disk is
a pure function of the spec.

This module is stdlib only: the parent imports it for the grammar and
the beacon reader without touching torch or a device, workers import it
for the injector and the beacon writer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional

ENV_FAULT = "REPRO_FAULT"          # injection spec, armed by the supervisor
ENV_BEACON_DIR = "REPRO_BEACON_DIR"  # per-attempt beacon directory
ENV_ATTEMPT = "REPRO_ATTEMPT"      # supervisor attempt index (0 = first)

EXIT_CRASH = 41                    # deliberate crash-fault exit code
EXIT_CORRUPT = 43                  # exit after corrupting a checkpoint

KINDS = ("crash", "hang", "slow", "corrupt_ckpt", "drop_result")
_GRAMMAR = ("crash@step=N[:rank=R] | hang@step=N[:rank=R] | "
            "slow@step=N:ms=M[:rank=R] | corrupt_ckpt[@step=N[:rank=R]] | "
            "drop_result[@rank=R]")

# routed through module globals so unit tests can intercept the
# irreversible actions without dying
_hard_exit = os._exit
_sleep = time.sleep


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed fault: what, where (rank), and when (step)."""
    kind: str
    step: int = 0
    rank: int = 0
    ms: int = 0

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """`kind[@key=val[:key=val...]]` -> FaultSpec; ValueError names
        the grammar on any unknown kind/key or malformed value."""
        text = text.strip()
        kind, _, tail = text.partition("@")
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {text!r}; grammar: "
                f"{_GRAMMAR}")
        kw = {}
        if tail:
            for part in tail.split(":"):
                key, eq, val = part.partition("=")
                if not eq or key not in ("step", "rank", "ms"):
                    raise ValueError(
                        f"bad fault parameter {part!r} in {text!r}; "
                        f"grammar: {_GRAMMAR}")
                try:
                    kw[key] = int(val)
                except ValueError:
                    raise ValueError(
                        f"fault parameter {key}={val!r} is not an integer "
                        f"({text!r})") from None
        if kind == "slow" and "ms" not in kw:
            raise ValueError(f"slow fault needs ms=M ({text!r}); grammar: "
                             f"{_GRAMMAR}")
        return cls(kind=kind, **kw)

    def spec(self) -> str:
        """Canonical grammar string (defaults omitted); parse(spec())
        round-trips."""
        parts = [f"{k}={v}" for k, v in (("step", self.step),
                                         ("ms", self.ms),
                                         ("rank", self.rank)) if v]
        return self.kind + ("@" + ":".join(parts) if parts else "")


class FaultInjector:
    """Worker-side hook points.  Disarmed (every hook a no-op) unless
    `REPRO_FAULT` is set AND this worker's rank matches the spec's."""

    def __init__(self, spec: Optional[FaultSpec], rank: int):
        self.spec = spec
        self.rank = rank
        self._fired = False

    @classmethod
    def from_env(cls, rank: int) -> "FaultInjector":
        raw = os.environ.get(ENV_FAULT, "").strip()
        return cls(FaultSpec.parse(raw) if raw else None, rank)

    @property
    def armed(self) -> bool:
        return (self.spec is not None and not self._fired
                and self.rank == self.spec.rank)

    def on_chunk(self, t_start: int, t_end: int) -> None:
        """Called at each chunk boundary BEFORE running [t_start, t_end).
        Fires crash/hang/slow whose step falls inside the chunk."""
        if not self.armed or self.spec.kind not in ("crash", "hang",
                                                    "slow"):
            return
        if not (t_start <= self.spec.step < t_end):
            return
        self._fired = True
        kind = self.spec.kind
        print(f"[fault] {self.spec.spec()} firing at chunk "
              f"[{t_start},{t_end}) on rank {self.rank}", flush=True)
        if kind == "crash":
            sys.stdout.flush()
            _hard_exit(EXIT_CRASH)
        elif kind == "hang":
            while True:                  # reaped by the parent, never returns
                _sleep(60.0)
        elif kind == "slow":
            _sleep(self.spec.ms / 1000.0)

    def on_checkpoint_written(self, path: str, t: int) -> None:
        """Called by the checkpoint WRITER after each periodic epoch hits
        disk.  corrupt_ckpt truncates the file (a simulated torn write /
        disk corruption the sha256 digest must catch) and hard-exits."""
        if not self.armed or self.spec.kind != "corrupt_ckpt":
            return
        if t < self.spec.step:
            return
        self._fired = True
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size * 2 // 3))
        print(f"[fault] corrupt_ckpt truncated {path} "
              f"({size} -> {os.path.getsize(path)} bytes), exiting",
              flush=True)
        sys.stdout.flush()
        _hard_exit(EXIT_CORRUPT)

    def emit_result(self) -> bool:
        """False when the drop_result fault swallows this worker's
        CLUSTER_RESULT line."""
        if self.armed and self.spec.kind == "drop_result":
            self._fired = True
            print("[fault] drop_result swallowing CLUSTER_RESULT",
                  flush=True)
            return False
        return True


# -- progress beacons -----------------------------------------------------

class BeaconWriter:
    """Atomic per-worker progress file: `beacon_<rank>.json` in
    `REPRO_BEACON_DIR`, rewritten (tmp + os.replace — a reader never sees
    a torn write) at every phase transition and chunk boundary.  The
    device-free parent derives liveness from CHANGE, not wall-clock content:
    a worker whose beacon stops changing for longer than the stall budget
    is hung, wherever its gang-mates happen to block."""

    def __init__(self, directory: Optional[str], rank: int):
        self.dir = directory
        self.rank = rank
        if directory:
            os.makedirs(directory, exist_ok=True)

    @classmethod
    def from_env(cls, rank: int) -> "BeaconWriter":
        return cls(os.environ.get(ENV_BEACON_DIR) or None, rank)

    def write(self, step: int, phase: str, **extra) -> None:
        if not self.dir:
            return
        payload = dict(proc=self.rank, step=int(step), phase=phase,
                       time=time.time(), **extra)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(self.dir,
                                     f"beacon_{self.rank}.json"))


def read_beacons(directory: Optional[str]) -> Dict[int, dict]:
    """{rank: beacon dict} for every parseable beacon in `directory`.
    Tolerates missing dirs and torn/absent files (atomic writes make the
    latter transient)."""
    out: Dict[int, dict] = {}
    if not directory or not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not (name.startswith("beacon_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                b = json.load(f)
            out[int(b["proc"])] = b
        except (OSError, ValueError, KeyError):
            continue
    return out
