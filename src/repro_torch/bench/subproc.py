"""Fresh-interpreter ranks of a `torch.distributed` job (the part of
`repro.bench.subproc` the mesh needs).

    out = run_ranks(code, 4, device="cpu", timeout=120)

starts four `python -c code` interpreters as the ranks of one job (the
REPRO_CLUSTER_* variables, `repro_torch._flags.cluster_env`: rank 0's
store on a free localhost port, or a "file://" store when `store=` names
a path, so that parallel test workers never collide on a port), and
returns the primary's standard output.  The code joins the job with
`repro_torch.cluster.runtime.ensure_initialized()`.  A rank that fails
or outlives the timeout fails the job: every rank is killed, and the
raised `RanksError` carries each rank's exit code and output tails.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import repro_torch
from repro_torch._flags import cluster_env

# src/ directory holding `repro_torch`, put first on the ranks' PYTHONPATH
SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))

#: Seconds a job may run when its caller gives no timeout: the suites'
#: full-size jobs end well inside it, and a hung rank holds no one longer.
DEFAULT_TIMEOUT = 600.0


class RanksError(RuntimeError):
    """A rank failed or timed out; `returncodes` holds each rank's exit
    code (None: killed at the timeout or for a peer's failure)."""

    def __init__(self, msg: str, returncodes: List[Optional[int]]):
        self.returncodes = returncodes
        super().__init__(msg)


def free_port() -> int:
    """A localhost TCP port no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, limit: int = 3000) -> str:
    with open(path, errors="replace") as f:
        text = f.read()
    return text[-limit:] if text else "<no output>"


class Ranks:
    """`code` started as the `n_ranks` ranks of a job on `device` ("cpu"
    or "cuda"; None leaves it to the ranks, which run on the card);
    `wait()` gives the primary's output (see the module docstring).  A
    timeout of None is `DEFAULT_TIMEOUT`."""

    def __init__(self, code: str, n_ranks: int, *,
                 device: Optional[str] = None,
                 timeout: Optional[float] = None,
                 store: Optional[str] = None):
        self.timeout = DEFAULT_TIMEOUT if timeout is None else timeout
        self._dir = tempfile.TemporaryDirectory()
        coord = (f"file://{os.path.abspath(store)}" if store is not None
                 else f"127.0.0.1:{free_port()}")
        self.procs, self.logs = [], []
        for r in range(n_ranks):
            env = cluster_env(SRC, coordinator=coord, num_processes=n_ranks,
                              process_id=r, device=device)
            out = os.path.join(self._dir.name, f"rank{r}.out")
            err = os.path.join(self._dir.name, f"rank{r}.err")
            self.logs.append((out, err))
            with open(out, "w") as fo, open(err, "w") as fe:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], env=env, stdout=fo,
                    stderr=fe, stdin=subprocess.DEVNULL))
        self.started = time.monotonic()

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _report(self, why: str) -> str:
        parts = [why]
        for r, (p, (out, err)) in enumerate(zip(self.procs, self.logs)):
            parts.append(f"--- rank {r}: exit {p.returncode}\n"
                         f"stdout tail:\n{_tail(out)}\n"
                         f"stderr tail:\n{_tail(err)}")
        return "\n".join(parts)

    def wait(self) -> str:
        """The primary's standard output once every rank exited 0; raises
        RanksError (after killing the rest) at the first failure or at the
        timeout."""
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    self._kill()
                    raise RanksError(self._report(
                        f"rank {bad[0]} failed with exit code "
                        f"{codes[bad[0]]}"), [p.returncode
                                              for p in self.procs])
                if all(c == 0 for c in codes):
                    with open(self.logs[0][0]) as f:
                        return f.read()
                if time.monotonic() - self.started > self.timeout:
                    self._kill()
                    raise RanksError(self._report(
                        f"ranks timed out after {self.timeout} s"),
                        [None] * len(self.procs))
                time.sleep(0.05)
        finally:
            self._kill()
            self._dir.cleanup()


def run_ranks(code: str, n_ranks: int, *, device: Optional[str] = None,
              timeout: Optional[float] = None,
              store: Optional[str] = None) -> str:
    """`Ranks(...).wait()`: the primary's standard output."""
    return Ranks(code, n_ranks, device=device, timeout=timeout,
                 store=store).wait()


#: The prefix of a result line a rank prints (`emit`, `results`).
RESULT = "RESULT "


def emit(obj) -> None:
    """Print one result line (JSON) from the primary rank."""
    print(RESULT + json.dumps(obj), flush=True)


def results(out: str) -> list:
    """The JSON objects of the result lines of a rank's output."""
    return [json.loads(line[len(RESULT):]) for line in out.splitlines()
            if line.startswith(RESULT)]


def call_ranks(fn: str, args, n_ranks: int, *,
               device: Optional[str] = None,
               timeout: Optional[float] = None,
               store: Optional[str] = None) -> list:
    """Run `module:function`(args) on each of `n_ranks` fresh ranks after
    they joined the job; returns the primary's result lines (`emit`).
    `args` must be a literal (it goes into the ranks' code by repr)."""
    module, name = fn.split(":")
    code = (f"from repro_torch.cluster import runtime\n"
            f"runtime.ensure_initialized()\n"
            f"from {module} import {name}\n"
            f"{name}({args!r})\n")
    return results(run_ranks(code, n_ranks, device=device, timeout=timeout,
                             store=store))
