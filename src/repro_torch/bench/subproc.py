"""Fresh interpreters: one alone (`run_subprocess`, a plan cell), or the
ranks of a `torch.distributed` job (`run_ranks`; port of
`repro.bench.subproc`).

    out = run_subprocess(code, timeout=600)

runs `python -c code` with the port's `src` first on its path and returns
its standard output; a failure or a timeout raises `SubprocessError`
with the exit code and the output's tails.  No device count is forced:
a cell's H shards are stacked on one device.

    out = run_ranks(code, 4, device="cpu", timeout=120)

starts four `python -c code` interpreters as the ranks of one job (the
REPRO_CLUSTER_* variables, `repro_torch._flags.cluster_env`: rank 0's
store on a free localhost port, or a "file://" store when `store=` names
a path, so that parallel test workers never collide on a port), and
returns the primary's standard output.  The code joins the job with
`repro_torch.cluster.runtime.ensure_initialized()`.  A rank that fails
or outlives the timeout fails the job: every rank is reaped (SIGTERM,
then SIGKILL for a rank that ignores it, `reap`), and the raised
`RanksError` carries each rank's exit code and output.

The cluster launcher (`cluster.local`) starts its workers the same way,
as `Ranks(None, n, argv=["-m", "repro_torch.cluster.worker", ...],
env=...)`, and watches them with `wait_all(watch)`: `watch` is called
while the ranks run and ends the job with its reason (a stalled gang)."""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import repro_torch
from repro_torch._flags import cluster_env

# src/ directory holding `repro_torch`, put first on the ranks' PYTHONPATH
SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))

#: Seconds a job may run when its caller gives no timeout: the suites'
#: full-size jobs end well inside it, and a hung rank holds no one longer.
DEFAULT_TIMEOUT = 600.0


class SubprocessError(RuntimeError):
    """A fresh interpreter failed or timed out; `returncode` is its exit
    code (None on a timeout), `stdout` and `stderr` its output's tails."""

    def __init__(self, msg: str, returncode: Optional[int] = None,
                 stdout: str = "", stderr: str = ""):
        self.returncode = returncode
        self.stdout = stdout
        self.stderr = stderr
        super().__init__(msg)


def _text_tail(stream, limit: int = 2000) -> str:
    if stream is None:
        return "<no output captured>"
    if isinstance(stream, bytes):
        stream = stream.decode("utf-8", errors="replace")
    return stream[-limit:] if stream else "<no output captured>"


def resolve_timeout(timeout: Optional[float]) -> float:
    """An explicit timeout, else `DEFAULT_TIMEOUT`."""
    return DEFAULT_TIMEOUT if timeout is None else timeout


def run_subprocess(code: str, timeout: Optional[float] = None) -> str:
    """Run `code` in a fresh interpreter with the port's `src` first on
    PYTHONPATH; returns its standard output.  On a timeout the child is
    killed; any failure raises `SubprocessError`."""
    timeout = resolve_timeout(timeout)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, env=env,
                             timeout=timeout, stdin=subprocess.DEVNULL)
    except subprocess.TimeoutExpired as e:
        raise SubprocessError(
            f"bench subprocess timed out after {timeout}s\n"
            f"stdout tail:\n{_text_tail(e.stdout)}\n"
            f"stderr tail:\n{_text_tail(e.stderr)}",
            returncode=None, stdout=_text_tail(e.stdout),
            stderr=_text_tail(e.stderr)) from e
    if out.returncode != 0:
        raise SubprocessError(
            f"bench subprocess failed with exit code {out.returncode}:\n"
            f"stdout tail:\n{_text_tail(out.stdout)}\n"
            f"stderr tail:\n{_text_tail(out.stderr)}",
            returncode=out.returncode, stdout=out.stdout or "",
            stderr=out.stderr or "")
    return out.stdout


class RanksError(RuntimeError):
    """A rank failed, timed out or was stopped by a watch; `returncodes`
    holds each rank's exit code as it was when the job ended (None: still
    running, then reaped), `outputs` each rank's standard output and
    error, `reason` the first line and `reaped` what `reap` did."""

    def __init__(self, msg: str, returncodes: List[Optional[int]],
                 outputs: Sequence[str] = (), reason: str = "",
                 reaped: Optional[dict] = None):
        self.returncodes = returncodes
        self.outputs = list(outputs)
        self.reason = reason or msg.splitlines()[0]
        self.reaped = reaped or dict(terminated=[], killed=[])
        super().__init__(msg)


def reap(procs, total_timeout: float = 5.0) -> dict:
    """Terminate, then kill, every process still running: one shared
    grace period for all of them.  Returns {"terminated": [...],
    "killed": [...]}: which ones got SIGTERM, and which of those ignored
    it and needed SIGKILL."""
    info = dict(terminated=[], killed=[])
    for i, p in enumerate(procs):
        if p.poll() is None:
            info["terminated"].append(i)
            p.terminate()
    deadline = time.monotonic() + total_timeout
    for i, p in enumerate(procs):
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                info["killed"].append(i)
                p.kill()
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
    return info


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
    timeout of None is `DEFAULT_TIMEOUT`.  `argv` (with `code` None) are
    the interpreter's arguments instead of `-c code`; `env` adds
    variables to every rank's environment; `tuned` starts them under
    `_flags.tuned_host_env`."""

    def __init__(self, code: Optional[str], n_ranks: int, *,
                 device: Optional[str] = None,
                 timeout: Optional[float] = None,
                 store: Optional[str] = None,
                 argv: Optional[Sequence[str]] = None,
                 env: Optional[dict] = None, tuned: bool = False):
        if (code is None) == (argv is None):
            raise ValueError("give either code or argv")
        self.timeout = DEFAULT_TIMEOUT if timeout is None else timeout
        self._dir = tempfile.TemporaryDirectory()
        coord = (f"file://{os.path.abspath(store)}" if store is not None
                 else f"127.0.0.1:{free_port()}")
        args = ["-c", code] if argv is None else list(argv)
        self.procs, self.logs = [], []
        for r in range(n_ranks):
            rank_env = cluster_env(SRC, coordinator=coord,
                                   num_processes=n_ranks, process_id=r,
                                   device=device, tuned=tuned)
            rank_env.update(env or {})
            out = os.path.join(self._dir.name, f"rank{r}.out")
            err = os.path.join(self._dir.name, f"rank{r}.err")
            self.logs.append((out, err))
            with open(out, "w") as fo, open(err, "w") as fe:
                self.procs.append(subprocess.Popen(
                    [sys.executable, *args], env=rank_env, stdout=fo,
                    stderr=fe, stdin=subprocess.DEVNULL))
        self.started = time.monotonic()

    def _report(self, why: str) -> str:
        parts = [why]
        for r, (p, (out, err)) in enumerate(zip(self.procs, self.logs)):
            parts.append(f"--- rank {r}: exit {p.returncode}\n"
                         f"stdout tail:\n{_tail(out)}\n"
                         f"stderr tail:\n{_tail(err)}")
        return "\n".join(parts)

    def outputs(self) -> List[str]:
        """Each rank's standard output, then its standard error."""
        texts = []
        for out, err in self.logs:
            parts = []
            for path in (out, err):
                with open(path, errors="replace") as f:
                    parts.append(f.read())
            texts.append("".join(parts))
        return texts

    def wait(self) -> str:
        """The primary's standard output once every rank exited 0; raises
        RanksError (after reaping the rest) at the first failure or at the
        timeout."""
        self.wait_all()
        return self._stdout0

    def wait_all(self, watch: Optional[Callable[[], Optional[str]]] = None
                 ) -> List[str]:
        """`wait`, returning every rank's output (`outputs`); `watch()`,
        called while the ranks run, ends the job with the reason it
        returns."""
        why = None
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    why = (f"rank {bad[0]} failed with exit code "
                           f"{codes[bad[0]]}")
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() - self.started > self.timeout:
                    why = f"ranks timed out after {self.timeout} s"
                elif watch is not None:
                    why = watch()
                if why:
                    codes = [p.poll() for p in self.procs]
                    reaped = reap(self.procs)
                    raise RanksError(self._report(why), codes,
                                     self.outputs(), why, reaped)
                time.sleep(0.05)
            with open(self.logs[0][0]) as f:
                self._stdout0 = f.read()
            return self.outputs()
        finally:
            reap(self.procs)
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
