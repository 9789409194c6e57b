"""Localhost launcher of cluster workers, with a supervisor (the port's
`repro.cluster.local`).

The workers are the ranks of one `torch.distributed` job, started and
reaped by `bench.subproc.Ranks` with the environment of
`_flags.cluster_env`: each attempt joins through a `file://` store of its
own (a fresh temporary directory), so no port is probed and no lost bind
race needs a retry.  The ranks run on the card unless `device="cpu"`
(REPRO_CLUSTER_DEVICE); a launch on the card never runs them on the
CPU.  There is no per-rank device count to force: a rank holds its
H / R shards through `dist.mesh.SnnMesh`.

Two launch modes:

  `launch`            one gang, one life: any worker failure raises
                      `LaunchError` (carrying exit codes, output tails,
                      any partial CLUSTER_RESULT payloads, and which
                      workers needed SIGKILL vs SIGTERM to die).
  `supervised_launch` per-worker file beacons replace the single blunt
                      deadline with *progress*-based stall detection, and
                      any gang failure triggers a reap and a relaunch of
                      the whole gang with exponential backoff under a
                      bounded restart budget.  Workers self-resume from
                      the newest VALID epoch in their `--ckpt-dir`
                      (sha256-verified, corrupt epochs skipped), so a
                      restart costs at most one checkpoint period of
                      replay and changes no output bit.

Nothing here touches a device: the parent that supervises a gang
(pytest, the CLI, a bench suite) initializes no CUDA context for it.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..bench import subproc
from . import faults
from .worker import RESULT_PREFIX

_TAIL = 2000


def partial_results(outputs: Sequence[str]) -> Dict[int, dict]:
    """{proc index: parsed CLUSTER_RESULT payload} for every worker that
    managed to emit one before the gang died: postmortem material that
    rides on `LaunchError`."""
    out: Dict[int, dict] = {}
    for i, text in enumerate(outputs):
        for ln in text.splitlines():
            if ln.startswith(RESULT_PREFIX):
                try:
                    out[i] = json.loads(ln[len(RESULT_PREFIX):])
                except ValueError:
                    pass
    return out


class LaunchError(RuntimeError):
    """A worker failed, stalled, or the launch timed out.

    Attributes: `returncodes` (per-process, None = still running when
    reaped), `outputs` (per-process stdout and stderr, possibly partial),
    `partial_results` ({proc: CLUSTER_RESULT dict} for workers that
    reported before dying), and `attempts` (supervised-launch restart
    history, [] outside supervision)."""

    def __init__(self, msg: str, returncodes: Sequence[Optional[int]],
                 outputs: Sequence[str],
                 attempts: Optional[List[dict]] = None):
        self.returncodes = list(returncodes)
        self.outputs = list(outputs)
        self.partial_results = partial_results(outputs)
        self.attempts = list(attempts or [])
        extra = ""
        if self.partial_results:
            extra += (f"\npartial CLUSTER_RESULT payloads recovered from "
                      f"proc(s) {sorted(self.partial_results)} "
                      f"(.partial_results)")
        if self.attempts:
            lines = [f"  attempt {a['index']}: {a['reason']} "
                     f"(rc={a['returncodes']}, backoff {a['backoff_s']}s)"
                     for a in self.attempts]
            extra += "\nrestart history:\n" + "\n".join(lines)
        tails = "\n".join(
            f"--- proc {i} (rc={rc}) ---\n{out[-_TAIL:] or '<no output>'}"
            for i, (rc, out) in enumerate(zip(returncodes, outputs)))
        super().__init__(f"{msg}{extra}\n{tails}")


def spawn_supported() -> bool:
    """Static check that this platform can start the localhost gang."""
    return os.name == "posix" and bool(sys.executable)


def _reap_tail(info: dict) -> str:
    if not info.get("terminated") and not info.get("killed"):
        return ""
    return (f"; reaped: SIGTERM -> procs {info.get('terminated', [])}"
            f", SIGKILL needed -> procs {info.get('killed', [])}")


def _stall_watch(stall_timeout: float, beacon_dir: Optional[str]):
    """A `Ranks.wait_all` watch: the gang is stalled when NO beacon
    changes for `stall_timeout` seconds (a hang in any one worker freezes
    the whole gang at its next collective, so gang-level change is the
    right signal and per-rank cadence differences cannot false-positive).
    """
    start = time.monotonic()
    progress: Dict[int, Tuple[tuple, float]] = {}

    def watch() -> Optional[str]:
        now = time.monotonic()
        for rank, b in faults.read_beacons(beacon_dir).items():
            sig = (b.get("step"), b.get("phase"))
            if progress.get(rank, (None, 0.0))[0] != sig:
                progress[rank] = (sig, now)
        last = max([t for _, t in progress.values()] or [start])
        if now - last <= stall_timeout:
            return None
        at = {r: s for r, (s, _) in progress.items()}
        return (f"gang stalled: no beacon progress for "
                f"{stall_timeout:.0f}s (last beacons "
                f"{at or 'none written'})")
    return watch


def launch(cmd: Sequence[str], nprocs: int, *, timeout: float = 900.0,
           device: Optional[str] = None, extra_env: Optional[dict] = None,
           echo: bool = False, tuned_env: bool = False,
           stall_timeout: Optional[float] = None,
           beacon_dir: Optional[str] = None) -> List[str]:
    """Run `cmd` (argv after the interpreter, e.g. `["-m",
    "repro_torch.cluster.worker", ...]`) as the `nprocs` ranks of one job
    on `device` ("cuda" or "cpu"; None leaves REPRO_CLUSTER_DEVICE as the
    environment has it, the card when unset).

    Returns each process's stdout and stderr once all exit 0.  On any
    nonzero exit, timeout or stall (`stall_timeout` seconds without a
    beacon change in `beacon_dir`), every surviving worker is reaped and
    a `LaunchError` carries the per-process exit codes, output tails, and
    any partial CLUSTER_RESULT payloads.  `tuned_env=True` starts every
    worker under `_flags.tuned_host_env` (no numerics change; marked by
    REPRO_TUNED_ENV in the worker result)."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    store_dir = tempfile.mkdtemp(prefix="repro_cluster_store_")
    try:
        ranks = subproc.Ranks(
            None, nprocs, argv=list(cmd), device=device, timeout=timeout,
            store=os.path.join(store_dir, "store"), env=extra_env,
            tuned=tuned_env)
        watch = (None if stall_timeout is None
                 else _stall_watch(stall_timeout, beacon_dir))
        try:
            outputs = ranks.wait_all(watch)
        except subproc.RanksError as e:
            reason = e.reason
            if reason.startswith("rank "):
                reason = f"cluster worker failed ({reason})"
            elif reason.startswith("ranks timed out"):
                reason = f"cluster launch timed out after {timeout:.0f}s"
            raise LaunchError(
                f"{reason} ({nprocs} procs, cmd={list(cmd)!r}"
                f"{_reap_tail(e.reaped)})", e.returncodes,
                e.outputs) from None
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    if echo:
        for i, out in enumerate(outputs):
            for line in out.splitlines():
                print(f"[p{i}] {line}")
    return outputs


def supervised_launch(cmd: Sequence[str], nprocs: int, *,
                      timeout: float = 900.0, stall_timeout: float = 120.0,
                      max_restarts: int = 2, backoff_s: float = 0.5,
                      fault: Optional[str] = None,
                      device: Optional[str] = None,
                      extra_env: Optional[dict] = None,
                      tuned_env: bool = False, expect_result: bool = True,
                      echo: bool = False) -> Tuple[List[str], List[dict]]:
    """Launch under supervision: beacon-based stall detection plus
    retry-with-exponential-backoff relaunch of the whole gang under a
    bounded restart budget.

    The relaunch command never changes: workers self-resume from the
    newest sha256-VALID epoch in their `--ckpt-dir` (corrupt epochs are
    skipped, `core.integrity.latest_valid`), so each restart replays at
    most one checkpoint period and changes no output bit.

    `fault` (default: the ambient REPRO_FAULT variable) arms the
    deterministic injection harness (`cluster.faults`) on the FIRST
    attempt only; recovery attempts always run clean.

    `expect_result=True` also treats a worker that exits 0 without
    emitting its CLUSTER_RESULT line (the drop_result fault, or a real
    lost report) as a failure to retry.

    Returns `(outputs, attempts)`, `attempts` the restart history: one
    dict per FAILED attempt (reason, returncodes, last beacons, backoff
    applied); empty when the first attempt succeeded.  Raises
    `LaunchError` carrying the full history once the budget is
    exhausted."""
    fault = os.environ.get(faults.ENV_FAULT, "") if fault is None else fault
    if fault:
        faults.FaultSpec.parse(fault)      # fail fast on bad grammar
    attempts: List[dict] = []
    last: Optional[LaunchError] = None
    for attempt in range(max_restarts + 1):
        bdir = tempfile.mkdtemp(prefix=f"repro_beacon_a{attempt}_")
        env = dict(extra_env or {})
        env[faults.ENV_BEACON_DIR] = bdir
        env[faults.ENV_ATTEMPT] = str(attempt)
        # arm the fault on the first attempt only; explicit "" overrides
        # any ambient REPRO_FAULT the workers would otherwise inherit
        env[faults.ENV_FAULT] = fault if attempt == 0 else ""
        try:
            outputs = launch(cmd, nprocs, timeout=timeout, device=device,
                             extra_env=env, echo=echo, tuned_env=tuned_env,
                             stall_timeout=stall_timeout, beacon_dir=bdir)
            if expect_result:
                missing = [
                    i for i, out in enumerate(outputs)
                    if sum(ln.startswith(RESULT_PREFIX)
                           for ln in out.splitlines()) != 1]
                if missing:
                    raise LaunchError(
                        f"worker(s) {missing} exited 0 without a "
                        f"CLUSTER_RESULT line", [0] * nprocs, outputs)
            return outputs, attempts
        except LaunchError as e:
            last = e
            backoff = backoff_s * (2 ** attempt)
            attempts.append(dict(
                index=attempt,
                reason=str(e).splitlines()[0],
                returncodes=e.returncodes,
                beacons=faults.read_beacons(bdir),
                backoff_s=backoff))
            if attempt < max_restarts:
                time.sleep(backoff)
        finally:
            shutil.rmtree(bdir, ignore_errors=True)
    raise LaunchError(
        f"restart budget exhausted after {max_restarts + 1} attempts "
        f"(max_restarts={max_restarts})",
        last.returncodes, last.outputs, attempts=attempts)
