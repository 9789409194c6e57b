"""Machine-readable benchmark reports (`BENCH_<name>.json`) + the baseline
comparator that turns them into a CI regression gate (port of
`repro.bench.report`, same schema).

Schema (version 1):

  {
    "schema_version": 1,
    "name": "<suite name>",           # one report per registered suite
    "env": {"torch", "backend", "device_count", "device_name",
            "power_limit_w", "python", "platform"},
    "config": {...},                  # suite knobs; must match to compare
    "deterministic": {key: int|str|bool},   # bit-exact gate (spike counts,
                                            # raster signatures, HLO costs)
    "wall": {key: number},            # seconds / rates; tolerance-compared
    "extra": {...}                    # free-form rows, never gated
  }

Gating policy (`compare`):

  - deterministic drift is a hard FAILURE — these are the paper's
    reproducibility invariants (identical spiking for any distribution);
  - `hlo_*` keys are tied to the toolchain, so when the baseline was
    produced under a different torch version their drift downgrades to a
    WARNING (the port's suites write none: HLO costs need XLA);
  - wall-clock drift beyond `wall_tol` relative is always a WARNING, never
    a failure: shared CI runners cannot promise stable wall time.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform as _platform
import subprocess
import sys
from typing import Dict, Iterable, Optional

SCHEMA_VERSION = 1

_DET_TYPES = (int, str, bool)


def power_limit_w(index: int = 0) -> Optional[float]:
    """The card's power limit in W as `nvidia-smi` reports it (None when
    it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    try:
        return float(out.stdout.strip().split(",")[-1].split()[0])
    except (IndexError, ValueError):
        return None


def environment(device=None) -> dict:
    """Where a report's numbers were taken: torch's version, the device's
    backend ('cuda' or 'cpu'), count and name, and on the card its power
    limit (null on the CPU).  `device` defaults to the card where there is
    one."""
    import torch
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    cuda = dev.type == "cuda"
    index = dev.index if dev.index is not None else 0
    return dict(torch=torch.__version__,
                backend=dev.type,
                device_count=torch.cuda.device_count() if cuda else 1,
                device_name=torch.cuda.get_device_name(index) if cuda
                else "cpu",
                power_limit_w=power_limit_w(index) if cuda else None,
                python=_platform.python_version(),
                platform=sys.platform)


def make_report(name: str, config: dict, deterministic: dict, wall: dict,
                extra: Optional[dict] = None, device=None) -> dict:
    rep = dict(schema_version=SCHEMA_VERSION, name=name,
               env=environment(device), config=dict(config),
               deterministic=dict(deterministic), wall=dict(wall))
    if extra is not None:
        rep["extra"] = extra
    return rep


def validate(report: dict) -> list:
    """Schema check; returns a list of human-readable errors (empty = OK)."""
    errs = []
    if not isinstance(report, dict):
        return ["report is not a dict"]
    for key in ("schema_version", "name", "env", "config", "deterministic",
                "wall"):
        if key not in report:
            errs.append(f"missing required key: {key}")
    if errs:
        return errs
    if report["schema_version"] != SCHEMA_VERSION:
        errs.append(f"schema_version {report['schema_version']} != "
                    f"{SCHEMA_VERSION}")
    if not isinstance(report["name"], str) or not report["name"]:
        errs.append("name must be a non-empty string")
    for sect in ("env", "config", "deterministic", "wall"):
        if not isinstance(report[sect], dict):
            errs.append(f"{sect} must be a dict")
    if errs:
        return errs
    for k in ("torch", "backend", "device_count"):
        if k not in report["env"]:
            errs.append(f"env missing {k}")
    for k, v in report["deterministic"].items():
        # bool is an int subclass — accept it explicitly, reject floats:
        # a float in the deterministic section cannot be gated bit-exactly.
        if not isinstance(v, _DET_TYPES) or isinstance(v, float):
            errs.append(f"deterministic[{k}] must be int/str/bool, "
                        f"got {type(v).__name__}")
    for k, v in report["wall"].items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            errs.append(f"wall[{k}] must be a number, "
                        f"got {type(v).__name__}")
    return errs


def report_path(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"BENCH_{name}.json")


def save(report: dict, out_dir: str) -> str:
    errs = validate(report)
    if errs:
        raise ValueError(f"refusing to save invalid report "
                         f"{report.get('name')!r}: {errs}")
    os.makedirs(out_dir, exist_ok=True)
    path = report_path(out_dir, report["name"])
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_dir(d: str) -> Dict[str, dict]:
    """name -> report for every BENCH_*.json under `d`."""
    out = {}
    if not os.path.isdir(d):
        return out
    for fn in sorted(os.listdir(d)):
        if fn.startswith("BENCH_") and fn.endswith(".json"):
            rep = load(os.path.join(d, fn))
            out[rep.get("name", fn)] = rep
    return out


@dataclasses.dataclass
class CompareResult:
    failures: list = dataclasses.field(default_factory=list)
    warnings: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def extend(self, other: "CompareResult") -> None:
        self.failures.extend(other.failures)
        self.warnings.extend(other.warnings)

    def render(self) -> str:
        lines = []
        for w in self.warnings:
            lines.append(f"WARN  {w}")
        for f in self.failures:
            lines.append(f"FAIL  {f}")
        lines.append("compare: "
                     + ("OK" if self.ok else f"{len(self.failures)} "
                                             f"failure(s)")
                     + (f", {len(self.warnings)} warning(s)"
                        if self.warnings else ""))
        return "\n".join(lines)


def compare(current: dict, baseline: dict, wall_tol: float = 0.5
            ) -> CompareResult:
    """Gate `current` against `baseline` (see module docstring policy)."""
    res = CompareResult()
    name = baseline.get("name", "?")

    for rep, tag in ((current, "current"), (baseline, "baseline")):
        errs = validate(rep)
        if errs:
            res.failures.append(f"{name}: {tag} report invalid: {errs}")
    if res.failures:
        return res
    if current["name"] != baseline["name"]:
        res.failures.append(f"{name}: comparing different suites "
                            f"({current['name']} vs {baseline['name']})")
        return res
    if current["config"] != baseline["config"]:
        # values may be unhashable (lists), so diff by key, not by set
        keys = sorted(set(current["config"]) | set(baseline["config"]))
        diff = {k: (current["config"].get(k), baseline["config"].get(k))
                for k in keys
                if current["config"].get(k) != baseline["config"].get(k)}
        res.failures.append(f"{name}: config mismatch (not comparable): "
                            f"{diff}")
        return res

    same_torch = current["env"].get("torch") == baseline["env"].get("torch")
    if not same_torch:
        res.warnings.append(
            f"{name}: torch version differs (current "
            f"{current['env'].get('torch')} vs baseline "
            f"{baseline['env'].get('torch')}); hlo_* drift downgraded to "
            f"warnings — regenerate baselines if the bump is intentional")

    cur_det = current["deterministic"]
    for k, base_v in baseline["deterministic"].items():
        if k not in cur_det:
            res.failures.append(f"{name}: deterministic metric {k!r} "
                                f"missing from current report")
            continue
        if cur_det[k] != base_v:
            msg = (f"{name}: deterministic drift in {k!r}: "
                   f"{cur_det[k]!r} != baseline {base_v!r}")
            if k.startswith("hlo_") and not same_torch:
                res.warnings.append(msg + " (torch version differs)")
            else:
                res.failures.append(msg)
    for k in sorted(set(cur_det) - set(baseline["deterministic"])):
        res.warnings.append(f"{name}: new deterministic metric {k!r} not in "
                            f"baseline (will gate after re-baselining)")

    for k, base_v in baseline["wall"].items():
        cur_v = current["wall"].get(k)
        if cur_v is None or not base_v:
            continue
        rel = (cur_v - base_v) / base_v
        if abs(rel) > wall_tol:
            res.warnings.append(f"{name}: wall metric {k!r} drifted "
                                f"{rel:+.0%} ({base_v} -> {cur_v}, "
                                f"tol ±{wall_tol:.0%})")
    return res


def compare_dirs(current_dir: str, baseline_dir: str,
                 names: Optional[Iterable] = None,
                 wall_tol: float = 0.5) -> CompareResult:
    """Compare every baseline report (or the `names` subset) against the
    matching current report; a baseline with no current report is a
    failure (the benchmark silently disappeared)."""
    res = CompareResult()
    base = load_dir(baseline_dir)
    cur = load_dir(current_dir)
    if names:
        base = {n: r for n, r in base.items() if n in set(names)}
    if not base:
        res.failures.append(f"no baseline reports found under "
                            f"{baseline_dir!r}")
        return res
    for n, brep in sorted(base.items()):
        if n not in cur:
            res.failures.append(f"{n}: no current report in "
                                f"{current_dir!r} (expected "
                                f"{report_path(current_dir, n)})")
            continue
        res.extend(compare(cur[n], brep, wall_tol=wall_tol))
    return res
