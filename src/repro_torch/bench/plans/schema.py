"""Experiment-plan schema: declarative sweep files -> validated `Plan`
(port of `repro.bench.plans.schema`, the same documents, defaults,
domains and errors).

A plan is a YAML/JSON document declaring the paper's experiment grid as
data instead of hand-run commands:

  name: quick                     # -> BENCH_plan_quick.json
  workload:                       # physics base, shared by every cell
    neurons_per_column: 40
    synapses_per_neuron: 16
    steps: 40
    phase_steps: 10               # 0 skips the per-phase split
    seed: 7
  axes:                           # grid product over ALL axes
    grid: [2x2]                   # problem-size ladder ("GXxGY")
    profile: [ring3, ring1]       # lateral connectivity (core.profiles)
    connectivity: [materialized]  # table residency (or streamed:chunk=K)
    delivery: [dense, event]
    exchange: [halo, allgather, hier]
    exchange_schedule: [sync, pipelined]
    placement: [block, scatter]
    shards: [1, 2]                # total logical shards H
    nprocs: [1, 2]                # OS processes (repro_torch.cluster > 1)
    stim: [default]               # named stimulus regime (STIM_REGIMES)
  exclude:                        # drop cells matching EVERY entry key
    - {nprocs: 2, exchange: allgather}
  budgets:
    timeout_s: 600                # per-cell subprocess timeout
    reps: 1                       # timed repetitions (min is wall_s)

Validation is strict — unknown keys, out-of-domain axis values, duplicate
axis values, exclude entries that can never match, and duplicate expanded
cells are all hard errors (`PlanError` carries the full list) — because a
plan file is reviewed config: a typo silently shrinking the sweep is worse
than a failing load.  Profiles and connectivity modes are checked by the
port's own `core.profiles.parse` and `core.connectivity.parse_mode`.

The loader reads YAML when PyYAML is installed and always reads JSON, so
the format never becomes a hard dependency of the bench package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

# name -> (stim_events_per_ms_per_column, stim_amplitude): the paper's
# thalamic stimulus knob as reviewable regimes instead of free floats.
STIM_REGIMES: Dict[str, tuple] = {
    "default": (1, 20.0),        # paper default: 1 event/ms/column
    "quiet": (0, 20.0),          # no external drive (recurrent only)
    "strong": (2, 20.0),         # doubled event rate (sparse/dense flip)
}

AXIS_DOMAINS = {
    "delivery": ("dense", "event"),
    "exchange": ("allgather", "halo", "hier"),
    "exchange_schedule": ("sync", "pipelined"),
    "placement": ("block", "scatter"),
    "stim": tuple(STIM_REGIMES),
}

# canonical axis order: cell keys, expansion order and hashes all follow it
AXES = ("grid", "profile", "connectivity", "delivery", "exchange",
        "exchange_schedule", "placement", "shards", "nprocs", "stim")

AXIS_DEFAULTS = {
    "grid": ["2x2"], "profile": ["ring3"],
    "connectivity": ["materialized"], "delivery": ["dense"],
    "exchange": ["allgather"], "exchange_schedule": ["sync"],
    "placement": ["block"], "shards": [1], "nprocs": [1],
    "stim": ["default"],
}

WORKLOAD_DEFAULTS = {
    "neurons_per_column": 100,
    "synapses_per_neuron": 40,
    "steps": 60,
    "phase_steps": 0,
    "seed": 2013,
}

BUDGET_DEFAULTS = {
    "timeout_s": None,           # None -> repro.bench.subproc default
    "reps": 1,
}

_GRID_RE = re.compile(r"^(\d+)x(\d+)$")


class PlanError(ValueError):
    """Plan failed validation; `errors` is the full list."""

    def __init__(self, errors: List[str]):
        self.errors = list(errors)
        super().__init__("invalid experiment plan:\n  " +
                         "\n  ".join(self.errors))


@dataclasses.dataclass(frozen=True)
class Plan:
    name: str
    workload: dict
    axes: dict                   # axis -> list of values (all axes present)
    exclude: tuple               # tuple of {axis: [values...]} matchers
    budgets: dict
    description: str = ""

    def to_config(self) -> dict:
        """JSON round-trippable view for the BENCH report config section
        (env-independent: two machines running the same plan compare)."""
        return dict(schema_version=SCHEMA_VERSION, name=self.name,
                    workload=dict(self.workload),
                    axes={a: list(v) for a, v in self.axes.items()},
                    exclude=[{k: list(v) for k, v in e.items()}
                             for e in self.exclude],
                    budgets=dict(self.budgets))


def _listify(v) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _check_axis_value(axis: str, v, errs: List[str]) -> None:
    if axis in AXIS_DOMAINS:
        if v not in AXIS_DOMAINS[axis]:
            errs.append(f"axes.{axis}: {v!r} not in "
                        f"{list(AXIS_DOMAINS[axis])}")
    elif axis == "grid":
        m = _GRID_RE.match(str(v))
        if not m or int(m.group(1)) < 1 or int(m.group(2)) < 1:
            errs.append(f"axes.grid: {v!r} is not 'GXxGY' with positive "
                        f"integers")
    elif axis in ("shards", "nprocs"):
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            errs.append(f"axes.{axis}: {v!r} must be a positive int")
    elif axis == "profile":
        try:
            from ...core import profiles
            profiles.parse(str(v))
        except Exception as e:
            errs.append(f"axes.profile: {v!r} rejected by "
                        f"core.profiles.parse: {e}")
    elif axis == "connectivity":
        try:
            from ...core import connectivity
            connectivity.parse_mode(str(v))
        except Exception as e:
            errs.append(f"axes.connectivity: {v!r} rejected by "
                        f"core.connectivity.parse_mode: {e}")


def validate(doc: dict, name_hint: Optional[str] = None) -> Plan:
    """Raw dict -> Plan; raises PlanError with every problem found."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        raise PlanError(["plan document must be a mapping, got "
                         f"{type(doc).__name__}"])
    unknown = set(doc) - {"name", "description", "workload", "axes",
                          "exclude", "budgets"}
    if unknown:
        errs.append(f"unknown top-level keys: {sorted(unknown)}")

    name = doc.get("name", name_hint)
    if not isinstance(name, str) or not re.match(r"^[A-Za-z0-9_\-]+$",
                                                 name or ""):
        errs.append(f"name must be a [A-Za-z0-9_-]+ string, got {name!r}")

    workload = dict(WORKLOAD_DEFAULTS)
    wl = doc.get("workload", {}) or {}
    if not isinstance(wl, dict):
        errs.append("workload must be a mapping")
        wl = {}
    for k, v in wl.items():
        if k not in WORKLOAD_DEFAULTS:
            errs.append(f"workload.{k}: unknown key (known: "
                        f"{sorted(WORKLOAD_DEFAULTS)})")
        elif not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append(f"workload.{k}: {v!r} must be a non-negative int")
        else:
            workload[k] = v

    axes = {a: list(AXIS_DEFAULTS[a]) for a in AXES}
    ax = doc.get("axes", {}) or {}
    if not isinstance(ax, dict):
        errs.append("axes must be a mapping")
        ax = {}
    for a, vals in ax.items():
        if a not in AXES:
            errs.append(f"axes.{a}: unknown axis (known: {list(AXES)})")
            continue
        vals = _listify(vals)
        if not vals:
            errs.append(f"axes.{a}: empty value list")
            continue
        seen = set()
        for v in vals:
            _check_axis_value(a, v, errs)
            vk = json.dumps(v) if not isinstance(v, str) else v
            if vk in seen:
                errs.append(f"axes.{a}: duplicate value {v!r} (would "
                            f"expand to duplicate cells)")
            seen.add(vk)
        axes[a] = vals

    exclude = []
    exc = doc.get("exclude", []) or []
    if not isinstance(exc, list):
        errs.append("exclude must be a list of axis->value mappings")
        exc = []
    for i, entry in enumerate(exc):
        if not isinstance(entry, dict) or not entry:
            errs.append(f"exclude[{i}]: must be a non-empty mapping")
            continue
        norm = {}
        for k, v in entry.items():
            if k not in AXES:
                errs.append(f"exclude[{i}].{k}: unknown axis")
                continue
            vals = _listify(v)
            for vv in vals:
                _check_axis_value(k, vv, errs)
            norm[k] = vals
        if norm:
            exclude.append(norm)

    budgets = dict(BUDGET_DEFAULTS)
    bd = doc.get("budgets", {}) or {}
    if not isinstance(bd, dict):
        errs.append("budgets must be a mapping")
        bd = {}
    for k, v in bd.items():
        if k not in BUDGET_DEFAULTS:
            errs.append(f"budgets.{k}: unknown key (known: "
                        f"{sorted(BUDGET_DEFAULTS)})")
        elif k == "reps" and (not isinstance(v, int) or v < 1):
            errs.append(f"budgets.reps: {v!r} must be a positive int")
        elif k == "timeout_s" and v is not None and (
                not isinstance(v, (int, float)) or v <= 0):
            errs.append(f"budgets.timeout_s: {v!r} must be a positive "
                        f"number or null")
        else:
            budgets[k] = v

    if errs:
        raise PlanError(errs)
    return Plan(name=name, workload=workload, axes=axes,
                exclude=tuple(exclude), budgets=budgets,
                description=str(doc.get("description", "")))


def load(path: str) -> Plan:
    """Load + validate a plan file (.yaml/.yml via PyYAML, .json always)."""
    if not os.path.isfile(path):
        raise PlanError([f"plan file not found: {path}"])
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise PlanError(
                [f"{path}: reading YAML plans needs PyYAML — or write the "
                 f"plan as JSON"]) from e
        doc = yaml.safe_load(text)
    else:
        doc = json.loads(text)
    hint = os.path.splitext(os.path.basename(path))[0]
    return validate(doc, name_hint=hint)
