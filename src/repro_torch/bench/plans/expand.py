"""Plan expansion: axes product -> executable cells, with exclusions
(port of `repro.bench.plans.expand`: the same rules, keys, hashes and
groups).

A *cell* is one fully-resolved experiment: every axis pinned to one value
plus the plan's workload and budget knobs flattened in.  Expansion is the
grid product over `Plan.axes` in canonical axis order, minus

  structural rules (always on):
    - `shards % nprocs != 0` — the cluster launcher places H/P devices
      per process, so the division must be exact;
    - `exchange == 'hier'` with `nprocs < 2` — the two-level exchange
      derives its groups from the per-process device blocks, so it needs
      at least two real process groups;

  user excludes: an entry `{axis: value-or-list, ...}` drops every cell
  matching ALL of its constraints (value in list).

Every surviving cell gets a stable human-readable `key` (used as result
file name and report metric prefix) and a `hash` over (schema version,
cell knobs, code-relevant env) — the resume fingerprint: a completed
result file whose hash matches is skipped, one whose hash differs (other
torch version or device, edited plan) is stale and re-executed.  The
port's env names torch and the device, so a CPU result never counts as
complete for a card run, and a store of the JAX package's never mixes
with the port's.

`physics_group` names the subset of knobs that define the simulation's
trajectory (grid geometry, profile, stimulus, seed, sizes, steps).  Cells
in one group differ only by execution layout — shards, processes,
exchange wire, schedule, placement, delivery backend — so the paper's
Table 1 invariant says their rasters must be bit-identical; the reporter
gates exactly that.
"""
from __future__ import annotations

import hashlib
import itertools
import json
from typing import Dict, List, Tuple

from .schema import AXES, SCHEMA_VERSION, STIM_REGIMES, Plan, PlanError

# cell fields whose change must invalidate a stored result (everything
# that feeds the subprocess, minus pure-budget knobs like timeout_s)
_HASHED_FIELDS = AXES + ("neurons_per_column", "synapses_per_neuron",
                         "steps", "phase_steps", "seed", "reps",
                         "stim_events", "stim_amplitude")

# fields that pin the physics (the Table 1 invariant group); everything
# else is execution layout and must not change the raster.  `connectivity`
# (table residency) is deliberately NOT here: streamed and materialized
# cells share a physics group, so the reporter's bit-identity gate covers
# the streamed-regeneration invariant for free.
PHYSICS_FIELDS = ("grid", "profile", "stim", "seed", "neurons_per_column",
                  "synapses_per_neuron", "steps")


def runtime_env(device: str = "cuda") -> dict:
    """The code-relevant environment folded into cell hashes: the torch
    version and the device ("cuda" or "cpu") the cells run on, so a bump
    or another device re-runs every cell."""
    import torch
    return dict(torch=torch.__version__, device=str(device))


def cell_key(cell: dict) -> str:
    """Filesystem/report-safe unique cell name in canonical axis order."""
    def safe(v):
        return "".join(c if c.isalnum() else "-" for c in str(v))

    return (f"{safe(cell['profile'])}_{safe(cell['connectivity'])}"
            f"_{cell['delivery']}"
            f"_{cell['exchange']}_{cell['exchange_schedule']}"
            f"_{cell['placement']}_h{cell['shards']}p{cell['nprocs']}"
            f"_g{cell['grid']}_{cell['stim']}")


def cell_hash(cell: dict, env: dict) -> str:
    doc = dict(schema_version=SCHEMA_VERSION,
               cell={k: cell[k] for k in _HASHED_FIELDS}, env=dict(env))
    blob = json.dumps(doc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def physics_group(cell: dict) -> str:
    """Readable label of the physics knobs (used as a report metric name:
    cells sharing it must produce bit-identical rasters)."""
    prof = "".join(c if c.isalnum() else "-" for c in str(cell["profile"]))
    return (f"g{cell['grid']}-{prof}-{cell['stim']}-s{cell['seed']}"
            f"-n{cell['neurons_per_column']}x{cell['synapses_per_neuron']}"
            f"-t{cell['steps']}")


def _matches(cell: dict, entry: Dict[str, list]) -> bool:
    return all(cell.get(k) in vals for k, vals in entry.items())


def _structural_reason(cell: dict) -> str:
    if cell["shards"] % cell["nprocs"]:
        return (f"shards {cell['shards']} not divisible by nprocs "
                f"{cell['nprocs']}")
    if cell["exchange"] == "hier" and cell["nprocs"] < 2:
        return "exchange='hier' needs >= 2 process groups"
    if cell["delivery"] == "event" and cell["connectivity"] != \
            "materialized":
        return ("delivery='event' requires connectivity='materialized' "
                "(event row tables are an O(E) synapse-id permutation)")
    return ""


def expand(plan: Plan, env: dict = None) -> Tuple[List[dict], List[dict]]:
    """Plan -> (cells, excluded).

    `cells` carry every axis value + workload + budgets + `key`/`hash`/
    `physics_group`; `excluded` records each dropped combination with its
    reason so a sweep can never silently shrink.  Raises PlanError on
    duplicate keys/hashes or an empty expansion.
    """
    env = env if env is not None else runtime_env()
    cells, excluded = [], []
    for combo in itertools.product(*(plan.axes[a] for a in AXES)):
        cell = dict(zip(AXES, combo))
        cell.update(plan.workload)
        cell["reps"] = plan.budgets["reps"]
        ev, amp = STIM_REGIMES[cell["stim"]]
        cell["stim_events"], cell["stim_amplitude"] = ev, amp

        reason = _structural_reason(cell)
        if not reason:
            for entry in plan.exclude:
                if _matches(cell, entry):
                    reason = f"excluded by {json.dumps(entry)}"
                    break
        if reason:
            excluded.append(dict(cell=dict(cell), reason=reason))
            continue
        cell["key"] = cell_key(cell)
        cell["hash"] = cell_hash(cell, env)
        cell["physics_group"] = physics_group(cell)
        cells.append(cell)

    errs = []
    if not cells:
        errs.append("plan expands to zero cells (everything excluded?)")
    seen_keys, seen_hashes = set(), set()
    for c in cells:
        if c["key"] in seen_keys:
            errs.append(f"duplicate cell key after expansion: {c['key']} "
                        f"(axis values collide after sanitizing)")
        if c["hash"] in seen_hashes:
            errs.append(f"duplicate cell hash after expansion: "
                        f"{c['hash']} ({c['key']})")
        seen_keys.add(c["key"])
        seen_hashes.add(c["hash"])
    if errs:
        raise PlanError(errs)
    return cells, excluded
