"""repro_torch.bench.plans — config-driven, resumable experiment
orchestration (port of `repro.bench.plans`).

The beNNch idea (arXiv:2112.09018) applied to this benchmark: a sweep
like "profiles x delivery x exchange x schedule x process counts on this
grid ladder" is a YAML/JSON file, not a shell history.

  schema     plan documents -> validated `Plan` (strict: typos fail)
  expand     axes product -> cells with stable keys + content hashes
             (the hash names torch's version and the device)
  store      one result file per completed cell; hash-keyed resume
  runner     executes cells in fresh interpreters (bench.subproc) or
             through repro_torch.cluster, on the card unless asked for
             the CPU; skips completed ones, exits with an
             executed/skipped/failed summary
  reporting  merges cells into BENCH_plan_<name>.json (the port's
             comparator gates it like any suite)
  dashboard  static inline-SVG HTML: scaling curves, per-phase stacked
             bars, hidden-exchange fractions, time/synaptic-event, plus
             a BENCH history

CLI: `python -m repro_torch.bench plan run|resume|report|expand <plan
file> [--device cuda|cpu]`; results land under `results/plans_torch/`.
"""
from .schema import Plan, PlanError, load, validate
from .expand import cell_hash, cell_key, expand, physics_group
from .store import ResultStore
from .runner import run_plan
from .reporting import load_plan_history, merged_report, write_report

__all__ = [
    "Plan", "PlanError", "load", "validate",
    "cell_hash", "cell_key", "expand", "physics_group",
    "ResultStore", "run_plan", "merged_report", "write_report",
]
