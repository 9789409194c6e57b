"""repro_torch.bench — the benchmarking subsystem of the PyTorch port
(the measuring half of `repro.bench`).

  timing   — wall-clock harness (warm-up, a device synchronise inside
             every timed region, median-of-k, the paper's normalised
             time-per-synapse metric)
  profile  — per-phase (compute / exchange / arborization) split across
             exchange modes and placements, with deterministic counters
  report   — versioned BENCH_<name>.json schema + baseline comparator
             (hard-fails deterministic drift, warns on wall-clock)
  registry — suite registration; cli — `python -m repro_torch.bench
             list|run|compare|plan`
  subproc  — fresh interpreters: a plan cell alone, or the ranks of a
             torch.distributed job (the distributed suites start theirs)
  plans    — config-driven, resumable experiment plans (schema, expand,
             store, runner, reporting, dashboard)

Suites run on the card by default (`device="cuda"`) and on the CPU when
asked.
"""
from . import registry, report, timing
from .report import CompareResult, compare, compare_dirs, make_report, validate

__all__ = [
    "registry", "report", "timing",
    "CompareResult", "compare", "compare_dirs", "make_report", "validate",
]
