"""Benchmark registry: name -> suite runner (port of
`repro.bench.registry`).

Every entry is a thin loader, so `list` pays no suite import cost.  The
JAX package's other suites are not ported yet: asking for one raises
NotImplementedError naming the ROADMAP item (queue 1) that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str
    fn: Callable[[bool, object], dict]      # (quick, device) -> report
    doc: str


def _lm_throughput(quick, device):
    from .suites import lm_throughput
    return lm_throughput.run_suite(quick, device)


def _profile(quick, device):
    from . import profile
    return profile.run_profile(quick, device)


def _cluster_scaling(quick, device):
    from ..cluster import cli as cluster_cli
    return cluster_cli.sweep_report(quick=quick, device=device)


def _comm_overlap(quick, device):
    from .suites import comm_overlap
    return comm_overlap.run_suite(quick, device)


def _connectivity_sweep(quick, device):
    from .suites import connectivity_sweep
    return connectivity_sweep.run_suite(quick, device)


def _event_vs_dense(quick, device):
    from .suites import event_vs_dense
    return event_vs_dense.run_suite(quick, device)


def _scaling(quick, device):
    from .suites import scaling
    return scaling.run_suite(quick, device)


def _simserve_throughput(quick, device):
    from .suites import simserve_throughput
    return simserve_throughput.run_suite(quick, device)


def _table1(quick, device):
    from .suites import table1
    return table1.run_suite(quick, device)


def _table2(quick, device):
    from .suites import table2
    return table2.run_suite(quick, device)


def _weak_scaling(quick, device):
    from .suites import weak_scaling
    return weak_scaling.run_suite(quick, device)


BENCHES: Dict[str, Entry] = {e.name: e for e in [
    Entry("cluster_scaling", _cluster_scaling,
          "strong scaling over process counts with bit-identical rasters, "
          "per-process phase split (paper Figs. 5-8; "
          "repro_torch.cluster)"),
    Entry("comm_overlap", _comm_overlap,
          "hidden vs exposed exchange time, sync vs pipelined, over "
          "torch.distributed ranks"),
    Entry("connectivity_sweep", _connectivity_sweep,
          "per-phase split across lateral-connectivity profiles (ring3, "
          "ring1, gaussian, exponential) x {halo, allgather}, with reach "
          "statistics (arXiv:1803.08833)"),
    Entry("event_vs_dense", _event_vs_dense,
          "dense O(E) vs event O(spikes x fan) delivery: single device, "
          "and H x exchange x delivery over ranks"),
    Entry("lm_throughput", _lm_throughput,
          "LM train and decode tokens/s, reduced config (qwen3-0.6b "
          "SMOKE)"),
    Entry("profile", _profile,
          "per-phase compute/exchange/arborization split, "
          "{allgather,halo} x {block,scatter} (paper Table 2)"),
    Entry("scaling", _scaling,
          "strong/weak scaling over torch.distributed ranks (paper Figs. "
          "3-1, 3-2)"),
    Entry("simserve_throughput", _simserve_throughput,
          "the multi-tenant service at 1 / 4 / 8 same-shape tenants: "
          "steps/s, one build and one capture per key (repro_torch."
          "simserve)"),
    Entry("table1", _table1,
          "problem sizes, rates, normalized time/synapse (paper Table 1)"),
    Entry("table2", _table2,
          "H=1 compute/communication split (paper Table 2, legacy view)"),
    Entry("weak_scaling", _weak_scaling,
          "streamed connectivity: the >= 8x table-residency cell "
          "(bit-identical to materialized) and a constant-synapses-per-"
          "shard ladder"),
]}

#: The JAX package's suites that the port does not run yet, and the
#: ROADMAP item (queue 1) that ports each.
NOT_PORTED: Dict[str, str] = {
    "roofline": "item 13.6 (the dry-run audit, roofline's only input)",
}


def get(name: str) -> Entry:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"benchmark {name!r} is not ported yet (ROADMAP queue 1, "
            f"{NOT_PORTED[name]})")
    if name not in BENCHES:
        raise KeyError(f"unknown benchmark {name!r}; known: "
                       f"{sorted(BENCHES)}")
    return BENCHES[name]


def default_names() -> List[str]:
    return list(BENCHES)
