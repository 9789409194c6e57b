"""Benchmark suites of the port: `table1` and `table2` (the paper's
tables).  Each module exposes `run_suite(quick, device) -> report dict`
(consumed by `repro_torch.bench.registry`) and a `bench(...)` callable."""
