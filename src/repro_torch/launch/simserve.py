"""Simulation-service launcher: multi-tenant SNN serving (port of
`repro.launch.simserve`).

  python -m repro_torch.launch.simserve demo [--device cpu]
  python -m repro_torch.launch.simserve soak --tenants 8 --reshard

An alias of `python -m repro_torch.simserve` (the same CLI), kept under
`repro_torch.launch` so that every runnable entry point of the port lives
in one namespace; `repro_torch/simserve/cli.py` has the flags.  It runs
on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import sys

from repro_torch.simserve.cli import main

if __name__ == "__main__":
    sys.exit(main())
