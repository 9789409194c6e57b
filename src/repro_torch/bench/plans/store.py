"""Resumable result store: one JSON file per completed plan cell (port of
`repro.bench.plans.store`, the same layout).

Layout (under `<out_root>/<plan name>/`; the CLI's root is
`results/plans_torch/`):

  cells/<cell key>.json       one completed cell: {key, hash, cell, env,
                              result, elapsed_s}
  last_run_summary.json       the most recent runner exit summary
  BENCH_plan_<name>.json      merged report (written by the reporter)
  dashboard.html              static dashboard (written by the reporter)

Resume is file-existence + fingerprint: a cell whose file exists AND
whose stored `hash` equals the freshly-computed one is complete and is
skipped; a missing file or a stale hash (plan edited, torch bumped, another device) means
the cell runs (again) and the file is atomically replaced.  Failed cells
never write a file, so an interrupted or partially-failed run resumes by
re-executing exactly the unfinished cells.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional

SUMMARY_FILE = "last_run_summary.json"


def _atomic_write_json(path: str, doc: dict) -> None:
    """Write-then-rename so an interrupt mid-write can never leave a
    half-written 'completed' cell behind."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class ResultStore:
    def __init__(self, out_root: str, plan_name: str):
        self.root = os.path.join(out_root, plan_name)
        self.cells_dir = os.path.join(self.root, "cells")

    def exists(self) -> bool:
        return os.path.isdir(self.cells_dir)

    def cell_path(self, key: str) -> str:
        return os.path.join(self.cells_dir, f"{key}.json")

    def completed(self, key: str, hash_: str) -> bool:
        """True iff a result for `key` exists with a matching
        fingerprint (stale results don't count as done)."""
        rec = self.load_cell(key)
        return rec is not None and rec.get("hash") == hash_

    def load_cell(self, key: str) -> Optional[dict]:
        path = self.cell_path(key)
        if not os.path.isfile(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None          # corrupt/partial file == not completed

    def save_cell(self, record: dict) -> str:
        path = self.cell_path(record["key"])
        _atomic_write_json(path, record)
        return path

    def drop_cell(self, key: str) -> bool:
        path = self.cell_path(key)
        if os.path.isfile(path):
            os.unlink(path)
            return True
        return False

    def load_results(self) -> List[dict]:
        """Every stored cell record, sorted by key."""
        out = []
        if not self.exists():
            return out
        for fn in sorted(os.listdir(self.cells_dir)):
            if fn.endswith(".json"):
                rec = self.load_cell(fn[:-len(".json")])
                if rec is not None:
                    out.append(rec)
        return out

    # -- runner exit summary --------------------------------------------

    def save_summary(self, summary: Dict) -> str:
        path = os.path.join(self.root, SUMMARY_FILE)
        _atomic_write_json(path, summary)
        return path

    def load_summary(self) -> Optional[dict]:
        path = os.path.join(self.root, SUMMARY_FILE)
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)
