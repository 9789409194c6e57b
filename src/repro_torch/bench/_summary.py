"""$GITHUB_STEP_SUMMARY writer: bench/plan outcomes on the checks page.

GitHub renders whatever a job appends to the file named by the
GITHUB_STEP_SUMMARY environment variable as markdown on the PR checks
page — so comparator verdicts and per-cell pass/fail are readable
without downloading artifacts.  Outside Actions the variable is unset
and `append` is a silent no-op, which keeps every caller unconditional.
"""
from __future__ import annotations

import os

ENV_VAR = "GITHUB_STEP_SUMMARY"


def append(markdown: str) -> bool:
    """Append a markdown block to the step summary; True if written."""
    path = os.environ.get(ENV_VAR)
    if not path:
        return False
    try:
        with open(path, "a") as f:
            f.write(markdown.rstrip() + "\n\n")
        return True
    except OSError:
        return False


def code_block(text: str, title: str = "") -> str:
    """Markdown helper: optional heading + fenced block."""
    head = f"### {title}\n\n" if title else ""
    return f"{head}```\n{text.rstrip()}\n```"
