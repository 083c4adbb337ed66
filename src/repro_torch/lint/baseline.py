"""Baseline: accepted legacy findings that don't fail the gate.

The baseline is a checked-in JSON file mapping finding *fingerprints* to
counts. A fingerprint is `(path, code, stripped source line text)` — NOT
the line number — so unrelated edits that shift lines don't churn the
file; moving or duplicating an offending line past its baselined count
does fail, which is the point.

Workflow: `python -m repro_torch.lint --write-baseline` snapshots today's
findings; the gate (`python -m repro_torch.lint` / `--check`) then fails only
on findings *not covered* by the baseline. The shipped baseline is kept
near-empty on purpose — fix or pragma, don't accumulate. The port's is
`lint_baseline_torch.json`; it never reads or writes the JAX package's
`lint_baseline.json`.
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.lint.framework import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = "lint_baseline_torch.json"


def _fp(f: Finding) -> str:
    return f"{f.path}::{f.code}::{f.line_text}"


def write_baseline(findings: list[Finding], path: str | Path) -> dict:
    """Serialize findings to a baseline file; returns the written payload."""
    counts: dict[str, int] = {}
    for f in findings:
        counts[_fp(f)] = counts.get(_fp(f), 0) + 1
    payload = {
        "version": BASELINE_VERSION,
        "findings": dict(sorted(counts.items())),
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")
    return payload


def load_baseline(path: str | Path) -> dict[str, int]:
    """Load fingerprint -> allowed-count; missing file = empty baseline."""
    p = Path(path)
    if not p.exists():
        return {}
    payload = json.loads(p.read_text())
    if payload.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {p} has version {payload.get('version')!r}, "
            f"expected {BASELINE_VERSION}; regenerate with --write-baseline")
    return dict(payload.get("findings", {}))


def new_findings(findings: list[Finding],
                 baseline: dict[str, int]) -> list[Finding]:
    """Findings not absorbed by the baseline (per-fingerprint counting)."""
    budget = dict(baseline)
    out = []
    for f in findings:
        fp = _fp(f)
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
        else:
            out.append(f)
    return out
