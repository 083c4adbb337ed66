"""CLI: `python -m repro_torch.lint [paths ...]`.

Exit status is the gate: 0 when every finding is absorbed by the
baseline (or there are none), 1 otherwise — so `python -m repro_torch.lint`
in CI or scripts/verify.sh blocks new violations. `--check` is the same
gate spelled explicitly; `--write-baseline` snapshots current findings
as accepted legacy.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.lint.baseline import (
    DEFAULT_BASELINE,
    load_baseline,
    new_findings,
    write_baseline,
)
from repro_torch.lint.framework import lint_paths
from repro_torch.lint.report import render_json, render_rules, render_text


def _repo_root() -> Path:
    # src/repro_torch/lint/__main__.py -> repo root is three parents above src/
    return Path(__file__).resolve().parents[3]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description=(
            "Determinism & contract linter: statically enforces the "
            "seeded-determinism, observational-tracing, and unit-docstring "
            "contracts the parity suite can only sample. Exits non-zero on "
            "findings not covered by the checked-in baseline."),
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to lint (default: src/repro_torch)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="findings output format")
    p.add_argument("--select", default=None, metavar="CODES",
                   help="comma-separated code prefixes to run (e.g. D,U302)")
    p.add_argument("--ignore", default=None, metavar="CODES",
                   help="comma-separated code prefixes to skip")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help=f"baseline file (default: <repo>/{DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="snapshot current findings as the accepted baseline")
    p.add_argument("--check", action="store_true",
                   help="gate mode (explicit alias of the default behavior)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        print(render_rules())
        return 0

    root = _repo_root()
    paths = args.paths or [root / "src" / "repro_torch"]
    findings = lint_paths(paths, select=args.select, ignore=args.ignore)

    baseline_path = Path(args.baseline) if args.baseline else (
        root / DEFAULT_BASELINE)
    if args.write_baseline:
        payload = write_baseline(findings, baseline_path)
        print(f"wrote {len(payload['findings'])} fingerprint(s) "
              f"({len(findings)} finding(s)) to {baseline_path}")
        return 0

    if not args.no_baseline:
        findings = new_findings(findings, load_baseline(baseline_path))

    out = (render_json(findings) if args.format == "json"
           else render_text(findings))
    if out:
        print(out)
    if not findings:
        n = len(paths)
        print(f"repro_torch.lint: clean ({n} path(s) checked)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
