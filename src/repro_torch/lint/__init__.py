"""repro_torch.lint — a determinism & contract static linter for this repo.

A copy of `repro.lint` (the port imports nothing of the JAX package) that
lints `src/repro_torch/` by default: the same rules, codes, pragmas and
baseline format; the subpackage scoping reads the part after `repro_torch`,
messages name `repro_torch.`, and the baseline is `lint_baseline_torch.json`.
`tests/test_torch_lint.py` holds it to the original finding for finding.

The parity suite (`tests/test_engine_parity.py`) and the observational
tracing tests can only *sample* the invariants the codebase is built on:
bit-for-bit engine parity, seeded-RNG purity, tracing/monitoring that
never mutates engine state, and unit-consistent cost math. This package
enforces those contracts *statically*, on every file, on every PR:

  * **D-series (determinism)** — unseeded RNG draws, wall-clock reads in
    the deterministic layers (`sim`/`cluster`/`obs`), iteration over
    unordered containers feeding ordering-sensitive constructs, and
    `id()`-derived keys.
  * **P-series (purity)** — mutable default arguments, mutable dataclass
    field defaults, observational modules writing attributes on objects
    they were handed, and in-place mutation of config parameters.
  * **U-series (surface)** — public `sim`/`cluster` functions missing
    unit-annotated docstrings, bare `except:`, and float-literal
    equality in non-test code.

Run it:

    PYTHONPATH=src python -m repro_torch.lint                # lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.lint --list-rules   # rule catalog

Findings are suppressed either by a same-line pragma with a short
justification::

    planned = {id(r): r.cached for r in running}  # lint: disable=D104 -- identity map, never iterated

or by the checked-in baseline (`lint_baseline_torch.json`) for legacy findings
that predate a rule. New findings exit non-zero, so CI blocks them. See
`docs/linting.md` for the full catalog and workflow.
"""

from repro_torch.lint.framework import (
    Finding,
    LintContext,
    Rule,
    all_rules,
    lint_file,
    lint_paths,
    register,
)
from repro_torch.lint.baseline import load_baseline, new_findings, write_baseline
from repro_torch.lint.report import render_json, render_text

# importing the rule modules registers every rule with the framework
from repro_torch.lint import rules_determinism, rules_purity, rules_surface  # noqa: F401

__all__ = [
    "Finding",
    "LintContext",
    "Rule",
    "all_rules",
    "lint_file",
    "lint_paths",
    "register",
    "load_baseline",
    "new_findings",
    "write_baseline",
    "render_json",
    "render_text",
]
