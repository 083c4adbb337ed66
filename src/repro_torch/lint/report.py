"""Reporters: human text and machine JSON renderings of findings."""

from __future__ import annotations

import json

from repro_torch.lint.framework import Finding, all_rules


def render_text(findings: list[Finding], *, show_source: bool = True) -> str:
    """One line per finding (`path:line:col: CODE message`), plus a
    per-code tally footer when anything fired."""
    lines = []
    for f in findings:
        lines.append(f"{f.path}:{f.line}:{f.col + 1}: {f.code} {f.message}")
        if show_source and f.line_text:
            lines.append(f"    {f.line_text}")
    if findings:
        tally: dict[str, int] = {}
        for f in findings:
            tally[f.code] = tally.get(f.code, 0) + 1
        summary = ", ".join(f"{c}×{n}" for c, n in sorted(tally.items()))
        lines.append(f"{len(findings)} finding(s): {summary}")
    return "\n".join(lines)


def render_json(findings: list[Finding]) -> str:
    """Stable JSON: a list of finding objects sorted like the text output."""
    return json.dumps(
        [
            {
                "path": f.path,
                "line": f.line,
                "col": f.col,
                "code": f.code,
                "message": f.message,
                "line_text": f.line_text,
            }
            for f in findings
        ],
        indent=2,
    )


def render_rules() -> str:
    """The rule catalog (`--list-rules`): code, name, summary, rationale."""
    blocks = []
    for r in all_rules():
        blocks.append(f"{r.code} {r.name}\n    {r.summary}\n"
                      f"    rationale: {r.rationale}")
    return "\n".join(blocks)
