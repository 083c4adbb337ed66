"""Rule framework: contexts, pragmas, registration, and the file walker.

Design notes
------------
* One `LintContext` per file: parsed AST, a parent map, the pragma table,
  and cheap classification (`subpackage`, `is_test`) that rules use to
  scope themselves. Rules never re-read the file.
* Rules are small classes with a `check(ctx) -> Iterator[Finding]`; they
  register themselves via the `@register` decorator so adding a rule is
  one class in one module, no central table to edit.
* Suppression is same-line only (`# lint: disable=CODE[,CODE] -- why`) or
  file-level (`# lint: disable-file=CODE`). Findings anchor to the line
  where the offending *statement or expression starts*, so the pragma
  always has a well-defined home even for multi-line calls.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator


@dataclass(frozen=True, order=True)
class Finding:
    """One lint violation, anchored to a source line.

    `line_text` (the stripped source line) is part of the identity used by
    the baseline so findings survive unrelated line-number churn.
    """

    path: str  # POSIX-style path as given to the linter
    line: int  # 1-based
    col: int  # 0-based
    code: str  # e.g. "D103"
    message: str
    line_text: str = field(compare=False, default="")

    def key(self) -> tuple[str, str, str]:
        """Baseline identity, line-number independent (see baseline.py)."""
        return (self.path, self.code, self.line_text)


# repo root (src/repro_torch/lint/framework.py -> three parents above src/):
# finding paths are stored relative to it so baseline fingerprints match
# no matter whether the linter was invoked with absolute or relative paths
_REPO_ROOT = Path(__file__).resolve().parents[3]


def _display_path(p: Path) -> str:
    try:
        return p.resolve().relative_to(_REPO_ROOT).as_posix()
    except ValueError:
        return p.as_posix()


_PRAGMA_RE = re.compile(r"#\s*lint:\s*disable=([A-Z]\d+(?:\s*,\s*[A-Z]\d+)*)")
_PRAGMA_NEXT_RE = re.compile(
    r"#\s*lint:\s*disable-next=([A-Z]\d+(?:\s*,\s*[A-Z]\d+)*)"
)
_PRAGMA_FILE_RE = re.compile(
    r"#\s*lint:\s*disable-file=([A-Z]\d+(?:\s*,\s*[A-Z]\d+)*)"
)


def _parse_pragmas(lines: list[str]) -> tuple[dict[int, set[str]], set[str]]:
    """Return (line -> disabled codes, file-wide disabled codes); 1-based.

    `disable=` suppresses on its own line, `disable-next=` on the next
    non-comment line (for statements too long to carry a trailing
    comment), `disable-file=` everywhere in the file.
    """
    per_line: dict[int, set[str]] = {}
    file_wide: set[str] = set()
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            per_line.setdefault(i, set()).update(
                c.strip() for c in m.group(1).split(","))
        m = _PRAGMA_NEXT_RE.search(text)
        if m:
            j = i + 1  # skip over intervening comment-only lines
            while j <= len(lines) and lines[j - 1].lstrip().startswith("#"):
                j += 1
            per_line.setdefault(j, set()).update(
                c.strip() for c in m.group(1).split(","))
        m = _PRAGMA_FILE_RE.search(text)
        if m:
            file_wide |= {c.strip() for c in m.group(1).split(",")}
    return per_line, file_wide


class LintContext:
    """Everything a rule needs to know about one source file."""

    def __init__(self, path: str | Path, source: str | None = None):
        p = Path(path)
        self.path = _display_path(p)
        if source is None:
            source = p.read_text()
        self.source = source
        self.lines = source.splitlines()
        self.tree: ast.AST | None
        self.syntax_error: SyntaxError | None = None
        try:
            self.tree = ast.parse(source, filename=self.path)
        except SyntaxError as e:  # surfaced as an E001 finding by lint_file
            self.tree = None
            self.syntax_error = e
        self.disabled, self.file_disabled = _parse_pragmas(self.lines)
        parts = p.parts
        # subpackage under repro_torch/ ("sim", "cluster", "obs", ...) or "" when
        # the file is outside the package (tests, scripts, fixtures)
        self.subpackage = ""
        if "repro_torch" in parts:
            rest = parts[parts.index("repro_torch") + 1:]
            if len(rest) > 1:
                self.subpackage = rest[0]
        self.is_test = "tests" in parts or p.name.startswith("test_")
        self._parents: dict[ast.AST, ast.AST] | None = None

    # -- helpers rules share -------------------------------------------------
    @property
    def parents(self) -> dict[ast.AST, ast.AST]:
        """Child -> parent map over the whole tree (built lazily, once)."""
        if self._parents is None:
            self._parents = {}
            assert self.tree is not None
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents

    def walk(self) -> Iterator[ast.AST]:
        if self.tree is None:
            return iter(())
        return ast.walk(self.tree)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, node: ast.AST, code: str, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(self.path, line, col, code, message,
                       line_text=self.line_text(line))

    def suppressed(self, f: Finding) -> bool:
        if f.code in self.file_disabled:
            return True
        return f.code in self.disabled.get(f.line, ())


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted name of a call target: `np.random.default_rng`
    -> "np.random.default_rng"; unresolvable parts render as "?"."""
    if isinstance(node, ast.Attribute):
        return f"{dotted_name(node.value)}.{node.attr}"
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return dotted_name(node.func) + "()"
    return "?"


class Rule:
    """Base class. Subclasses set `code`/`name`/`summary`/`rationale` and
    implement `check`; `applies` scopes the rule to file categories."""

    code: str = "X000"
    name: str = "unnamed"
    summary: str = ""
    rationale: str = ""

    def applies(self, ctx: LintContext) -> bool:
        return not ctx.is_test

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        raise NotImplementedError

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        if ctx.tree is None or not self.applies(ctx):
            return
        yield from self.check(ctx)


_REGISTRY: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator: instantiate and index the rule by its code."""
    rule = cls()
    if rule.code in _REGISTRY:
        raise ValueError(f"duplicate rule code {rule.code}")
    _REGISTRY[rule.code] = rule
    return cls


def all_rules() -> list[Rule]:
    return [_REGISTRY[c] for c in sorted(_REGISTRY)]


def _selected(rules: Iterable[Rule], select: str | None,
              ignore: str | None) -> list[Rule]:
    out = list(rules)
    if select:
        pres = [p.strip() for p in select.split(",") if p.strip()]
        out = [r for r in out if any(r.code.startswith(p) for p in pres)]
    if ignore:
        pres = [p.strip() for p in ignore.split(",") if p.strip()]
        out = [r for r in out if not any(r.code.startswith(p) for p in pres)]
    return out


def lint_file(path: str | Path, *, select: str | None = None,
              ignore: str | None = None,
              source: str | None = None) -> list[Finding]:
    """Lint one file; returns findings sorted by (line, col, code)."""
    ctx = LintContext(path, source=source)
    if ctx.syntax_error is not None:
        e = ctx.syntax_error
        return [Finding(ctx.path, e.lineno or 1, (e.offset or 1) - 1, "E001",
                        f"syntax error: {e.msg}",
                        line_text=ctx.line_text(e.lineno or 1))]
    found: list[Finding] = []
    for rule in _selected(all_rules(), select, ignore):
        for f in rule.run(ctx):
            if not ctx.suppressed(f):
                found.append(f)
    return sorted(found, key=lambda f: (f.line, f.col, f.code))


def iter_py_files(paths: Iterable[str | Path]) -> list[Path]:
    """Expand files/directories into a sorted, de-duplicated .py file list."""
    out: set[Path] = set()
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out |= {q for q in p.rglob("*.py")
                    if not any(part.startswith(".") for part in q.parts)}
        elif p.suffix == ".py":
            out.add(p)
    return sorted(out)


def lint_paths(paths: Iterable[str | Path], *, select: str | None = None,
               ignore: str | None = None) -> list[Finding]:
    """Lint every .py file under `paths` (files or directories)."""
    found: list[Finding] = []
    for f in iter_py_files(paths):
        found.extend(lint_file(f, select=select, ignore=ignore))
    return sorted(found, key=lambda f: (f.path, f.line, f.col, f.code))
