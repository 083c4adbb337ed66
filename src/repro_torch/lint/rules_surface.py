"""U-series rules: the public-surface contracts.

The cost math only composes because every public `sim`/`cluster` entry
point states its units (seconds, bytes, $/hr, tokens/s) in its docstring
— the docstring convention. Bare `except:` swallows the very assertion errors
the parity suite relies on, and float-literal equality is how "close
enough" bugs hide in non-test code.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint.framework import Finding, LintContext, Rule, register

_DOC_SUBPACKAGES = ("sim", "cluster")

# parameter names that carry a physical unit; if a public function takes
# one, its docstring must say what the unit is
_UNIT_PARAM_SUFFIXES = (
    "_s", "_sec", "_secs", "_seconds", "_ns", "_bytes", "_gb", "_gib",
    "_tokens", "_usd", "_hr", "_hrs", "_frac", "_qps", "_bw", "_pct",
)
_UNIT_PARAM_NAMES = {
    "qps", "horizon", "ttl", "seconds", "bytes", "tokens", "usd", "frac",
    "rate", "budget", "lookahead", "warmup", "interval", "period",
}
# unit vocabulary a docstring can use to satisfy the convention
_UNIT_WORDS = (
    "second", "seconds", "sec", "[s]", " s)", " s.", "s)", "byte", "bytes",
    "gb", "gib", "token", "tokens", "$", "usd", "/hr", "per hour", "hour",
    "hours", "fraction", "frac", "qps", "req/s", "requests/s", "hz", "%",
    "tokens/s", "steps/s", "ms", "dollar",
)


def _unit_bearing_params(node: ast.FunctionDef | ast.AsyncFunctionDef):
    a = node.args
    params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    out = []
    for p in params:
        low = p.lower()
        if low in _UNIT_PARAM_NAMES or low.endswith(_UNIT_PARAM_SUFFIXES):
            out.append(p)
    return out


def _has_unit_word(doc: str) -> bool:
    low = doc.lower()
    return any(w in low for w in _UNIT_WORDS)


@register
class UnitDocstring(Rule):
    code = "U301"
    name = "unit-docstring"
    summary = "public sim/cluster function lacks a unit-annotated docstring"
    rationale = (
        "Cost math composes across layers only because each public entry "
        "point states its units (seconds, bytes, $/hr, tokens/s) — the "
        "docstring convention. A public function with unit-bearing "
        "parameters and no unit vocabulary in its docstring is where unit "
        "bugs are born."
    )

    def applies(self, ctx: LintContext) -> bool:
        return (not ctx.is_test
                and ctx.subpackage in _DOC_SUBPACKAGES)

    def _public_functions(self, ctx: LintContext):
        """Module-level public defs + public methods of public classes."""
        assert ctx.tree is not None
        for node in ctx.tree.body:  # type: ignore[attr-defined]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not node.name.startswith("_"):
                    yield node
            elif isinstance(node, ast.ClassDef) and not node.name.startswith(
                    "_"):
                for sub in node.body:
                    if (isinstance(sub, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                            and not sub.name.startswith("_")):
                        yield sub

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for fn in self._public_functions(ctx):
            doc = ast.get_docstring(fn)
            units = _unit_bearing_params(fn)
            if doc is None:
                yield ctx.finding(
                    fn, self.code,
                    f"public {fn.name}() has no docstring (unit-annotated "
                    "docstrings are required in sim/cluster)")
            elif units and not _has_unit_word(doc):
                yield ctx.finding(
                    fn, self.code,
                    f"docstring of {fn.name}() never states units, but "
                    f"params look unit-bearing ({', '.join(units[:3])})")


@register
class BareExcept(Rule):
    code = "U302"
    name = "bare-except"
    summary = "bare `except:` swallows everything, including contract errors"
    rationale = (
        "A bare except catches AssertionError and KeyboardInterrupt, "
        "silently eating the exact failures the parity and conservation "
        "tests are designed to surface. Catch the narrowest type that can "
        "actually occur."
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for node in ctx.walk():
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield ctx.finding(
                    node, self.code,
                    "bare except: catches AssertionError/KeyboardInterrupt; "
                    "name the exception type")


@register
class FloatEquality(Rule):
    code = "U303"
    name = "float-equality"
    summary = "==/!= against a float literal in non-test code"
    rationale = (
        "Exact float comparison is either a bug (accumulated values never "
        "hit the literal) or a deliberate sentinel check; the latter is "
        "fine but must say so with a pragma, because the two are "
        "indistinguishable at review time."
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for node in ctx.walk():
            if not isinstance(node, ast.Compare):
                continue
            operands = [node.left] + list(node.comparators)
            for op, left, right in zip(node.ops, operands, operands[1:]):
                if not isinstance(op, (ast.Eq, ast.NotEq)):
                    continue
                if any(isinstance(o, ast.Constant)
                       and isinstance(o.value, float)
                       for o in (left, right)):
                    yield ctx.finding(
                        node, self.code,
                        "==/!= against a float literal; use a tolerance, or "
                        "pragma if this is an exact sentinel")
                    break
