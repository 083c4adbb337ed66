"""P-series rules: the purity / observational contracts.

Configs are value objects shared across runs and worker processes;
mutable defaults and post-construction mutation alias state between
simulations that must be independent. The `obs` layer is *observational
by contract* — the traced-equals-untraced parity tests depend on tracing
and monitoring never writing into engine objects.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint.framework import (
    Finding,
    LintContext,
    Rule,
    dotted_name,
    register,
)

_MUTABLE_CALLS = {
    "list", "dict", "set", "bytearray", "deque", "defaultdict",
    "collections.deque", "collections.defaultdict", "collections.Counter",
    "Counter", "OrderedDict", "collections.OrderedDict",
    "np.zeros", "np.ones", "np.empty", "np.array",
    "numpy.zeros", "numpy.ones", "numpy.empty", "numpy.array",
}


def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in _MUTABLE_CALLS
    return False


def _is_field_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and dotted_name(node.func) in ("field", "dataclasses.field"))


def _is_dataclass_decorated(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if dotted_name(target) in ("dataclass", "dataclasses.dataclass"):
            return True
    return False


@register
class MutableDefaultArg(Rule):
    code = "P201"
    name = "mutable-default-arg"
    summary = "mutable default argument value"
    rationale = (
        "Default values are evaluated once at def time; a mutable default "
        "is shared state across every call — the classic aliasing bug. "
        "Default to None and construct inside the function."
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for node in ctx.walk():
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if _is_mutable_literal(d):
                    yield ctx.finding(
                        d, self.code,
                        f"mutable default in {node.name}(): evaluated once "
                        "and shared across calls; default to None")


@register
class DataclassMutableDefault(Rule):
    code = "P202"
    name = "dataclass-mutable-default"
    summary = "dataclass field holds a mutable default"
    rationale = (
        "A mutable dataclass default is shared by every instance (list/"
        "dict/set even raise at class-definition time). Use "
        "`field(default_factory=...)` so each config owns its value — "
        "configs cross process boundaries in planner sweeps."
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for node in ctx.walk():
            if not (isinstance(node, ast.ClassDef)
                    and _is_dataclass_decorated(node)):
                continue
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign) and stmt.value is not None
                        and not _is_field_call(stmt.value)
                        and _is_mutable_literal(stmt.value)):
                    yield ctx.finding(
                        stmt.value, self.code,
                        f"mutable default on dataclass {node.name}; use "
                        "field(default_factory=...)")


class _ParamWriteScanner(ast.NodeVisitor):
    """Find attribute writes on names bound as function parameters.

    Walks function bodies with a scope stack so closures over an outer
    function's parameter are still caught; `self`/`cls` are exempt (a
    method owning its instance is not the hazard these rules target).
    """

    def __init__(self, param_filter):
        # param_filter(name, annotation_node) -> bool: is this param suspect
        self.param_filter = param_filter
        self.stack: list[set[str]] = []
        self.hits: list[tuple[ast.AST, str, str]] = []  # (node, obj, attr)

    def _params(self, node) -> dict[str, ast.AST | None]:
        a = node.args
        params = {p.arg: p.annotation
                  for p in a.posonlyargs + a.args + a.kwonlyargs}
        if a.vararg:
            params[a.vararg.arg] = a.vararg.annotation
        if a.kwarg:
            params[a.kwarg.arg] = a.kwarg.annotation
        params.pop("self", None)
        params.pop("cls", None)
        return params

    def visit_FunctionDef(self, node):
        self.stack.append({n for n, ann in self._params(node).items()
                           if self.param_filter(n, ann)})
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_target(self, node, target):
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and any(target.value.id in scope for scope in self.stack)):
            self.hits.append((node, target.value.id, target.attr))

    def visit_Assign(self, node):
        for t in node.targets:
            self._check_target(node, t)
            if isinstance(t, (ast.Tuple, ast.List)):
                for elt in t.elts:
                    self._check_target(node, elt)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_target(node, node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._check_target(node, node.target)
        self.generic_visit(node)


@register
class ObservationalWrite(Rule):
    code = "P203"
    name = "observational-write"
    summary = "obs code writes an attribute on an object it was handed"
    rationale = (
        "Tracing and monitoring are observational by contract: the "
        "traced==untraced and monitored==plain parity tests assume the "
        "obs layer never mutates engine or replica state. Any attribute "
        "write on a parameter inside repro_torch.obs breaks that one-way glass."
    )

    def applies(self, ctx: LintContext) -> bool:
        return not ctx.is_test and ctx.subpackage == "obs"

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        assert ctx.tree is not None
        # params annotated with a type this module itself defines are the
        # module's own state objects (e.g. monitor._SloState), not engine
        # objects handed across the observational boundary
        own_types = {n.name for n in ast.walk(ctx.tree)
                     if isinstance(n, ast.ClassDef)}

        def suspect(name: str, ann) -> bool:
            t = None
            if isinstance(ann, ast.Name):
                t = ann.id
            elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                t = ann.value.strip("'\"")
            return t not in own_types

        scanner = _ParamWriteScanner(suspect)
        scanner.visit(ctx.tree)
        for node, obj, attr in scanner.hits:
            yield ctx.finding(
                node, self.code,
                f"writes {obj}.{attr} on a passed-in object; repro_torch.obs must "
                "stay observational (traced == untraced)")


_CONFIG_PARAM = ("cfg", "config", "spec")


def _looks_like_config(name: str, ann) -> bool:
    """Config-ish by name (cfg/config/spec) or by annotated type name
    (`...Config` / `...Spec`, including string annotations)."""
    low = name.lower()
    if low in _CONFIG_PARAM or any(
            low.endswith("_" + s) for s in _CONFIG_PARAM):
        return True
    t = None
    if isinstance(ann, ast.Name):
        t = ann.id
    elif isinstance(ann, ast.Attribute):
        t = ann.attr
    elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        t = ann.value.strip("'\"")
    return t is not None and t.endswith(("Config", "Spec"))


@register
class ConfigMutation(Rule):
    code = "P204"
    name = "config-mutation"
    summary = "mutates a config/spec parameter in place"
    rationale = (
        "Configs are value objects: the same instance is reused across "
        "sweep candidates, worker processes, and parity runs. Mutating a "
        "caller's config aliases those runs together. Return a modified "
        "copy (dataclasses.replace) — or pragma an API whose documented "
        "job is in-place seeding."
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        scanner = _ParamWriteScanner(_looks_like_config)
        assert ctx.tree is not None
        scanner.visit(ctx.tree)
        for node, obj, attr in scanner.hits:
            yield ctx.finding(
                node, self.code,
                f"writes {obj}.{attr}: configs are shared value objects; "
                "return dataclasses.replace(...) instead")
