"""D-series rules: the seeded-determinism contract.

Every simulation result in this repo is a pure function of its configs
and seeds — that is what makes the bit-for-bit engine parity matrix
(`tests/test_engine_parity.py`) and the byte-identical golden traces
possible. These rules reject the three classic ways that contract decays:
ambient entropy (unseeded RNGs, wall clocks), address-dependent state
(`id()` keys), and unordered-container iteration feeding order-sensitive
constructs.
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

# deterministic-by-contract layers: results must be pure functions of
# (config, seed). train/launch/serve legitimately read wall clocks.
DETERMINISTIC_SUBPACKAGES = ("sim", "cluster", "obs")

_UNSEEDED_SUFFIXES = (
    "os.urandom",
    "uuid.uuid4",
    "secrets.token_bytes",
    "secrets.token_hex",
    "secrets.randbelow",
    "secrets.choice",
)
# module-level (global-state) RNG entry points; the fix is an explicit
# np.random.default_rng(seed) / SeedSequence spawn
_GLOBAL_RNG = {
    "random": {"random", "randint", "randrange", "choice", "choices",
               "shuffle", "sample", "uniform", "gauss", "normalvariate",
               "betavariate", "expovariate", "seed", "getrandbits"},
    "np.random": {"rand", "randn", "randint", "random", "choice", "shuffle",
                  "permutation", "uniform", "normal", "poisson",
                  "exponential", "lognormal", "seed"},
    "numpy.random": {"rand", "randn", "randint", "random", "choice",
                     "shuffle", "permutation", "uniform", "normal",
                     "poisson", "exponential", "lognormal", "seed"},
}

_WALL_CLOCK_SUFFIXES = (
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "datetime.now",
    "datetime.utcnow",
    "datetime.today",
    "date.today",
)


def _call_name(node: ast.Call) -> str:
    return dotted_name(node.func)


@register
class UnseededRNG(Rule):
    code = "D101"
    name = "unseeded-rng"
    summary = "RNG draw from ambient entropy or module-level global state"
    rationale = (
        "Results must be pure functions of (config, seed). "
        "`np.random.default_rng()` with no seed pulls OS entropy; the "
        "stdlib `random.*` / legacy `np.random.*` module functions share "
        "hidden global state, so call *order* becomes part of the seed. "
        "Use `np.random.default_rng(seed)` or a `SeedSequence` spawn."
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if (name.endswith("default_rng") and not node.args
                    and not node.keywords):
                yield ctx.finding(
                    node, self.code,
                    "default_rng() without a seed draws OS entropy; pass an "
                    "explicit seed or SeedSequence")
                continue
            if any(name == s or name.endswith("." + s)
                   for s in _UNSEEDED_SUFFIXES):
                yield ctx.finding(
                    node, self.code,
                    f"{name}() is ambient entropy; derive randomness from a "
                    "seeded generator")
                continue
            for mod, fns in _GLOBAL_RNG.items():
                head, _, fn = name.rpartition(".")
                if head == mod and fn in fns:
                    yield ctx.finding(
                        node, self.code,
                        f"{name}() uses the shared global RNG stream; use a "
                        "seeded np.random.default_rng instance")
                    break


@register
class WallClock(Rule):
    code = "D102"
    name = "wall-clock"
    summary = "wall-clock read inside a deterministic layer (sim/cluster/obs)"
    rationale = (
        "Simulated time is the only clock the deterministic layers may "
        "observe; a wall-clock read makes replays and the traced/untraced "
        "parity contract machine-dependent. Benchmarks and launch/train "
        "code may time things — the simulator may not."
    )

    def applies(self, ctx: LintContext) -> bool:
        return (not ctx.is_test
                and ctx.subpackage in DETERMINISTIC_SUBPACKAGES)

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if any(name == s or name.endswith("." + s)
                   for s in _WALL_CLOCK_SUFFIXES):
                yield ctx.finding(
                    node, self.code,
                    f"{name}() reads the wall clock inside "
                    f"repro_torch.{ctx.subpackage}; use simulated time")


def _is_unordered(node: ast.AST) -> bool:
    """Expression whose iteration order is a set's (unordered) order."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name in ("set", "frozenset"):
            return True
        # set methods returning sets keep the hazard alive
        if name.endswith((".union", ".intersection", ".difference",
                          ".symmetric_difference")):
            return _is_unordered(node.func.value)  # type: ignore[union-attr]
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_unordered(node.left) or _is_unordered(node.right)
    return False


def _is_dict_values(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "values")


@register
class UnorderedIteration(Rule):
    code = "D103"
    name = "unordered-iteration"
    summary = "set iteration / keyed min-max-sorted over unordered values"
    rationale = (
        "Set iteration order is hash- and history-dependent; feeding it "
        "into a loop, list(), or a keyed min/max/sorted (where ties break "
        "by encounter order) makes results run-to-run unstable. Iterate "
        "`sorted(the_set)` or keep an insertion-ordered structure. Keyed "
        "reductions over `.values()` are flagged too: ties there break by "
        "insertion order, which deserves an explicit tie-break or pragma."
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for node in ctx.walk():
            if isinstance(node, (ast.For, ast.AsyncFor)) and _is_unordered(
                    node.iter):
                yield ctx.finding(
                    node.iter, self.code,
                    "iterating a set: order is unspecified; use sorted(...)")
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    if _is_unordered(gen.iter):
                        yield ctx.finding(
                            gen.iter, self.code,
                            "comprehension over a set: order is unspecified; "
                            "use sorted(...)")
            elif isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name in ("list", "tuple") and node.args and _is_unordered(
                        node.args[0]):
                    yield ctx.finding(
                        node, self.code,
                        f"{name}(set) freezes an unspecified order; use "
                        "sorted(...)")
                if name in ("min", "max", "sorted") and node.args:
                    has_key = any(k.arg == "key" for k in node.keywords)
                    arg0 = node.args[0]
                    if has_key and (_is_unordered(arg0)
                                    or _is_dict_values(arg0)):
                        src = ("a set" if _is_unordered(arg0)
                               else "dict values")
                        yield ctx.finding(
                            node, self.code,
                            f"{name}(key=...) over {src}: ties break by "
                            "encounter order; add an explicit tie-break")
                if name == "heapq.heappush" or name.endswith(".heappush"):
                    # pushes inside a set-iteration loop inherit its order
                    parent = ctx.parents.get(node)
                    while parent is not None and not isinstance(
                            parent, (ast.For, ast.AsyncFor)):
                        parent = ctx.parents.get(parent)
                    if parent is not None and _is_unordered(parent.iter):
                        yield ctx.finding(
                            node, self.code,
                            "heappush inside set iteration: heap insertion "
                            "order (and equal-key pops) become unstable")


@register
class IdBasedKey(Rule):
    code = "D104"
    name = "id-based-key"
    summary = "id() — object identity is address-dependent state"
    rationale = (
        "`id()` values depend on allocator behavior; keying, ordering, or "
        "hashing on them imports memory layout into results. An identity "
        "map that is only ever *looked up* (never iterated or compared) is "
        "safe — suppress those with a justifying pragma."
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for node in ctx.walk():
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "id"
                    and len(node.args) == 1):
                yield ctx.finding(
                    node, self.code,
                    "id() is address-dependent; key on a stable field (rid, "
                    "name, admit_seq) or justify with a pragma")
