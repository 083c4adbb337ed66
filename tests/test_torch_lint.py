"""The port's linter (`repro_torch.lint`) against JAX's (`repro.lint`).

The rule catalog must equal JAX's; each fixture of `tests/lint_fixtures/`
(read, never imported) linted at a synthetic `src/repro_torch/<sub>/` path must
give `expected.json`'s findings and JAX's findings of the same source at
`src/repro/<sub>/`; the pragmas, `--select`/`--ignore`, the baseline, the
reporters and the CLI behave as JAX's tests require of JAX's; the port's tree
passes its own gate with `lint_baseline_torch.json`, which the port alone reads
and writes; and both linters give the same findings on the port's tree.

Where JAX's text names its package (`repro.obs`) the port's names its own
(`repro_torch.obs`); `_ported` maps JAX's text so.
"""

import json
import re
import shutil
from pathlib import Path

import pytest

from repro.lint import all_rules as jax_rules
from repro.lint import lint_file as jax_lint_file
from repro.lint import lint_paths as jax_lint_paths
from repro_torch.lint import all_rules, lint_file, lint_paths
from repro_torch.lint import __main__ as cli
from repro_torch.lint.__main__ import main
from repro_torch.lint.baseline import (
    BASELINE_VERSION,
    DEFAULT_BASELINE,
    load_baseline,
    new_findings,
    write_baseline,
)
from repro_torch.lint.report import render_json, render_text
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "lint_fixtures"

# fixture file -> its subpackage, which scopes D102, P203 and U301 (JAX's tests' map)
FIXTURE_SUBS = {
    "det_violations.py": ("sim", "det_violations.py"),
    "purity_violations.py": ("cluster", "purity_violations.py"),
    "obs_violations.py": ("obs", "obs_violations.py"),
    "surface_violations.py": ("sim", "surface_violations.py"),
    "pragmas.py": ("sim", "pragmas.py"),
    "clean.py": ("sim", "clean.py"),
    "e001_syntax.py.txt": ("sim", "e001_syntax.py"),
}
VIOLATION = "import numpy as np\nr = np.random.default_rng()\n"


def _ported(text: str) -> str:
    """JAX's catalog or message text as the port words it: the package named
    `repro_torch.`, and U301's convention without the history of its name."""
    return re.sub(r"the PR \d+ docstring", "the docstring", re.sub(r"\brepro\.", "repro_torch.", text))


def _fixture(name: str, package: str = "repro_torch", **kw):
    sub, base = FIXTURE_SUBS[name]
    lint = lint_file if package == "repro_torch" else jax_lint_file
    return lint(f"src/{package}/{sub}/{base}", source=(FIXTURES / name).read_text(), **kw)


def _key(f, root: Path | None = None):
    """A finding as (path under `src/<package>/`, line, col, code, message), JAX's
    message in the port's words."""
    path = Path(f.path)
    if root is not None:
        path = path.relative_to(root)
    rel = Path(*path.parts[path.parts.index("src") + 2:]).as_posix()
    return rel, f.line, f.col, f.code, _ported(f.message)


# ---------------------------------------------------------------- catalog


def test_rule_catalog_equals_jax():
    ours = [(r.code, r.name, r.summary, r.rationale) for r in all_rules()]
    theirs = [(r.code, r.name, r.summary, _ported(r.rationale)) for r in jax_rules()]
    assert len(ours) == 11 and ours == theirs
    assert len({r.code for r in all_rules()}) == 11
    assert all(r.summary and r.rationale for r in all_rules())


# ---------------------------------------------------------------- findings


@pytest.mark.parametrize("name", list(FIXTURE_SUBS))
def test_fixture_gives_expected_and_jax_findings(name):
    """`expected.json`'s (line, code) pairs, and JAX's findings of the same source
    at `src/repro/<sub>/`: the same line, col and code, the message in the port's
    words."""
    expected = json.loads((FIXTURES / "expected.json").read_text())
    assert set(expected) == set(FIXTURE_SUBS)
    ours = _fixture(name)
    assert [[f.line, f.code] for f in ours] == expected[name]
    assert [_key(f) for f in ours] == [_key(f) for f in _fixture(name, "repro")]
    assert all(f.path.startswith("src/repro_torch/") for f in ours)


def test_fixtures_cover_every_rule_code():
    codes = {f.code for name in FIXTURE_SUBS for f in _fixture(name)}
    assert codes == {r.code for r in all_rules()} | {"E001"}


def test_subpackage_reads_the_part_after_repro_torch():
    """The scoped rules fire under `src/repro_torch/<sub>/` and nowhere else: not
    under JAX's package path, nor in a test file."""
    src = "import time\nt = time.time()\n"
    found = lint_file("src/repro_torch/obs/x.py", source=src)
    assert [f.code for f in found] == ["D102"]
    assert found[0].message == "time.time() reads the wall clock inside repro_torch.obs; use simulated time"
    assert lint_file("src/repro/obs/x.py", source=src) == []
    assert lint_file("src/repro_torch/launch/x.py", source=src) == []
    assert lint_file("tests/test_something.py", source="assert ttft == 0.25\n") == []
    assert lint_file("src/repro_torch/sim/x.py", source="assert ttft == 0.25\n") != []


# ----------------------------------------------------------------- pragmas

PRAGMAS = {
    "same line": ("k = id(object())  # lint: disable=D104 -- lookup only\n", []),
    "next line": ("# lint: disable-next=D104\n# another comment in between\nk = id(object())\n", []),
    "file": ("# lint: disable-file=D104\nk = id(object())\nj = id(list())\n", []),
    "wrong code": ("import numpy as np\nr = np.random.default_rng()  # lint: disable=U303\n",
                   ["D101"]),
}


@pytest.mark.parametrize("case", list(PRAGMAS))
def test_pragmas(case):
    src, codes = PRAGMAS[case]
    assert [f.code for f in lint_file("src/repro_torch/sim/x.py", source=src)] == codes


def test_clean_and_pragma_fixtures_are_clean():
    assert _fixture("clean.py") == [] and _fixture("pragmas.py") == []


def test_select_and_ignore_prefixes():
    found = _fixture("det_violations.py")
    only_d = _fixture("det_violations.py", select="D101,D102")
    assert {f.code for f in only_d} == {"D101", "D102"}
    assert not any(f.code.startswith("D") for f in _fixture("det_violations.py", ignore="D"))
    assert len(found) > len(only_d)


# ---------------------------------------------------------------- baseline


def _roundtrip(tmp_path):
    findings = _fixture("det_violations.py")
    write_baseline(findings, tmp_path / "bl.json")
    assert findings and new_findings(findings, load_baseline(tmp_path / "bl.json")) == []


def _line_shift(tmp_path):
    write_baseline(lint_file("src/repro_torch/sim/x.py", source=VIOLATION), tmp_path / "bl.json")
    later = lint_file("src/repro_torch/sim/x.py", source="# a new leading comment\n" + VIOLATION)
    assert new_findings(later, load_baseline(tmp_path / "bl.json")) == []


def _count_cap(tmp_path):
    one = "r = id(object())\n"
    write_baseline(lint_file("src/repro_torch/sim/x.py", source=one), tmp_path / "bl.json")
    left = new_findings(lint_file("src/repro_torch/sim/x.py", source=one + one),
                        load_baseline(tmp_path / "bl.json"))
    assert [f.code for f in left] == ["D104"]


def _version(tmp_path):
    (tmp_path / "bl.json").write_text(json.dumps({"version": 999, "findings": {}}))
    with pytest.raises(ValueError, match="version"):
        load_baseline(tmp_path / "bl.json")


def _missing(tmp_path):
    assert load_baseline(tmp_path / "nope.json") == {}


BASELINE_CASES = {"roundtrip": _roundtrip, "line-number invariance": _line_shift,
                  "count cap": _count_cap, "version mismatch": _version, "missing file": _missing}


@pytest.mark.parametrize("case", list(BASELINE_CASES))
def test_baseline(case, tmp_path):
    BASELINE_CASES[case](tmp_path)


def test_baseline_format_is_jax(tmp_path):
    """The same fingerprints, version and JSON as JAX's baseline writer."""
    from repro.lint.baseline import write_baseline as jax_write

    findings = lint_file("src/repro_torch/sim/x.py", source=VIOLATION + "k = id(1)\nk = id(1)\n")
    assert BASELINE_VERSION == 1
    ours = write_baseline(findings, tmp_path / "a.json")
    assert ours == jax_write(findings, tmp_path / "b.json")
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()


# --------------------------------------------------------------- reporters


def test_render_text_and_json():
    findings = _fixture("surface_violations.py")
    text = render_text(findings)
    assert "U302" in text and "finding(s)" in text
    data = json.loads(render_json(findings))
    assert all(set(d) >= {"path", "line", "col", "code", "message"} for d in data)
    assert [d["code"] for d in data] == [f.code for f in findings]


# ---------------------------------------------------------------- CLI gate


def test_cli_fails_on_a_violation(tmp_path, capsys):
    (tmp_path / "bad.py").write_text(VIOLATION)
    assert main([str(tmp_path / "bad.py"), "--no-baseline"]) == 1
    out = capsys.readouterr().out
    assert "D101" in out and "default_rng" in out


def test_cli_clean_exits_zero(tmp_path, capsys):
    (tmp_path / "good.py").write_text('"""Nothing to see."""\n')
    assert main([str(tmp_path / "good.py"), "--check"]) == 0
    assert "repro_torch.lint: clean" in capsys.readouterr().out


def test_cli_write_baseline_then_gate(tmp_path, capsys):
    bad, bl = tmp_path / "bad.py", tmp_path / "bl.json"
    bad.write_text(VIOLATION)
    assert main([str(bad), "--baseline", str(bl), "--write-baseline"]) == 0
    assert main([str(bad), "--baseline", str(bl), "--check"]) == 0
    assert main([str(bad), "--baseline", str(bl), "--no-baseline"]) == 1
    capsys.readouterr()


def test_cli_json_format(tmp_path, capsys):
    (tmp_path / "bad.py").write_text(VIOLATION)
    assert main([str(tmp_path / "bad.py"), "--no-baseline", "--format", "json"]) == 1
    assert json.loads(capsys.readouterr().out)[0]["code"] == "D101"


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(r.code in out for r in all_rules())


def test_cli_defaults_are_the_ports_tree_and_baseline(tmp_path, monkeypatch, capsys):
    """With no paths and no `--baseline`, the CLI lints `<root>/src/repro_torch` and
    writes and reads `<root>/lint_baseline_torch.json`; JAX's `lint_baseline.json`
    is neither read nor written."""
    (tmp_path / "src" / "repro_torch" / "sim").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "sim" / "bad.py").write_text(VIOLATION)
    (tmp_path / "src" / "repro").mkdir()
    (tmp_path / "src" / "repro" / "other.py").write_text("k = id(1)\n")
    jax_baseline = tmp_path / "lint_baseline.json"
    jax_baseline.write_text("not json: never read\n")
    monkeypatch.setattr(cli, "_repo_root", lambda: tmp_path)
    assert DEFAULT_BASELINE == "lint_baseline_torch.json"
    assert main([]) == 1
    assert main(["--write-baseline"]) == 0
    assert main([]) == 0
    written = load_baseline(tmp_path / DEFAULT_BASELINE)
    assert sum(written.values()) == 1 and all("::D101::" in k for k in written)
    assert jax_baseline.read_text() == "not json: never read\n"
    capsys.readouterr()


# ------------------------------------------------------------ live tree


def test_ports_tree_passes_its_gate():
    """`src/repro_torch/` leaves nothing outside `lint_baseline_torch.json`, which
    ships empty (JAX's bar is <= 10)."""
    findings = lint_paths([REPO / "src" / "repro_torch"])
    baseline = load_baseline(REPO / DEFAULT_BASELINE)
    assert new_findings(findings, baseline) == [], render_text(new_findings(findings, baseline))
    assert sum(baseline.values()) <= 10 and baseline == {}


def _copy_tree(dst: Path, strip: bool) -> None:
    shutil.copytree(REPO / "src" / "repro_torch", dst, ignore=shutil.ignore_patterns("__pycache__"))
    if strip:  # the pragmas made inert: every finding they suppress comes back
        for p in dst.rglob("*.py"):
            p.write_text(p.read_text().replace("# lint: disable", "# lint: dropped"))


@pytest.mark.parametrize("strip", [False, True], ids=["as is", "pragmas dropped"])
def test_both_linters_agree_on_the_ports_tree(strip, tmp_path):
    """JAX's linter over a copy of `src/repro_torch/` placed as `src/repro/` gives the
    port's findings over the same copy at `src/repro_torch/`, finding for finding:
    none as the tree is, and with its pragmas made inert the findings they
    suppress."""
    _copy_tree(tmp_path / "port" / "src" / "repro_torch", strip)
    _copy_tree(tmp_path / "jax" / "src" / "repro", strip)
    ours = [_key(f, tmp_path / "port") for f in lint_paths([tmp_path / "port" / "src" / "repro_torch"])]
    theirs = [_key(f, tmp_path / "jax") for f in jax_lint_paths([tmp_path / "jax" / "src" / "repro"])]
    assert ours == theirs
    assert bool(ours) == strip
    if strip:
        assert ("launch/dryrun.py", "D104") in {(k[0], k[3]) for k in ours}
