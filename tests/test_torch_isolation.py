"""The port stands alone: no JAX, nothing of `repro`, and no silent CPU fallback."""

import ast
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.serve import run
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def _port_files() -> list[Path]:
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "chip_compare.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 20 and ROOT / "scripts" / "chip_compare.py" in files
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & set(FORBIDDEN)) for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_the_planner_and_the_dryrun_are_in_the_walk():
    """The nine copies of `repro.core`, the dry-run, and the module `chip_smoke.py`'s
    phase 11 runs in a subprocess (`--auto-plan`) are among the files checked."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    files = set(_port_files())
    core = ROOT / "src" / "repro_torch" / "core"
    for name in ("hardware", "roofline", "operators", "parallelism", "comm", "memory", "predict",
                 "planner", "paper_data"):
        assert core / f"{name}.py" in files, name
    assert ROOT / "src" / "repro_torch" / "launch" / "dryrun.py" in files
    module = chip_smoke.AUTO_PLAN[chip_smoke.AUTO_PLAN.index("-m") + 1]
    assert ROOT / "src" / Path(*module.split(".")).with_suffix(".py") in files


def test_the_simulator_and_obs_are_in_the_walk():
    """The KV model, the DSE, and every module of JAX's `sim` and `obs` packages
    have their copy in the port, and each copy is among the files checked, as is
    the module `chip_smoke.py`'s phase 12 runs in a subprocess."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    files = set(_port_files())
    port = ROOT / "src" / "repro_torch"
    assert {port / "core" / "kvcache.py", port / "core" / "dse.py"} <= files
    for pkg in ("sim", "obs"):
        names = sorted(p.name for p in (ROOT / "src" / "repro" / pkg).glob("*.py"))
        assert len(names) >= 7, pkg
        for name in names:
            assert port / pkg / name in files, f"{pkg}/{name}"
    module = chip_smoke.SIM_CLI[chip_smoke.SIM_CLI.index("-m") + 1]
    assert ROOT / "src" / Path(*module.split(".")) / "__main__.py" in files


def test_the_cluster_is_in_the_walk():
    """Every module of JAX's `cluster` package has its copy in the port, and each
    copy is among the files checked, as is the module `chip_smoke.py`'s phase 13
    runs in a subprocess."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    files = set(_port_files())
    names = sorted(p.name for p in (ROOT / "src" / "repro" / "cluster").glob("*.py"))
    assert len(names) == 8
    for name in names:
        assert ROOT / "src" / "repro_torch" / "cluster" / name in files, name
    module = chip_smoke.CLUSTER_CLI[chip_smoke.CLUSTER_CLI.index("-m") + 1]
    assert ROOT / "src" / Path(*module.split(".")) / "__main__.py" in files


def test_every_module_of_repro_has_its_counterpart_in_the_walk():
    """Each module of `src/repro/` has a counterpart at the same path under
    `src/repro_torch/` (the linter, `core/cellcost.py` and `core/hlo.py` the last of
    them), and each is among the files checked, as is the module `chip_smoke.py`'s
    phase 14 runs in a subprocess."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    files = set(_port_files())
    jax_modules = sorted((ROOT / "src" / "repro").rglob("*.py"))
    assert len(jax_modules) > 90
    missing = [str(p.relative_to(ROOT / "src" / "repro")) for p in jax_modules
               if ROOT / "src" / "repro_torch" / p.relative_to(ROOT / "src" / "repro") not in files]
    assert missing == []
    module = chip_smoke.LINT_GATE[chip_smoke.LINT_GATE.index("-m") + 1]
    assert ROOT / "src" / Path(*module.split(".")) / "__main__.py" in files


def test_the_check_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom repro.models import layers\nimport jax.numpy as jnp\n")
    assert _imported_roots(f) & set(FORBIDDEN) == {"repro", "jax"}


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(get_config("qwen3_14b").reduced(), requests=1)
    assert resolve_device("cpu") == torch.device("cpu")
