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
