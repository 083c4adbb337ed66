"""The dry-run's trace (`repro_torch.launch.dryrun.lower_cell`) of every family's
reduced config at `SMOKE_SHAPES`, on fake worlds of 8 ranks: (data 2, model 4)
and (pod 2, data 2, model 2), under `rules_for` with sequence parallelism on.

A train, a prefill and a decode cell of each family (dense, vlm, audio, moe,
hybrid, ssm) must trace: per-rank bytes of its state, the peak over the step
above them, its flops and its collectives. The fake world of each test is
destroyed after it.
"""

import math

import pytest
import torch.distributed as dist

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from torch_threads import one_thread  # noqa: F401

MESHES = {"2x4": (("data", "model"), (2, 4)), "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
FAMILIES = ["qwen3_14b", "pixtral_12b", "musicgen_large", "deepseek_moe_16b", "zamba2_1p2b",
            "rwkv6_7b"]


@pytest.fixture
def mesh(request):
    axes, sizes = MESHES[request.param]
    dryrun.init_fake_world(math.prod(sizes))
    yield tmesh.make_mesh(sizes, axes, "cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("mesh", list(MESHES), indirect=True)
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_cells_trace(arch, mesh):
    cfg = tconfigs.get_config(arch).reduced()
    assert cfg.family in ("dense", "vlm", "audio", "moe", "hybrid", "ssm")
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        trace, m, model = dryrun.lower_cell(arch, name, False, mesh=mesh,
                                            shape=tconfigs.SMOKE_SHAPES[name], cfg=cfg)
        mem = trace["memory"]
        state = mem["param_bytes"] + mem["opt_bytes"] + mem["cache_bytes"]
        assert 0 < mem["param_bytes"] < model.param_count() * 4, name
        assert (mem["opt_bytes"] > 0) == (name == "train_4k"), name
        assert (mem["cache_bytes"] > 0) == (name == "decode_32k"), name
        assert mem["peak_bytes_per_device"] > state, name
        assert trace["cost"]["flops_per_device"] > 0, name
        assert trace["collectives"]["n_ops"] > 0 and trace["collectives"]["once_bytes"] > 0, name
        assert ("policy" in trace) == (name == "train_4k"), name
