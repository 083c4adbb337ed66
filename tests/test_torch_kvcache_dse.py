"""The port's KV-cache model and technology-node DSE against JAX's, bit for bit.

`repro_torch.core.kvcache` (the paper's §3.5 formula) and `repro_torch.core.dse`
(§3.6, §5.3) are copies of `repro.core`'s over the port's config: every number
must equal JAX's exactly. The formula must also equal the bytes of the cache the
port's model really allocates: `Model.cache_shapes` on the meta device, at full
width, for every config, with nothing allocated.
"""

from dataclasses import asdict

import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.core import dse as jdse
from repro.core import kvcache as jkv
from repro.core import paper_data as jpaper
from repro.core import parallelism as jpar
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import dse as tdse
from repro_torch.core import kvcache as tkv
from repro_torch.core import paper_data as tpaper
from repro_torch.core import parallelism as tpar
from repro_torch.models.transformer import Model
from torch_threads import one_thread  # noqa: F401

BATCHES = (1, 3, 4, 16)
CONTEXTS = (1, 300, 2048, 4096, 4097, 8192, 32768)
DRAMS = ("HBM2", "HBM2E", "HBM3", "HBM4")
NETS = tuple(tdse.NETS)


def _bits(x):
    return float(x).hex()


def _cache_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_cache_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_cache_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return tree.numel() * tree.element_size()
    return 0


def test_every_config_is_covered():
    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_formula_equals_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for B in BATCHES:
        assert _bits(tkv.recurrent_state_bytes(cfg, B)) == _bits(jkv.recurrent_state_bytes(jcfg, B))
        for T in CONTEXTS:
            for prec in (1, 2, 4):
                assert _bits(tkv.kv_cache_bytes(cfg, B, T, prec)) == \
                    _bits(jkv.kv_cache_bytes(jcfg, B, T, prec))
    assert tkv._attn_layers(cfg) == jkv._attn_layers(jcfg)
    red, jred = cfg.reduced(), jcfg.reduced()
    assert _bits(tkv.kv_cache_bytes(red, 2, 64) + tkv.recurrent_state_bytes(red, 2)) == \
        _bits(jkv.kv_cache_bytes(jred, 2, 64) + jkv.recurrent_state_bytes(jred, 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_formula_equals_the_ports_cache(arch):
    """§3.5 against the cache the port's model builds: full width, meta device."""
    cfg = get_config(arch)
    model = Model(cfg)
    for B, T in ((4, 2048), (4, 8192), (3, 4097), (1, 300)):
        formula = tkv.kv_cache_bytes(cfg, B, T) + tkv.recurrent_state_bytes(cfg, B)
        assert _cache_bytes(model.cache_shapes(B, T)) == formula, (B, T)


def test_build_chip_grid():
    for node in tdse.NODES:
        for dram in DRAMS:
            for net in NETS:
                for f_core in (0.15, 0.4, 0.6180339887498949, 0.72):
                    port = tdse.build_chip(node, f_core, dram, net)
                    jax = jdse.build_chip(node, f_core, dram, net)
                    assert repr(asdict(port)) == repr(asdict(jax)), (node, dram, net, f_core)
    assert (tdse.NODES, tdse.AREA_SCALE, tdse.POWER_SCALE, tdse.SRAM_SCALE) == \
        (jdse.NODES, jdse.AREA_SCALE, jdse.POWER_SCALE, jdse.SRAM_SCALE)


@pytest.mark.parametrize("model", ["gpt-175b", "qwen3_14b"])
def test_optimize_node_and_sweep(model):
    """Every point of the §5.3 sweep (nodes x DRAM x network) equals JAX's."""
    if model in ARCHS:
        cfg, jcfg = get_config(model), jax_get_config(model)
        kw = dict(global_batch=64, seq=2048)
        m, jm = tpar.Mapping(dp=8, tp=1, pp=1, microbatch=1), jpar.Mapping(dp=8, tp=1, pp=1,
                                                                           microbatch=1)
    else:
        cfg, jcfg = tpaper.GPT_CONFIGS[model], jpaper.GPT_CONFIGS[model]
        kw = dict(global_batch=1024, seq=2048)
        m = tpar.Mapping(dp=16, tp=8, pp=8, microbatch=1)
        jm = jpar.Mapping(dp=16, tp=8, pp=8, microbatch=1)
    port = tdse.sweep(cfg, mapping=m, **kw)
    jax = jdse.sweep(jcfg, mapping=jm, **kw)
    assert len(port) == len(tdse.NODES) * len(DRAMS) * len(NETS)
    assert repr([asdict(p) for p in port]) == repr([asdict(p) for p in jax])
    one = tdse.optimize_node(cfg, "N3", "HBM3", "NDR-x8", mapping=m, iters=20, **kw)
    assert repr(asdict(one)) == repr(asdict(jdse.optimize_node(jcfg, "N3", "HBM3", "NDR-x8",
                                                               mapping=jm, iters=20, **kw)))
