"""The port's sharding rules and layouts against JAX's, spec by spec.

No process and no allocation: JAX's `use_mesh` only sets a context variable,
and its `sanitize_pspec`, `_zero1_spec` and `axes_size` read only the mesh's
`shape`, so a stand-in with a `shape` dict gives JAX's PartitionSpecs for any
mesh on one CPU device. The port reads the same stand-in (its `mesh_sizes`),
and its DTensor placements are checked against JAX's entries through a
stand-in carrying `mesh_dim_names`.
"""

import types

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES, TrainConfig as JaxTrainConfig
from repro.launch import mesh as jmesh
from repro.models.transformer import Model as JaxModel
from repro.parallel import axes as jaxes
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.models.params import param_defs, param_shapes
from repro_torch.models.transformer import Model
from repro_torch.parallel import axes as taxes
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import paths
from torch_threads import one_thread  # noqa: F401

MESHES = {"2x4": (("data", "model"), (2, 4)), "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
          "16x16": (("data", "model"), (16, 16))}


def _meshes(name):
    """(JAX's stand-in, the port's stand-in) of one mesh."""
    axes, shape = MESHES[name]
    return (types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes),
            types.SimpleNamespace(shape=shape, mesh_dim_names=axes))


def _launcher_rules(axes, mod):
    """The launcher's rules (`repro/launch/train.py:68-75`) in either package."""
    return mod.make_rules(dp=tuple(a for a in axes if a != "model"), tp=("model",))


def _norm(spec, rank):
    """A spec (JAX's PartitionSpec or the port's tuple) as a tuple of `rank` entries."""
    entries = tuple(spec)
    return entries + (None,) * (rank - len(entries))


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


@pytest.mark.parametrize("name", ["dp", "tp", "sp", "ep", "cp", "zero", None, ("dp", "tp"),
                                  ("tp", "dp"), ("sp", "cp"), "nope"])
@pytest.mark.parametrize("kw", [dict(dp=("data",), tp=("model",)),
                                dict(dp=("pod", "data"), tp=("model",), sequence_parallel=True,
                                     zero1=False),
                                dict(dp=(), tp=("model",), context_parallel=("data",))])
def test_resolve_and_make_rules_match_jax(name, kw):
    ours, theirs = taxes.make_rules(**kw), jaxes.make_rules(**kw)
    assert ours.resolve(name) == theirs.resolve(name)
    assert [getattr(ours, f) for f in ("dp", "tp", "sp", "ep", "cp", "zero")] == \
        [getattr(theirs, f) for f in ("dp", "tp", "sp", "ep", "cp", "zero")]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", [None, *SHAPES.values()])
@pytest.mark.parametrize("sp", [True, False])
def test_rules_for_matches_jax(mesh, shape, sp):
    jm, tm = _meshes(mesh)
    assert tmesh.rules_for(tm, shape, sequence_parallel=sp) == \
        taxes.ShardingRules(**vars(jmesh.rules_for(jm, shape, sequence_parallel=sp)))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitize_axes_size_and_zero1_spec_match_jax(mesh):
    jm, tm = _meshes(mesh)
    axes = MESHES[mesh][0]
    specs = [(), ("model",), (None, "model"), ("model", None, "data"), (("data", "model"), None),
             (None, None, None)]
    shapes = [(7,), (16,), (8, 12), (4, 16, 6), (32, 5), (35, 6, 64), (2, 3, 4), (1,)]
    jr, tr = _launcher_rules(axes, jaxes), _launcher_rules(axes, taxes)
    with jaxes.use_mesh(jm, jr), taxes.use_mesh(tm, tr):
        for name in ("dp", "tp", "ep", "zero", "sp"):
            assert taxes.axes_size(name) == jaxes.axes_size(name)
        for spec in specs:
            for shape in shapes:
                if len(spec) > len(shape) or any(a not in axes for e in spec if e
                                                 for a in (e if isinstance(e, tuple) else (e,))):
                    continue
                assert taxes.sanitize_pspec(spec, shape, tm) == \
                    _norm(jaxes.sanitize_pspec(P(*spec), shape, jm), len(shape))
                assert _norm(topt._zero1_spec(spec, shape), len(shape)) == \
                    _norm(jopt._zero1_spec(P(*spec), shape), len(shape))


def _check_placements(spec, tm):
    """The port's DTensor placements of a sanitized spec say what JAX's entries say."""
    from torch.distributed.tensor import Replicate, Shard

    pl = taxes.placements(spec, tm)
    for i, a in enumerate(tm.mesh_dim_names):
        dims = [d for d, e in enumerate(spec) if e and a in (e if isinstance(e, tuple) else (e,))]
        assert pl[i] == (Shard(dims[0]) if dims else Replicate()), (spec, pl)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_and_moment_spec_matches_jax(arch, mesh):
    """All ten configs at full size (specs only): every parameter's spec, its fp32
    and int8 AdamW moments' (ZeRO-1), raw and sanitized as the trainers place
    them, and the port's DTensor placements of the sanitized ones."""
    jm, tm = _meshes(mesh)
    axes = MESHES[mesh][0]
    jr, tr = _launcher_rules(axes, jaxes), _launcher_rules(axes, taxes)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmodel = JaxModel(jcfg)
    for opt in ("adamw", "adamw8bit"):
        with jaxes.use_mesh(jm, jr):
            jp, jshapes = jmodel.pspecs(), jmodel.pshapes()
            jo = jopt.opt_state_specs(jp, jshapes, JaxTrainConfig(optimizer=opt))
            joshapes = jax.eval_shape(lambda p: jopt.adamw_init(p, JaxTrainConfig(optimizer=opt)),
                                      jshapes)
            jsan = {"params": jaxes.sanitize_spec_tree(jp, jshapes, jm),
                    "opt": jaxes.sanitize_spec_tree(jo, joshapes, jm)}
        with taxes.use_mesh(tm, tr):
            tp = Model(cfg).pspecs()
            tshapes = param_shapes(param_defs(cfg))
            to = topt.opt_state_specs(tp, tshapes, TrainConfig(optimizer=opt))
            toshapes = topt.opt_state_shapes(tshapes, TrainConfig(optimizer=opt))
            tsan = {"params": taxes.sanitize_spec_tree(tp, tshapes, tm),
                    "opt": taxes.sanitize_spec_tree(to, toshapes, tm)}
        theirs = {**_jax_leaves({"params": jp, "opt": jo}),
                  **{f"sanitized/{k}": v for k, v in _jax_leaves(jsan).items()}}
        shapes = {**dict(paths({"params": tshapes, "opt": toshapes})),
                  **{f"sanitized/{k}": v for k, v in paths({"params": tshapes, "opt": toshapes})}}
        ours = {**dict(paths({"params": tp, "opt": to})),
                **{f"sanitized/{k}": v for k, v in paths(tsan)}}
        ours = {k: v for k, v in ours.items() if not isinstance(v, dict)}
        assert ours.keys() == theirs.keys()
        for k, spec in ours.items():
            rank = len(shapes[k])
            assert _norm(spec, rank) == _norm(theirs[k], rank), (opt, k)
            if k.startswith("sanitized/"):
                _check_placements(_norm(spec, rank), tm)


def test_zero1_shards_moments_on_top_of_tensor_parallelism():
    """The ZeRO axes land on the largest divisible unsharded dim; a leaf whose spec
    already uses them (arctic's experts under shard_ff_dp) keeps its spec."""
    _, tm = _meshes("2x4")
    with taxes.use_mesh(tm, taxes.make_rules(dp=("data",), tp=("model",))):
        assert topt._zero1_spec((None, "model"), (64, 256)) == ("data", "model")
        assert topt._zero1_spec(("model", None, "data"), (8, 64, 32)) == ("model", None, "data")
        assert topt._zero1_spec((None,), (3,)) == (None,)  # 3 is not a multiple of 2
    with taxes.use_mesh(tm, taxes.make_rules(dp=("data",), tp=("model",), zero1=False)):
        assert topt._zero1_spec((None, "model"), (64, 256)) == (None, "model")


def test_off_a_mesh_every_helper_is_the_identity():
    import torch

    x = torch.ones(2, 3)
    assert taxes.current_mesh() is None and taxes.axes_size("dp") == 1
    assert taxes.shard(x, "dp", "tp") is x and taxes.whole(x) is x
    assert taxes.on_shards(lambda t, s: t * s, x, params=(torch.tensor(2.0),)).sum() == 12
    assert taxes.named_sharding("dp") is None
    assert topt._zero1_spec((None, "model"), (64, 256)) == (None, "model")


def test_placements_refuse_an_entry_out_of_mesh_order():
    _, tm = _meshes("2x2x2")
    with pytest.raises(ValueError, match="mesh's axis order"):
        taxes.placements((("data", "pod"), None), tm)


def test_moe_dispatch_groups_match_jax():
    """Under a mesh whose dp axes are 2 wide the MoE layer dispatches in 2 groups of
    contiguous tokens, each with the capacity of its T / 2 tokens, and averages the
    load-balance statistics over the groups (JAX's `_n_groups`, `_moe_group` under
    vmap, `apply_moe`): the port on one device under a stand-in mesh against JAX's
    `_moe_group` on each group. A tight capacity, so the groups drop other tokens
    than one group of all T would."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models import moe as jmoe
    from repro.models.params import init_params as jax_init_params
    from repro_torch.models import moe
    from test_torch_moe import _layer_cfgs, _torch_tree

    jcfg, cfg = _layer_cfgs(cf=0.5, shared=2)
    jp = jax_init_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0), jnp.float32)
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    x = 0.5 * np.random.default_rng(1).standard_normal((2, 32, cfg.d_model), dtype=np.float32)
    G, Tg = 2, 32
    C = jmoe.capacity(jcfg.moe, Tg)
    experts = {k: jp[k] for k in ("router", "wi", "wo", "wg") if k in jp}
    groups = [jmoe._moe_group(jcfg, experts, jnp.asarray(xg), C) for xg in x.reshape(G, Tg, -1)]
    jy = np.concatenate([np.asarray(y) for y, _ in groups]) + np.asarray(
        jmoe.apply_mlp(jp["shared"], jnp.asarray(x.reshape(G * Tg, -1)), jcfg.act))
    st = {k: np.stack([np.asarray(s[k]) for _, s in groups]) for k in groups[0][1]}
    jaux = {"moe_lb_loss": jcfg.moe.num_experts * np.sum(st["me"].mean(0) * st["ce"].mean(0)),
            "moe_z_loss": st["z"].mean(), "moe_drop_frac": st["drop"].mean()}
    standin = types.SimpleNamespace(shape=(2, 1), mesh_dim_names=("data", "model"))
    with taxes.use_mesh(standin, taxes.make_rules(dp=("data",), tp=("model",))):
        assert moe._n_groups(2 * 32) == 2
        y, aux = moe.apply_moe(cfg, tp, torch.from_numpy(x))
    y1, aux1 = moe.apply_moe(cfg, tp, torch.from_numpy(x))  # off a mesh: one group
    assert np.abs(y.numpy().reshape(G * Tg, -1) - jy).max() < 1e-5
    for k, v in jaux.items():
        assert abs(float(aux[k]) - float(v)) < 1e-6, k
    assert float(aux1["moe_drop_frac"]) != float(aux["moe_drop_frac"])  # the groups matter
