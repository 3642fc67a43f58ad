"""The port's sharding rules against the JAX package, on the CPU, with no
process and no device: ``resolve_specs`` for every architecture's full
config under each rule set on the 16x16 and 2x16x16 meshes, the
divisibility fallback, ``abstract_params`` (with the bf16 override),
``input_specs`` and ``abstract_cache`` for every supported (arch x
shape), ``batch_spec`` and ``cache_spec`` on every leaf of those batches
and caches on (2, 4), (16, 16) and (2, 16, 16) meshes under both layouts,
and the DTensor placements of ``NamedSharding``.  All equal, leaf for
leaf, as tuples.

JAX's sharding functions read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a small stand-in with a numpy ``devices``
array serves on the JAX side without 256 devices.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import shape_supported  # noqa: E402
from repro.distributed import pspec as jpspec  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.distributed import pspec as tpspec  # noqa: E402
from repro_torch.distributed import sharding as tsharding  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh, make_production_mesh, mesh_shape_dict,
)
from repro_torch.models import model_zoo as tzoo  # noqa: E402

ARCH_IDS = sorted(ARCHS)
MESHES = {"2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
RULES = {"default": (None, None), "fsdp2d": ("FSDP2D_RULES", "FSDP2D_RULES"),
         "serve": ("SERVE_RULES", "SERVE_RULES")}


def _jmesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.zeros(shape))


def _tmesh(name):
    return Mesh(*MESHES[name])


def _jspec_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _leaves(tree) -> list:
    """The leaves ``pspec.map_structure`` visits, in its order."""
    out: list = []
    tpspec.map_structure(out.append, tree)
    return out


def _dt(d) -> str:
    return str(d).replace("torch.", "")


def _jabs(tree):
    """(shape, dtype name) of each leaf of a JAX abstract tree."""
    return [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree.leaves(tree)]


def _tabs(tree):
    return [(tuple(x.shape), _dt(x.dtype))
            for x in _leaves(tree)]


def _cells():
    return [(a, s) for a in ARCH_IDS for s in sorted(SHAPES)
            if shape_supported(JARCHS[a], JSHAPES[s])[0]]


def test_production_meshes_and_shape_dicts():
    assert make_production_mesh() == Mesh(("data", "model"), (16, 16))
    mp = make_production_mesh(multi_pod=True)
    assert mesh_shape_dict(mp) == {"pod": 2, "data": 16, "model": 16}
    assert mp.size == 512
    with pytest.raises(ValueError):
        Mesh(("data",), (2, 2))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_resolve_specs_equal_jax_for_every_rule_set_and_mesh(arch_id):
    jdefs = jzoo.get_model(JARCHS[arch_id]).param_defs(JARCHS[arch_id])
    tdefs = tzoo.get_model(ARCHS[arch_id]).param_defs(ARCHS[arch_id])
    for mesh in ("16x16", "2x16x16"):
        sizes = dict(zip(*MESHES[mesh]))
        for jr, tr in RULES.values():
            jrules = getattr(jpspec, jr) if jr else None
            trules = getattr(tpspec, tr) if tr else None
            want = _jspec_leaves(jpspec.resolve_specs(jdefs, sizes, jrules))
            got = tpspec.tree_leaves(tpspec.resolve_specs(tdefs, sizes,
                                                          trules))
            assert got == want, (arch_id, mesh, jr)


def test_divisibility_fallback_as_jax():
    sizes = {"data": 16, "model": 16}
    for shape, logical in (((4, 64), ("kv", "head_dim")),
                           ((64, 128), ("heads", "mlp")),
                           ((48, 32), ("embed", "vocab")),
                           ((256, 7), ("embed", "mlp"))):
        jd = jpspec.ParamDef(shape, logical)
        td = tpspec.ParamDef(shape, logical)
        for jr, tr in RULES.values():
            jrules = getattr(jpspec, jr) if jr else None
            trules = getattr(tpspec, tr) if tr else None
            assert tpspec.resolve_spec(td, sizes, trules) == tuple(
                jpspec.resolve_spec(jd, sizes, jrules)), (shape, jr)
    assert tpspec.resolve_spec(tpspec.ParamDef((4, 64), ("kv", "head_dim")),
                               sizes) == (None, None)
    assert tpspec._axis_size(sizes, ("data", "model")) == 256
    assert tpspec._axis_size(sizes, None) == 1


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_abstract_params_equal_jax_shape_dtype_structs(arch_id):
    jdefs = jzoo.get_model(JARCHS[arch_id]).param_defs(JARCHS[arch_id])
    tdefs = tzoo.get_model(ARCHS[arch_id]).param_defs(ARCHS[arch_id])
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = _jabs(jpspec.abstract_params(jdefs, dtype=jdt))
        got = tpspec.abstract_params(tdefs, dtype=tdt)
        assert _tabs(got) == want
        assert all(t.device.type == "meta"
                   for t in tpspec.tree_leaves(got))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_input_specs_and_abstract_cache_equal_jax(arch_id):
    n = 0
    for a, s in _cells():
        if a != arch_id:
            continue
        jcfg, tcfg = JARCHS[a], ARCHS[a]
        assert _tabs(tzoo.input_specs(tcfg, SHAPES[s])) == _jabs(
            jzoo.input_specs(jcfg, JSHAPES[s])), s
        if SHAPES[s].kind != "train":
            got = tzoo.abstract_cache(tcfg, SHAPES[s])
            assert _tabs(got) == _jabs(jzoo.abstract_cache(jcfg,
                                                           JSHAPES[s])), s
            assert all(t.device.type == "meta"
                       for t in _leaves(got))
        n += 1
    assert n >= 2


def test_abstract_helpers_only_reach_meta_inside_them():
    from repro_torch.device import resolve_device
    with pytest.raises(ValueError):
        resolve_device("meta")
    cfg = ARCHS["tinyllama-1.1b"]
    with pytest.raises(ValueError):
        tzoo.get_model(cfg).init_cache(cfg, 1, 8, device="meta")
    host = tzoo.host_lengths(tzoo.abstract_cache(cfg, SHAPES["decode_32k"]),
                             5)
    assert host["layers"]["len"] == 5


def test_concrete_batch_equals_jax():
    for a, s in (("tinyllama-1.1b", "train_4k"), ("whisper-medium",
                                                   "prefill_32k"),
                 ("paligemma-3b", "prefill_32k")):
        tshape = dataclasses.replace(SHAPES[s], global_batch=2, seq_len=320)
        jshape = dataclasses.replace(JSHAPES[s], global_batch=2, seq_len=320)
        want = jzoo.concrete_batch(JARCHS[a], jshape, seed=3)
        got = tzoo.concrete_batch(ARCHS[a], tshape, seed=3, device="cpu")
        assert sorted(want) == sorted(got)
        for k in want:
            w = np.array(want[k].astype(jnp.float32))
            assert torch.equal(got[k].float(), torch.from_numpy(w)), (a, k)


@pytest.mark.parametrize("layout", ["tp", "fsdp2d"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_batch_and_cache_specs_equal_jax(arch_id, layout):
    JL.set_layout(layout)
    try:
        n = 0
        for a, s in _cells():
            if a != arch_id:
                continue
            jcfg, tcfg = JARCHS[a], ARCHS[a]
            batch = jax.tree.leaves(jzoo.input_specs(jcfg, JSHAPES[s]))
            cache = (jax.tree.leaves(jzoo.abstract_cache(jcfg, JSHAPES[s]))
                     if JSHAPES[s].kind != "train" else [])
            for mesh in MESHES:
                jm, tm = _jmesh(mesh), _tmesh(mesh)
                for x in batch:
                    sh = tuple(x.shape)
                    assert tsharding.batch_spec(tm, sh, layout) == tuple(
                        jsharding.batch_spec(jm, sh)), (s, mesh, sh)
                    n += 1
                for x in cache:
                    sh = tuple(x.shape)
                    for opt in (False, True):
                        assert tsharding.cache_spec(
                            tm, sh, tcfg, opt, layout) == tuple(
                            jsharding.cache_spec(jm, sh, jcfg, opt)), (
                            s, mesh, sh, opt)
                        n += 1
        assert n > 0
    finally:
        JL.set_layout("tp")


def test_batch_spec_rules_as_jax_test():
    """The cases of tests/test_distributed.py::test_batch_spec_rules."""
    mesh = Mesh(("data", "model"), (2, 4))
    cfg = ARCHS["tinyllama-1.1b"]
    assert tsharding.batch_spec(mesh, (8, 128))[0] == "data"
    assert tsharding.batch_spec(mesh, (1, 65536))[1] == "data"
    assert tsharding.cache_spec(mesh, (22, 8, 8192, 4, 64), cfg)[1] == "data"
    assert tsharding.batch_axes(mesh) == ("data",)
    assert tsharding.batch_axes(mesh, "fsdp2d") == ("data", "model")


def test_tree_shardings_follow_the_tree():
    mesh = make_production_mesh()
    cfg = ARCHS["zamba2-2.7b"]
    cache = tzoo.abstract_cache(cfg, SHAPES["decode_32k"])
    sh = tsharding.cache_shardings(cfg, mesh, cache)
    got = [s.spec for s in _leaves(sh)]
    want = [tsharding.cache_spec(mesh, tuple(x.shape), cfg)
            for x in _leaves(cache)]
    assert got == want and all(s.mesh is mesh
                               for s in _leaves(sh))
    st = tsharding.train_state_shardings(ARCHS["tinyllama-1.1b"], mesh)
    assert st.step.spec == () and st.mu is st.params


def test_named_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard
    m2 = Mesh(("data", "model"), (2, 2))
    ns = tsharding.NamedSharding
    assert ns(m2, (("data", "model"), None)).placements() == (Shard(0),
                                                              Shard(0))
    assert ns(m2, ("model", "data")).placements() == (Shard(1), Shard(0))
    assert ns(m2, (None, "model")).placements() == (Replicate(), Shard(1))
    assert ns(m2, ()).placements() == (Replicate(), Replicate())
    m3 = make_production_mesh(multi_pod=True)
    assert ns(m3, (("pod", "data", "model"),)).placements() == (
        Shard(0), Shard(0), Shard(0))
    assert ns(m3, (("pod", "data"), "model")).placements() == (
        Shard(0), Shard(0), Shard(1))


@pytest.mark.parametrize("spec", [(("model", "data"),),
                                  (("pod", "model", "data"), None),
                                  ("stage",), ("data", "data")])
def test_named_sharding_refuses_what_jax_would_split_otherwise(spec):
    with pytest.raises(ValueError):
        tsharding.NamedSharding(make_production_mesh(multi_pod=True),
                                spec).placements()
