"""The dry run's collective term on the CPU: each cell's step run as a
sharded program (DTensors with ``meta`` local shards over a fake process
group of the mesh's size) and its collectives counted per chip by JAX's
kinds.

(a) a one-layer MLP under FSDP placements on a (2, 4) mesh emits
exactly a hand count of collectives, and each redistribution maps to its
JAX kind; the counter sees every collective ``CommDebugMode`` sees;
(b) a (1, 1) mesh emits none; (c) the port orders the layouts as JAX's
``tests/test_perf_layouts.py`` does; (d) reduced tinyllama train and
decode against JAX's ``parse_collectives`` of the same cells compiled
for 8 fake devices (one subprocess); (e) ``shard`` and the DTensor
helpers are no-ops on plain tensors; (f) the fake group is torn down
after a failing step and refuses to start beside another group; (g) the
sharded program computes the model's function: each family's train,
prefill and decode steps run as DTensors on a real one-rank gloo group
(CPU values) equal the plain steps.
"""
import contextlib
import json

import pytest
import torch

from repro_torch.analysis import roofline as roof
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCfg
from repro_torch.distributed import group, pspec, sharding
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.models import model_zoo
from repro_torch.train import train_step

SMALL = Mesh(("data", "model"), (2, 4))
ONE = Mesh(("data", "model"), (1, 1))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape):
    return torch.empty(shape, device="meta")


# ---------------------------------------------------------------------------
# (a) exact counts
# ---------------------------------------------------------------------------
def test_fsdp_mlp_issues_a_hand_count_of_collectives():
    """x (16, 32) f32 on "data"; w1 (32, 64) and w2 (64, 32) FSDP-sharded
    on "data" (their "embed" dim), replicated on "model".  Forward: each
    weight all-gathered whole, (32, 64) and (64, 32) f32 = 8,192 bytes
    each; the loss's partial sum over "data" all-reduced (one f32, 4
    bytes).  Backward: each weight's gradient, a partial sum over "data",
    reduce-scattered back onto its shard, (16, 64) and (64, 16) f32 =
    4,096 bytes each.  Nothing crosses "model"."""
    from torch.distributed.tensor.debug import CommDebugMode
    with group.fake_group((2, 4), ("data", "model")) as dm:
        ns = lambda *spec: sharding.NamedSharding(dm, spec)
        x = sharding.place_abstract(_meta(16, 32), ns("data", None))
        w1 = sharding.place_abstract(_meta(32, 64), ns("data", None))
        w2 = sharding.place_abstract(_meta(64, 32), ns(None, "data"))
        w1.requires_grad_()
        w2.requires_grad_()
        with CommDebugMode() as seen, roof.CollectiveCounter() as c:
            h = torch.relu(x @ L.gathered(w1, 0))
            loss = L.summed((h @ L.gathered(w2, 1)).sum())
            g1, g2 = torch.autograd.grad(loss, [w1, w2])
            g1 = L.placed(g1, w1.placements)
            g2 = L.placed(g2, w2.placements)
        assert g1.placements == w1.placements
        assert g2.placements == w2.placements
    st = c.stats()
    assert st.counts == {"all-reduce": 1, "all-gather": 2,
                         "reduce-scatter": 2, "all-to-all": 0,
                         "collective-permute": 0}
    assert st.bytes_by_kind == {"all-reduce": 4, "all-gather": 2 * 8192,
                                "reduce-scatter": 2 * 4096, "all-to-all": 0,
                                "collective-permute": 0}
    assert st.total_bytes == 24_580
    assert sorted(n for _, _, n in c.ops) == [4, 4096, 4096, 8192, 8192]
    assert seen.get_total_counts() == 5


@pytest.mark.parametrize("src,dst,kind,nbytes", [
    ("partial", "replicate", "all-reduce", 8 * 64 * 4),
    ("shard1", "replicate", "all-gather", 8 * 64 * 4),
    ("partial", "shard1", "reduce-scatter", 8 * 16 * 4),
    ("shard1", "shard0", "all-to-all", 2 * 64 * 4),
])
def test_each_redistribution_counts_as_its_jax_kind(src, dst, kind, nbytes):
    """One (8, 64) f32 tensor redistributed over the 4-way "model" axis:
    the result's bytes on one chip.  The all-to-all is one: the counting
    mesh is a ``cuda`` mesh, where DTensor emits NCCL's all-to-all (a
    ``cpu`` mesh would stand in an all-gather)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    pl = {"partial": Partial(), "replicate": Replicate(), "shard0": Shard(0),
          "shard1": Shard(1)}
    with group.fake_group((2, 4), ("data", "model")) as dm:
        local = (8, 16) if src == "shard1" else (8, 64)
        t = DTensor.from_local(torch.empty(local, device="meta"), dm,
                               [Replicate(), pl[src]], run_check=False,
                               shape=torch.Size((8, 64)), stride=(64, 1))
        with roof.CollectiveCounter() as c:
            t.redistribute(dm, [Replicate(), pl[dst]])
    assert c.counts[kind] == 1 and sum(c.counts.values()) == 1
    assert c.bytes_by_kind[kind] == nbytes


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_the_counter_sees_every_collective(kind):
    """Every collective ``CommDebugMode`` counts in a reduced step, the
    counter counts too (train: forward, backward, optimizer)."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = get_arch("tinyllama-1.1b").reduced()
    shape = ShapeCfg(kind, 64, 8, kind)
    with group.fake_group(SMALL.shape, SMALL.axis_names) as dm:
        try:
            cell = dr.build_cell(cfg, shape, SMALL, "base", dmesh=dm)
            model = cell.build()
            args = cell.inputs(model)
            with CommDebugMode() as seen, roof.CollectiveCounter() as c:
                cell.step(*args)
        finally:
            dr._restore_switches()
    assert sum(c.counts.values()) == seen.get_total_counts() > 0
    assert len(c.ops) == sum(c.counts.values())


def test_an_unknown_collective_raises():
    with group.fake_group((2, 1), ("data", "model")):
        from torch.distributed import _functional_collectives as funcol
        with roof.CollectiveCounter(), pytest.raises(
                NotImplementedError, match="broadcast"):
            funcol.broadcast(torch.empty(4, device="meta"), 0,
                             group=torch.distributed.group.WORLD)


# ---------------------------------------------------------------------------
# (b) a mesh of one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_a_mesh_of_one_issues_no_collective(kind):
    """Nothing is dispatched at all: the counter counts every collective
    op it sees, and ``CommDebugMode`` sees none either."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = get_arch("tinyllama-1.1b").reduced()
    T = 128 if kind == "decode" else 64
    shape = ShapeCfg(kind, T, 8, kind)
    stats, t = dr.trace_sharded(cfg, shape, ONE)
    assert stats.total_bytes == 0 and sum(stats.counts.values()) == 0
    assert t > 0
    with group.fake_group(ONE.shape, ONE.axis_names) as dm:
        try:
            cell = dr.build_cell(cfg, shape, ONE, "base", dmesh=dm)
            model = cell.build()
            args = cell.inputs(model)
            with CommDebugMode() as seen:
                cell.step(*args)
        finally:
            dr._restore_switches()
    assert seen.get_total_counts() == 0


# ---------------------------------------------------------------------------
# (c) the layouts in JAX's order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind,T", [("granite-3-2b", "train", 256),
                                         ("qwen2-moe-a2.7b", "decode", 1024)])
def test_opt_layouts_move_fewer_collective_bytes(arch, kind, T):
    """``tests/test_perf_layouts.py::test_opt_layouts_reduce_collectives``
    on the port's counts: FSDP-2D against TP+FSDP on a dense train cell,
    the einsum MoE decode dispatch against the scatter one."""
    cfg = get_arch(arch).reduced()
    shape = ShapeCfg(kind[0], T, 8, kind)
    got = {layout: dr.trace_sharded(cfg, shape, SMALL, layout)[0]
           for layout in ("base", "opt")}
    print(arch, kind, {k: v.total_bytes for k, v in got.items()})
    assert got["opt"].total_bytes < got["base"].total_bytes, got


# ---------------------------------------------------------------------------
# (d) against JAX
# ---------------------------------------------------------------------------
_JAX_CELLS = """
import json, re, jax
from jax.sharding import AxisType
import repro.launch.dryrun as dr
from repro.configs import get_arch
from repro.configs.base import ShapeCfg
from repro.analysis.roofline import parse_collectives

mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,)*2)
cfg = get_arch("tinyllama-1.1b").reduced()
out = {}
for kind, T in (("train", 64), ("decode", 128)):
    compiled, *_ = dr.lower_compile(cfg, ShapeCfg(kind[0], T, 8, kind),
                                    mesh, unroll=True)
    text = compiled.as_text()
    st = parse_collectives(text)
    cache = re.findall(r"= f32\\[4,128,2,16\\]\\S* all-gather\\(", text)
    out[kind] = {"counts": st.counts, "bytes": st.bytes_by_kind,
                 "cache_gathers": len(cache)}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    pytest.importorskip("jax")
    from tests.conftest import run_subprocess
    out = run_subprocess(_JAX_CELLS, devices=8, timeout=600)
    return json.loads(out.split("JSON", 1)[1])


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_collective_bytes_against_jax(kind, jax_cells):
    """The cells of ``test_mini_dryrun_on_8_devices`` (reduced tinyllama,
    train 64 x 8 and decode 128 x 8 on (2, 4)), each compiled unrolled as
    JAX's roofline compiles them, so that both sides count every layer.
    Total bytes per chip within 2x of JAX's, nothing subtracted from
    either side.  On decode the KV cache, whose head_dim the rules shard
    on "model", is all-gathered whole before the GQA repeat, as XLA
    does: four gathers of JAX's (4, 128, 2, 16) elements beside JAX's
    four ``cache_gathers`` (XLA:CPU moves the bf16 cache as f32, the
    port in bf16), and no all-to-all of the repeated cache.  This replaces a
    carve-out that took the cache's op out of both sides while the port
    moved the repeated cache by all-to-all after the repeat (four
    (4, 128, 1, 16) results), a different program from JAX's."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    T = 128 if kind == "decode" else 64
    with group.fake_group(SMALL.shape, SMALL.axis_names) as dm:
        try:
            cell = dr.build_cell(cfg, ShapeCfg(kind[0], T, 8, kind), SMALL,
                                 "base", dmesh=dm)
            model = cell.build()
            if kind != "train":
                cell.step(*cell.inputs(model))
            args = cell.inputs(model)
            with roof.CollectiveCounter() as c:
                cell.step(*args)
        finally:
            dr._restore_switches()
    port, ref = c.stats(), jax_cells[kind]
    port_total, jax_total = port.total_bytes, sum(ref["bytes"].values())
    msg = (f"{kind}: port counts {port.counts} bytes {port.bytes_by_kind} "
           f"(total {port_total}); JAX counts {ref['counts']} bytes "
           f"{ref['bytes']} (total {jax_total})")
    print(msg)
    if kind == "decode":
        assert ref["cache_gathers"] == 4, msg
        # each gather stacks the four (4, 128, 2, 4) shards of "model" on
        # dim 0, which DTensor then lays out as JAX's (4, 128, 2, 16)
        cache = [n for k, s, n in c.ops
                 if k == "all-gather" and s == (16, 128, 2, 4)]
        assert cache == [4 * 128 * 2 * 16 * 2] * 4, msg
        assert not [s for k, s, n in c.ops
                    if k == "all-to-all" and s == (4, 128, 1, 16)], msg
    assert jax_total / 2 <= port_total <= 2 * jax_total, msg


# ---------------------------------------------------------------------------
# (e) nothing changes on plain tensors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-236b", "rwkv6-1.6b",
                                  "zamba2-2.7b", "whisper-medium",
                                  "paligemma-3b"])
def test_sharding_hooks_change_nothing_on_plain_tensors(arch, monkeypatch):
    """Logits and gradients of a reduced model on the CPU are bit-equal
    with the sharding hooks and with each replaced by the identity
    (``einsum`` by ``torch.einsum``, ``per_shard`` by the call)."""
    cfg = get_arch(arch).reduced()
    zoo = model_zoo.get_model(cfg)
    defs = zoo.param_defs(cfg)
    batch = model_zoo.concrete_batch(cfg, ShapeCfg("t", 32, 2, "train"),
                                     device="cpu")

    def run():
        model = zoo.build(cfg, pspec.init_params(
            defs, torch.Generator("cpu").manual_seed(0), "cpu"))
        with torch.no_grad():
            lg = zoo.forward(cfg, model, batch, mode="train")[0]
        loss, grads = train_step.loss_and_grads(cfg, model, batch)
        return [lg, loss] + [g for _, g in pspec.tree_items(grads)]

    with_hooks = run()
    ident = lambda x, *a: x
    for name in ("shard", "replicated", "summed", "gathered", "placed"):
        monkeypatch.setattr(L, name, ident)
    monkeypatch.setattr(train_step, "placed", ident)
    monkeypatch.setattr(L, "per_shard",
                        lambda fn, inputs, *a, **k: fn(*inputs))
    monkeypatch.setattr(L, "einsum", torch.einsum)
    without = run()
    assert len(with_hooks) == len(without)
    assert all(torch.equal(a, b) for a, b in zip(with_hooks, without))


def test_shard_keeps_jax_filtering():
    """``keep``: an axis the mesh lacks is dropped, a dim that does not
    divide stays whole, a lone "model" drops under fsdp2d; the tuple of
    batch axes follows ``set_layout``."""
    from torch.distributed.tensor import Replicate, Shard
    with group.fake_group((2, 4), ("data", "model")) as dm:
        x = sharding.place_abstract(_meta(8, 6, 4), sharding.NamedSharding(
            dm, (None, None, None)))
        y = L.shard(x, L.BATCH_AXES, None, "model")
        assert y.placements == (Shard(0), Shard(2))
        assert L.shard(x, "pod", "model", None).placements == (
            Replicate(), Replicate())           # 6 does not divide 4
        try:
            L.set_layout("fsdp2d")
            assert L.BATCH_AXES == ("pod", "data", "model")
            z = L.shard(x, L.BATCH_AXES, None, "model")
            assert z.placements == (Shard(0), Shard(0))
        finally:
            L.set_layout("tp")
        assert L.BATCH_AXES == ("pod", "data")
    with pytest.raises(ValueError):
        L.set_layout("dp")
    plain = torch.zeros(3)
    assert L.shard(plain, "data") is plain
    assert L.replicated(plain, plain) is plain


# ---------------------------------------------------------------------------
# (f) clean failures
# ---------------------------------------------------------------------------
def test_the_group_is_torn_down_after_a_failing_step(monkeypatch):
    import torch.distributed as dist

    def boom(*a, **k):
        raise RuntimeError("no strategy for this op")

    monkeypatch.setattr(L, "rmsnorm", boom)
    cfg = get_arch("tinyllama-1.1b").reduced()
    shape = ShapeCfg("t", 64, 8, "train")
    with pytest.raises(RuntimeError, match="no strategy"):
        dr.trace_sharded(cfg, shape, SMALL, "opt")
    assert not dist.is_initialized()
    assert L.BATCH_AXES == ("pod", "data") and L._LAYOUT == "tp"
    entry, t = dr.collectives_entry(cfg, shape, SMALL, "base", "the cell")
    assert entry == {"error": "the cell: RuntimeError: no strategy for "
                              "this op"} and t is None
    assert not dist.is_initialized()


def test_a_second_group_is_refused():
    import torch.distributed as dist
    with group.fake_group((1, 1), ("data", "model")):
        with pytest.raises(RuntimeError, match="'fake', world size 1"):
            with group.fake_group((2, 4), ("data", "model")):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()


def test_a_record_carries_the_collective_term():
    """``run_cell`` on a reduced decode cell: the ``collectives`` entry,
    the term, three-term bottleneck, the line checked on the collective
    bytes too (the full depth is a sample here)."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    rec = dr.run_cell("tinyllama-1.1b", "decode_32k", False, cfg=cfg,
                      shape=ShapeCfg("d", 128, 8, "decode"), mesh=SMALL)
    json.dumps(rec)
    coll = rec["collectives"]
    assert set(coll) == {"counts", "bytes_by_kind"}
    assert sum(coll["bytes_by_kind"].values()) > 0
    r = rec["roofline"]
    assert r["collective_bytes_per_chip"] == sum(
        coll["bytes_by_kind"].values())
    assert r["t_collective_s"] == r["collective_bytes_per_chip"] / \
        roof.LINK_BW
    assert r["affine_rel_err"]["collective_bytes"] <= 1e-9
    terms = {"compute": r["t_compute_s"], "memory": r["t_memory_s"],
             "collective": r["t_collective_s"]}
    assert r["bottleneck"] == max(terms, key=terms.get)


# ---------------------------------------------------------------------------
# (g) the sharded program computes the model's function
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _one_rank_mesh(shape, names):
    """A real gloo group of one rank (this process) and a ``cpu`` mesh of
    ``shape`` (all ones) on it: DTensors hold the whole values, and
    every DTensor-only branch of the models runs on them."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_device_mesh(tuple(shape), tuple(names), device="cpu")
    finally:
        dist.destroy_process_group()


def _step_values(cfg, shape, layout, dmesh):
    """The cell's logits, loss, gradients and train step (train), or its
    logits, cache and step (prefill, decode), on seeded CPU values;
    DTensors as their full values, and how many leaves were DTensors."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    from repro_torch.train.optimizer import param_tree
    zoo = model_zoo.get_model(cfg)
    try:
        cell = dr.build_cell(cfg, shape, ONE, layout, device="cpu",
                             dmesh=dmesh)
        model = cell.build()
        if shape.kind == "train":
            state, batch, _ = cell.inputs(model)
            with torch.no_grad():
                lg = zoo.forward(cfg, model, batch, mode="train")[0]
            loss, grads = train_step.loss_and_grads(cfg, model, batch)
            metrics = cell.step(state, batch, None)[1]
            out = {"logits": lg, "loss": loss, "step_loss": metrics["loss"],
                   "grads": grads, "params": param_tree(model)}
        else:
            _, tokens, cache = cell.inputs(model)
            if shape.kind == "decode":
                tokens = {"tokens": tokens}
            with torch.no_grad():
                lg, cache, _ = zoo.forward(cfg, model, tokens,
                                           mode=shape.kind, cache=cache)
            out = {"logits": lg, "cache": cache,
                   "step": cell.step(*cell.inputs(model))}
    finally:
        dr._restore_switches()
    leaves = {k: [t for t in tree_flatten(v)[0]
                  if isinstance(t, torch.Tensor)] for k, v in out.items()}
    n_dt = sum(isinstance(t, DTensor) for v in leaves.values() for t in v)
    return {k: [t.full_tensor() if isinstance(t, DTensor) else t
                for t in v] for k, v in leaves.items()}, n_dt


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-236b", "rwkv6-1.6b",
                                  "zamba2-2.7b", "whisper-medium",
                                  "paligemma-3b"])
def test_the_sharded_step_computes_the_plain_step(arch, kind):
    """Reduced configs, both layouts, batch 2.  The forward (logits,
    loss, caches, next tokens) is bit-equal: MoE's one-hot dispatch and
    combine, ``layers.einsum``'s matrix and broadcast forms (products in
    f32, as the product they replace accumulates), ``per_shard``'s
    cores, ``write_positions``, MLA's and the loss's max-and-sum forms
    give the plain path's numbers.  So are the gradients and the
    parameters after one AdamW step, but for the MoE models (qwen2-moe,
    deepseek-v2, whose one-hot products and MLA softmax backward sum in
    another order), held within rtol 1e-5 / atol 1e-5."""
    cfg = get_arch(arch).reduced()
    shape = ShapeCfg(kind, 64 if kind == "decode" else 32, 2, kind)
    for layout in ("base", "opt"):
        plain, n_plain = _step_values(cfg, shape, layout, None)
        with _one_rank_mesh(*dr._fake_mesh(cfg, shape, ONE, layout)) as dm:
            sharded, n_dt = _step_values(cfg, shape, layout, dm)
        assert n_plain == 0 and n_dt > 0, (layout, n_dt)
        for key, want in plain.items():
            got = sharded[key]
            assert len(got) == len(want), (layout, key)
            for a, b in zip(got, want):
                if key in ("grads", "params") and cfg.moe is not None:
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
                else:
                    assert torch.equal(a, b), (layout, key)
