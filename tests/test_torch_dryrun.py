"""The port's dry run against the JAX package's, on the CPU: the memory
budget, the analytic HBM bytes, MODEL_FLOPS and the depth variants equal
JAX's for every supported cell on both production meshes under both
layouts (``fits`` recomputed at the H100's capacity); the counting mode
counts on ``meta`` what the same step counts on real CPU tensors (train,
prefill and decode, each family reduced); a reduced tinyllama train
step's FLOPs equal a hand count of its products; a third depth lies on
the affine line; ``run_cell`` on a reduced cell gives a complete record;
the report's three tables equal JAX's byte for byte.

JAX's functions read only ``mesh.axis_names`` and ``mesh.devices.shape``,
so a stand-in with a numpy ``devices`` array serves without 256 devices.
"""
import contextlib
import dataclasses
import io
import json
import sys
import types

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import jax  # noqa: E402

from repro.analysis import memory as jmemory  # noqa: E402
from repro.analysis import report as jreport  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import shape_supported  # noqa: E402
from repro.distributed import pspec as jpspec  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch.analysis import memory as tmemory  # noqa: E402
from repro_torch.analysis import report as treport  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402

ARCH_IDS = sorted(ARCHS)
FAMILIES = ["tinyllama-1.1b", "rwkv6-1.6b", "zamba2-2.7b", "qwen2-moe-a2.7b",
            "deepseek-v2-236b", "whisper-medium", "paligemma-3b"]
SMALL = Mesh(("data", "model"), (2, 4))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny CPU steps: threads cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(axis_names=names, devices=np.zeros(shape))


def _jax_layout(cfg, shape, layout):
    """JAX run_cell's (rules, param dtype) of a layout."""
    if layout == "opt":
        if shape.kind == "train" and cfg.moe is None:
            return jpspec.FSDP2D_RULES, None
        if shape.kind in ("prefill", "decode"):
            return jpspec.SERVE_RULES, jnp.bfloat16
    return None, None


@pytest.mark.parametrize("layout", ["base", "opt"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_budget_hbm_bytes_and_model_flops_equal_jax(arch_id, layout):
    jcfg, tcfg = JARCHS[arch_id], ARCHS[arch_id]
    jdefs = jzoo.get_model(jcfg).param_defs(jcfg)
    tdefs = tzoo.get_model(tcfg).param_defs(tcfg)
    n = 0
    for s in sorted(SHAPES):
        jshape, tshape = JSHAPES[s], SHAPES[s]
        if not shape_supported(jcfg, jshape)[0]:
            continue
        jrules, jdt = _jax_layout(jcfg, jshape, layout)
        trules, tdt, _ = dr._layout(tcfg, tshape, layout)
        for multi_pod in (False, True):
            jm = _jmesh(multi_pod)
            tm = make_production_mesh(multi_pod=multi_pod)
            sizes = dict(zip(jm.axis_names, jm.devices.shape))
            jc = jcs = tc = tcs = None
            if jshape.kind != "train":
                opt = layout == "opt"
                jc = jzoo.abstract_cache(jcfg, jshape)
                jcs = jax.tree.map(lambda x: jsharding.cache_spec(
                    jm, tuple(x.shape), jcfg, opt=opt), jc)
                tc = tzoo.abstract_cache(tcfg, tshape)
                tcs = dr.pspec_lib.map_structure(
                    lambda x: dr.sharding.cache_spec(
                        tm, tuple(x.shape), tcfg, opt=opt), tc)
            want = jmemory.budget(jcfg, jshape, sizes, jdefs, jc, jcs,
                                  train=jshape.kind == "train", rules=jrules,
                                  param_dtype=jdt).as_dict()
            got = tmemory.budget(tcfg, tshape, sizes, tdefs, tc, tcs,
                                 train=tshape.kind == "train", rules=trules,
                                 param_dtype=tdt).as_dict()
            assert got["fits"] == (got["total_bytes"]
                                   <= tmemory.HBM_PER_CHIP)
            del want["fits"], got["fits"]
            assert got == want, (s, multi_pod)
            cb = res = 0
            if jshape.kind == "decode":
                cb = jmemory._sharded_bytes(jc, jcs, sizes)
                assert tmemory._sharded_bytes(tc, tcs, sizes) == cb
                cb2, res2 = dr._resident_and_cache(tcfg, tshape, tm, layout)
                assert cb2 == cb
                res = jmemory._sharded_bytes(
                    jpspec.abstract_params(jdefs, dtype=jdt),
                    jpspec.resolve_specs(jdefs, sizes, jrules), sizes)
                assert res2 == res
            assert troof.analytic_hbm_bytes(
                tcfg, tshape, sizes, cb, res) == jroof.analytic_hbm_bytes(
                jcfg, jshape, sizes, cb, res), (s, multi_pod)
            n += 1
        assert troof.model_flops_for(tcfg, tshape) == jroof.model_flops_for(
            jcfg, jshape)
    assert n >= 4


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_depth_variants_equal_jax(arch_id):
    from repro.launch.dryrun import depth_variants as jdv
    (jv, jn), (tv, tn) = jdv(JARCHS[arch_id]), dr.depth_variants(
        ARCHS[arch_id])
    assert tn == jn
    assert [(n, c.n_layers, c.enc_layers) for c, n in tv] == [
        (n, c.n_layers, c.enc_layers) for c, n in jv]


def test_h100_constants_replace_the_tpu_ones():
    assert troof.PEAK_FLOPS == 989e12 and troof.HBM_BW == 3.35e12
    assert tmemory.HBM_PER_CHIP == 85_017_493_504
    assert not hasattr(troof, "ICI_BW") and troof.LINK_BW == 450e9
    t = troof.RooflineTerms(1e12, 1e9, 1e9, 256, 1e14, 0.0)
    assert t.t_collective == 1e9 / 450e9 and t.bottleneck == "collective"
    assert t.as_dict()["t_collective_s"] == t.t_collective
    assert t.roofline_fraction == (1e14 / 256 / 989e12) / t.t_collective
    # a cell whose sharded trace failed keeps the two other terms
    t = troof.RooflineTerms(1e12, 1e9, None, 256, 1e14, 0.0)
    assert t.t_collective is None and t.bottleneck == "compute"
    assert t.as_dict()["t_collective_s"] is None


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch_id", FAMILIES)
def test_meta_counts_equal_real_tensor_counts(arch_id, kind):
    cfg = get_arch(arch_id).reduced()
    shape = ShapeCfg(kind, 64, 4, kind)
    meta = dr.trace_cell(cfg, shape, SMALL)[0]
    real = dr.trace_cell(cfg, shape, SMALL, device="cpu")[0]
    keys = ("flops", "bytes", "ops")
    assert {k: meta[k] for k in keys} == {k: real[k] for k in keys}
    assert meta["flops"] > 0 and meta["ops"] > 0


@pytest.mark.parametrize("remat", [False, True], ids=["off", "on"])
def test_train_flops_equal_a_hand_count_of_the_products(remat):
    """Forward and backward: three a product.  With remat the backward
    recomputes each layer's forward but for the two products whose
    outputs JAX's policy saves (``attn_out`` = ... @ wo, ``mlp_out`` =
    ... @ wd): the checkpoint stops once it has what the backward reads."""
    from repro_torch.models import transformer
    cfg = get_arch("tinyllama-1.1b").reduced()
    B, T = 8, 64
    N = B * T
    D, H, Hkv, Dh, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.vocab)
    wo, down = 2 * N * H * Dh * D, 2 * N * F * D
    per_layer = (2 * N * D * H * Dh            # wq
                 + 2 * 2 * N * D * Hkv * Dh    # wk, wv
                 + wo
                 + 2 * 2 * N * D * F           # gate, up
                 + down
                 + 2 * 2 * B * H * T * T * Dh)  # scores and p @ v
    forward = cfg.n_layers * per_layer + 2 * N * D * V     # + logits
    transformer.set_remat(remat)
    try:
        counts = dr.trace_cell(cfg, ShapeCfg("t", T, B, "train"), SMALL)[0]
    finally:
        transformer.set_remat(True)
    if remat:
        recomputed = cfg.n_layers * (per_layer - wo - down)
        assert counts["flops"] == 3 * forward + recomputed
        assert 394_264_576 == 3 * forward + recomputed
    else:
        assert counts["flops"] == 3 * forward
        assert 327_155_712 == 3 * forward


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_third_depth_lies_on_the_affine_line(kind):
    """FLOPs and ops are affine in depth for every step.  Bytes too for
    serving; a train step's bytes curve up: the gradient of each layer's
    slice of a stacked parameter is a whole-stack ``select_backward``
    buffer, summed into the stack's gradient, so those bytes grow as the
    square of the depth (a finding about the eager trainer)."""
    base = get_arch("tinyllama-1.1b").reduced()
    shape = ShapeCfg(kind, 64, 4, kind)
    c = {n: dr.trace_cell(dataclasses.replace(base, n_layers=n), shape,
                          SMALL)[0] for n in (2, 4, 6)}
    line = lambda k: troof.affine_extrapolate(c[2][k], c[4][k], 2, 4, 6)
    assert line("flops") == c[6]["flops"] and line("ops") == c[6]["ops"]
    if kind == "train":
        assert c[6]["bytes"] > line("bytes")
    else:
        assert line("bytes") == c[6]["bytes"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_run_cell_gives_a_complete_record(kind):
    """The counterpart of test_mini_dryrun_on_8_devices: a reduced config
    on a (2, 4) mesh, train and decode."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    shape = ShapeCfg(kind, 128 if kind == "decode" else 64, 8, kind)
    rec = dr.run_cell("tinyllama-1.1b", "train_4k", False, cfg=cfg,
                      shape=shape, mesh=SMALL)
    json.dumps(rec)
    assert rec["status"] == "ok" and rec["t_trace_s"] > 0
    ma = rec["memory_analysis"]
    assert ma["argument_bytes"] > 0 and ma["output_bytes"] > 0
    assert ma["temp_bytes"] is None
    assert rec["counts"]["flops"] > 0 and rec["analytic_memory"]["fits"]
    r = rec["roofline"]
    assert r["affine_exact"]          # the full depth is a sample here
    assert r["flops_per_chip"] == r["full_depth"]["flops"] / 8
    coll = sum(rec["collectives"]["bytes_by_kind"].values())
    assert coll > 0 and r["collective_bytes_per_chip"] == coll
    assert r["full_depth"]["collective_bytes"] == coll
    assert r["t_collective_s"] == coll / troof.LINK_BW
    assert r["bottleneck"] in ("compute", "memory", "collective")
    skipped = dr.run_cell("tinyllama-1.1b", "long_500k", False)
    assert skipped["status"] == "skipped"


def test_switches_are_restored_after_a_cell():
    from repro_torch.models import layers as L
    from repro_torch.models import moe, transformer
    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    dr.trace_cell(cfg, ShapeCfg("d", 64, 4, "decode"), SMALL, "base")
    assert L._BLOCKWISE_MIN == 2048 and L._WINDOW_SLICE
    assert moe._EINSUM_DECODE
    # the FSDP-2D train cell runs without remat, as in JAX, and turns it
    # back on after: its count is the base layout's with remat off
    dense = get_arch("tinyllama-1.1b").reduced()
    train = ShapeCfg("t", 64, 8, "train")
    opt = dr.trace_cell(dense, train, SMALL, "opt")[0]
    assert transformer._USE_REMAT
    transformer.set_remat(False)
    try:
        plain = dr.trace_cell(dense, train, SMALL, "base")[0]
    finally:
        transformer.set_remat(True)
    assert opt["flops"] == plain["flops"] == 327_155_712


def _records():
    """JAX-shaped records over the report's orders: ok, skipped, a
    multi-pod cell, opt cells and a collective-bound one."""
    recs = {}
    rng = np.random.default_rng(0)

    def roofline():
        t = rng.uniform(0.001, 2.0, size=4)
        return {"t_compute_s": t[0], "t_memory_s": t[1],
                "t_memory_hlo_s": t[2], "t_collective_s": t[3],
                "bottleneck": ["compute", "memory", "collective"][
                    int(np.argmax(t[[0, 1, 3]]))],
                "useful_flops_fraction": rng.uniform(0.1, 1.0),
                "roofline_fraction": rng.uniform(0.01, 0.9)}

    for a in ("tinyllama-1.1b", "rwkv6-1.6b", "deepseek-v2-236b"):
        for s in ("train_4k", "decode_32k", "long_500k", "prefill_32k"):
            for mesh in ("16x16", "2x16x16", "16x16_opt"):
                if s == "long_500k" and a != "rwkv6-1.6b":
                    recs[(a, s, mesh)] = {
                        "arch": a, "shape": s, "mesh": mesh,
                        "status": "skipped",
                        "reason": "pure full-attention architecture: 500k"
                                  "-token decode requires sub-quadratic"}
                    continue
                rec = {"arch": a, "shape": s, "mesh": mesh, "status": "ok",
                       "t_compile_s": float(rng.uniform(1, 90)),
                       "analytic_memory": {
                           "total_gb": float(rng.uniform(1, 40)),
                           "fits": bool(rng.integers(2))},
                       "collectives": {"counts": {
                           "all-reduce": int(rng.integers(3)),
                           "all-gather": int(rng.integers(3)),
                           "reduce-scatter": 0, "all-to-all": 1,
                           "collective-permute": int(rng.integers(2))}}}
                if mesh != "2x16x16":
                    rec["roofline"] = roofline()
                recs[(a, s, mesh)] = rec
    return recs


def _port_records():
    """The port's shape of record: ``t_trace_s``, the collectives of its
    sharded trace and their term, a cell whose sharded trace failed
    (``collectives: {"error": ...}``, a ``None`` term) and an error
    cell."""
    recs = {}
    for mesh in ("16x16", "16x16_opt"):
        ok = mesh == "16x16"
        recs[("tinyllama-1.1b", "train_4k", mesh)] = {
            "arch": "tinyllama-1.1b", "shape": "train_4k", "mesh": mesh,
            "status": "ok", "t_trace_s": 2.7,
            "analytic_memory": {"total_gb": 19.95, "fits": True},
            "collectives": ({"counts": {
                "all-reduce": 98, "all-gather": 733, "reduce-scatter": 187,
                "all-to-all": 48, "collective-permute": 0}} if ok
                else {"error": "tinyllama-1.1b x train_4k x 16x16_opt: "
                               "NotImplementedError: aten.foo"}),
            "roofline": {"t_compute_s": 0.0349, "t_memory_s": 0.0125,
                         "t_memory_hlo_s": 0.3433,
                         "t_collective_s": 1.1283 if ok else None,
                         "bottleneck": "collective" if ok else "compute",
                         "useful_flops_fraction": 0.784,
                         "roofline_fraction": 0.0243 if ok else 0.80}}
    recs[("rwkv6-1.6b", "train_4k", "16x16")] = {
        "arch": "rwkv6-1.6b", "shape": "train_4k", "mesh": "16x16",
        "status": "error", "error": "RuntimeError: a host read on meta"}
    return recs


def _port_opt_records():
    """Port records in the cells JAX's tables read whole (the opt layout
    and the multi-pod mesh; the 16x16 row reads ``t_compile_s``, where a
    port record has ``t_trace_s``): the collectives of the sharded trace
    and a roofline from the port's own ``RooflineTerms``, one cell
    collective-bound and one compute-bound."""
    recs = {}
    for (a, s, coll, chips) in (("tinyllama-1.1b", "train_4k", 2e10, 256),
                                ("deepseek-v2-236b", "decode_32k", 1e3,
                                 256)):
        terms = troof.RooflineTerms(
            flops_per_chip=3.1e13, hbm_bytes_per_chip=4.2e10,
            collective_bytes_per_chip=coll, chips=chips,
            model_flops=6.4e15, hbm_bytes_model=1.1e10)
        counts = {"all-reduce": 98, "all-gather": 733, "reduce-scatter": 187,
                  "all-to-all": 48, "collective-permute": 0}
        for mesh in ("16x16_opt", "2x16x16"):
            rec = {"arch": a, "shape": s, "mesh": mesh, "layout": "opt",
                   "status": "ok", "t_trace_s": 2.7,
                   "t_sharded_trace_s": 4.1,
                   "analytic_memory": {"total_gb": 19.95, "fits": True},
                   "collectives": {"counts": counts, "bytes_by_kind": {
                       k: int(coll) // 4 if v else 0
                       for k, v in counts.items()}}}
            if mesh == "16x16_opt":
                rec["roofline"] = {**terms.as_dict(), "samples": [],
                                   "n_full": 22, "affine_exact": True}
            recs[(a, s, mesh)] = rec
    return recs


def test_report_tables_equal_jax_byte_for_byte(tmp_path):
    recs = _records()
    recs.update(_port_opt_records())
    assert treport.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert treport.roofline_table(recs) == jreport.roofline_table(recs)
    assert treport.roofline_table(recs, "16x16_opt") == \
        jreport.roofline_table(recs, "16x16_opt")
    assert treport.opt_compare_table(recs) == jreport.opt_compare_table(recs)
    for (a, s, m), rec in recs.items():
        with open(tmp_path / f"{a}__{s}__{m}.json", "w") as f:
            json.dump(rec, f)
    assert treport.load(str(tmp_path)) == jreport.load(str(tmp_path))
    outs = []
    for mod in (treport, jreport):
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = ["report", "--dir", str(tmp_path)]
        try:
            with contextlib.redirect_stdout(buf):
                mod.main()
        finally:
            sys.argv = argv
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    # the port records are in the tables, one of them collective-bound
    rows = {tuple(ln.split(" | ")[:2]): ln for ln in
            treport.roofline_table(recs, "16x16_opt").splitlines()}
    assert "| collective | " in rows[("| tinyllama-1.1b", "train_4k")]
    assert "| compute | " in rows[("| deepseek-v2-236b", "decode_32k")]


def test_report_prints_a_missing_term_as_a_dash():
    recs = _port_records()
    dry = treport.dryrun_table(recs).splitlines()
    assert ("| tinyllama-1.1b | train_4k | ok | ? | 3 | 19.9 (y) | "
            "redu:98 gath:733 scat:187 all:48 |") in dry
    assert any(ln.startswith("| rwkv6-1.6b | train_4k | error |")
               for ln in dry)
    roof = treport.roofline_table(recs).splitlines()
    assert ("| tinyllama-1.1b | train_4k | 0.0349 | 0.0125 | 0.343 | 1.1283 "
            "| collective | 0.784 | 0.0243 | FSDP-2D layout (kills TP "
            "activation ARs) |") == roof[2]
    opt = treport.roofline_table(recs, "16x16_opt").splitlines()
    assert ("| tinyllama-1.1b | train_4k | 0.0349 | 0.0125 | 0.343 | — | "
            "compute | 0.784 | 0.8000 |") in opt[2]
    cmp_ = treport.opt_compare_table(recs).splitlines()
    assert "| tinyllama-1.1b x train_4k | step-time bound | 1.1283s | " \
           "0.0349s | 32.3x |" in cmp_
    recs[("tinyllama-1.1b", "train_4k", "16x16")]["collectives"] = {
        "error": "tinyllama-1.1b x train_4k x 16x16: NotImplementedError"}
    dry = treport.dryrun_table(recs).splitlines()
    assert "| tinyllama-1.1b | train_4k | ok | ? | 3 | 19.9 (y) | " \
           "sharded trace error |" in dry
