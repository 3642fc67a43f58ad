"""The port as a package: its import boundary, its device rule, and its
CUDA kernels against their plain versions.

Tests marked ``gpu`` need the card; each decides inside its fixture
whether one is present and skips with a reason otherwise.  Run them on
the card with ``python -m pytest -m gpu tests/test_torch_*.py``.  This
file imports neither ``jax`` nor ``repro``, so it also runs where the
JAX package is not installed.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import features as F
from repro_torch.core.inference import Engine, EngineOptions
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.device import resolve_device
from repro_torch.flows.synthetic import make_dataset
from repro_torch.flows.windows import window_features, window_packets
from repro_torch.kernels import dispatch, dt_traverse, feature_window, ref
from repro_torch.kernels.ops import cuda_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def _run(code: str, env_extra: dict | None = None) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_importing_the_port_loads_neither_jax_nor_repro():
    out = _run(
        "import sys, repro_torch, repro_torch.convert, "
        "repro_torch.core.inference, repro_torch.flows.windows, "
        "repro_torch.kernels.ops, repro_torch.kernels.tick_step, "
        "repro_torch.obs, repro_torch.serve\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    assert out.strip() == "[]"


def test_import_and_cpu_path_never_call_nvcc():
    """Importing every module and running the CPU engine and a CPU
    flow-table server (both tick engines) starts no process (no
    ``nvcc``) and loads no kernel library."""
    out = _run(
        "import subprocess\n"
        "def boom(*a, **k): raise AssertionError('process started')\n"
        "subprocess.Popen = subprocess.run = boom\n"
        "import numpy as np\n"
        "from repro_torch.kernels import _build, ops, dispatch\n"
        "from repro_torch.core.partition import train_partitioned_dt\n"
        "from repro_torch.core.inference import Engine\n"
        "from repro_torch.flows.synthetic import make_dataset, "
        "make_packet_stream\n"
        "from repro_torch.flows.windows import window_features, "
        "window_packets\n"
        "from repro_torch.serve import FlowTableServer\n"
        "ds = make_dataset('d2', 120, seed=1)\n"
        "X = window_features(ds, 2, device='cpu')\n"
        "pdt = train_partitioned_dt(X, ds.labels, partition_sizes=[2, 2], "
        "k=3)\n"
        "eng = Engine.from_model(pdt, device='cpu')\n"
        "r = eng.run(window_packets(ds, 2))\n"
        "assert r.labels.shape == (120,)\n"
        "for te in ('fused', 'legacy'):\n"
        "    srv = FlowTableServer(eng, n_buckets=4, bucket_size=4, "
        "tick_engine=te)\n"
        "    n = sum(srv.ingest(b).n_flows for b in "
        "make_packet_stream(ds, seed=2).ticks(500))\n"
        "    assert n + srv.flush().n_flows == 120\n"
        "print(len(_build._LIBS))\n")
    assert out.strip() == "0"


def test_build_dir_hashes_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared ``csrc/*.cuh`` header changes the build key,
    so every kernel that includes it is rebuilt; the sources and flags
    are keyed as before."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers and "packet_fields.cuh" in [h.name for h in headers]
    base = _build.build_dir()
    assert base == _build.build_dir()              # deterministic
    header = csrc / "packet_fields.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    edited = _build.build_dir()
    assert edited != base and edited.parent == base.parent
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.build_dir() != edited            # a new header counts
    src = csrc / "feature_update.cu"
    before = _build.build_dir()
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build.build_dir() != before


@pytest.fixture(scope="module")
def tiny_model():
    """A two-partition model on 60 flows, trained on the CPU path."""
    ds = make_dataset("d2", 60, seed=1)
    X = window_features(ds, 2, device="cpu")
    pdt = train_partitioned_dt(X, ds.labels, partition_sizes=[1, 1], k=2)
    return ds, X, pdt


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_card_raises(no_card, tiny_model):
    ds, _, pdt = tiny_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        window_features(ds, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine.from_model(pdt)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cuda_impl_on_cpu_engine_raises(tiny_model):
    ds, X, pdt = tiny_model
    eng = Engine.from_model(pdt, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        eng.run(window_packets(ds, 2), options=EngineOptions(impl="cuda"))
    with pytest.raises(ValueError, match="unknown impl"):
        EngineOptions(impl="pallas")
    with pytest.raises(ValueError, match="block_b"):
        EngineOptions(block_b=0)
    with pytest.raises(ValueError, match="fewer windows"):
        eng.run(window_packets(ds, 1))
    with pytest.raises(ValueError, match="not ported"):
        train_partitioned_dt(X, ds.labels, partition_sizes=[1, 1], k=2,
                             trainer="jax")


def test_kernel_wrappers_refuse_cpu_tensors(tiny_model):
    ds, _, pdt = tiny_model
    pk = torch.from_numpy(window_packets(ds, 2))
    sid = torch.zeros(ds.n_flows, dtype=torch.int32)
    dev = Engine.from_model(pdt, device="cpu").tables.dev
    rows = [t[sid.long()] for t in dev[:4]]
    with pytest.raises(ValueError, match="CUDA"):
        feature_window.feature_window_kernel(pk[:, 0], *rows)
    d = dispatch.sid_dispatch(sid, n_subtrees=dev.thresholds.shape[0],
                              block_b=8)
    regs = torch.zeros(d.block_sid.shape[0] * 8, dev.slot_op.shape[1])
    with pytest.raises(ValueError, match="CUDA"):
        dt_traverse.dt_traverse_kernel(d.block_sid, regs, *dev[4:],
                                       block_b=8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_step(8)(pk[:, 0], sid, dev)
    acc, seen = ref.feature_state_init(rows[0])
    pkt = pk[:, 0, 0].contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        feature_window.feature_update_kernel(pkt, *rows[:3], acc, seen)
    with pytest.raises(ValueError, match="CUDA"):
        feature_window.feature_update_finalize_kernel(pkt, *rows, acc, seen)
    assert feature_window.launches == 0 and dt_traverse.launches == 0
    assert feature_window.update_launches == 0
    assert feature_window.update_finalize_launches == 0


def test_spans_nest_and_accumulate(monkeypatch):
    """``obs.span`` aggregates calls and host seconds per nesting path
    (what ``chip_smoke.py`` reports per tick phase); ``SPLIDT_OBS=0``
    makes it a shared no-op."""
    from repro_torch.obs import reset_spans, span, span_totals, trace
    monkeypatch.setattr(trace, "_ENABLED", True)
    reset_spans()
    for _ in range(3):
        with span("tick/dispatch"):
            with span("tick/fetch"):
                pass
    with span("tick/admit"):
        pass
    t = span_totals()
    assert list(t) == ["tick/admit", "tick/dispatch",
                       "tick/dispatch > tick/fetch"]
    assert t["tick/dispatch"]["calls"] == 3
    assert t["tick/dispatch > tick/fetch"]["calls"] == 3
    assert t["tick/dispatch"]["s"] >= t["tick/dispatch > tick/fetch"]["s"]
    reset_spans()
    assert span_totals() == {}
    monkeypatch.setattr(trace, "_ENABLED", False)
    assert span("a") is span("b")
    with span("a"):
        pass
    assert span_totals() == {}


def test_metric_registry():
    from repro_torch.obs import MetricRegistry, exp_edges
    reg = MetricRegistry()
    c = reg.counter("serve_packets_total", "packets")
    c.inc(3)
    assert reg.counter("serve_packets_total") is c and c.value == 3
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)
    reg.gauge("serve_recirc_overhead", "ratio").set(0.25)
    h = reg.histogram("ttd", "s", edges=[0.001, 0.01, 0.1, 1.0])
    h.record_many([0.0005, 0.05, 0.05, 2.0])
    h.record_many([])
    assert [int(x) for x in h.counts] == [1, 0, 2, 0, 1] and h.total == 4
    assert reg.histogram("ttd") is h
    with pytest.raises(ValueError, match="must pass edges"):
        reg.histogram("other")
    with pytest.raises(ValueError, match="ascending"):
        reg.histogram("bad", edges=[1.0, 1.0])
    snap = reg.snapshot()
    assert snap["counters"] == {"serve_packets_total": {"value": 3,
                                                        "help": "packets"}}
    assert snap["gauges"]["serve_recirc_overhead"]["value"] == 0.25
    assert snap["histograms"]["ttd"]["counts"] == [1, 0, 2, 0, 1]
    assert snap["histograms"]["ttd"]["sum"] == 2.1005
    e = exp_edges(1e-3, 1e1, 5)
    np.testing.assert_allclose(e, [1e-3, 1e-2, 1e-1, 1.0, 1e1])
    with pytest.raises(ValueError):
        exp_edges(1.0, 1.0, 3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
MAIN_B = 1 << 20          # the engine batch of chip_smoke.py
MAIN_W = 65               # d2 windows at P = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_window_inputs(device, B: int, W: int, k: int, P: int = 3):
    """Packets (B, P, W, F) with every op/predicate code and empty
    windows, made on the card from a seed; returns the hop-1 view."""
    g = torch.Generator(device=device).manual_seed(B + W + k)
    u = lambda *s: torch.rand(*s, generator=g, device=device)
    pk = torch.zeros(B, P, W, F.PKT_NFIELDS, device=device)
    pk[..., F.PKT_TS] = u(B, P, W).cumsum(-1)
    pk[..., F.PKT_SIZE] = torch.floor(40 + 1460 * u(B, P, W))
    # +-1e8 among the sizes: sums whose f32 value depends on their order
    spike = u(B, P, W)
    pk[..., F.PKT_SIZE] = torch.where(spike < 0.05, 1e8, pk[..., F.PKT_SIZE])
    pk[..., F.PKT_SIZE] = torch.where(spike > 0.95, -1e8, pk[..., F.PKT_SIZE])
    pk[..., F.PKT_DIR] = (u(B, P, W) < 0.4).float()
    pk[..., F.PKT_FLAGS] = torch.floor(64 * u(B, P, W))
    pk[..., F.PKT_IAT] = u(B, P, W) * 1e-2
    pk[..., F.PKT_VALID] = (u(B, P, W) < 0.8).float()
    pk[::7, :, :, F.PKT_VALID] = 0.0
    ri = lambda hi: torch.floor(hi * u(B, k)).to(torch.int32)
    rows = (ri(F.N_OPS), ri(F.PKT_NFIELDS + 1), ri(F.N_PREDS),
            torch.where(u(B, k) < 0.5, torch.finfo(torch.float32).max,
                        u(B, k)))
    return pk[:, 1], rows


@pytest.mark.gpu
@pytest.mark.parametrize("B,k", [(MAIN_B, 4), (4200, 41)])
def test_feature_window_kernel_equals_plain_on_card(card, B, k):
    pkts, rows = _card_window_inputs(card, B, MAIN_W, k)
    before = feature_window.launches
    got = feature_window.feature_window_kernel(pkts, *rows)
    torch.cuda.synchronize()
    assert feature_window.launches == before + 1
    assert torch.equal(got, ref.feature_window_ref(pkts, *rows))


@pytest.mark.gpu
def test_dt_traverse_kernel_equals_plain_on_card(card):
    S, k, T, L, bb = 30, 4, 8, 8, 128
    g = torch.Generator(device=card).manual_seed(5)
    u = lambda *s: torch.rand(*s, generator=g, device=card)
    thr = torch.sort(torch.floor(100 * u(S, k, T)), dim=2).values
    thr[:, :, 6:] = float("inf")
    lo = torch.floor(4 * u(S, L, k)).to(torch.int32)
    hi = lo + torch.floor(6 * u(S, L, k)).to(torch.int32)
    act = torch.floor(40 * u(S, L)).to(torch.int32)
    valid = (u(S, L) < 0.9).to(torch.int32)
    regs = torch.floor(100 * u(MAIN_B, k))
    sid = torch.floor(S * u(MAIN_B)).to(torch.int32)
    d = dispatch.sid_dispatch(sid, n_subtrees=S, block_b=bb)
    regs_g = torch.zeros(d.block_sid.shape[0] * bb, k, device=card)
    regs_g[d.dest.long()] = regs[d.order.long()]
    args = (d.block_sid, regs_g, thr, lo, hi, act, valid)
    got = dt_traverse.dt_traverse_kernel(*args, block_b=bb)
    torch.cuda.synchronize()
    assert torch.equal(got, dt_traverse.dt_traverse_blocks_ref(*args,
                                                               block_b=bb))
    action = dispatch.dispatch_dt_traverse(regs, sid, thr, lo, hi, act,
                                           valid, block_b=bb)
    s = sid.long()
    assert torch.equal(action, ref.dt_traverse_ref(
        regs, thr[s], lo[s], hi[s], act[s], valid[s] > 0))


@pytest.mark.gpu
def test_engine_cuda_equals_fused_and_oracle_on_card(card):
    ds = make_dataset("d2", 1200)
    tr, te = ds.split()
    Xw = window_features(tr, 3)                       # kernel A, k = 41
    np.testing.assert_array_equal(Xw, window_features(tr, 3, device="cpu"))
    pdt = train_partitioned_dt(Xw, tr.labels, partition_sizes=[2, 3, 2], k=4)
    eng = Engine.from_model(pdt)
    wp = window_packets(te, 3)
    res = eng.run(wp)
    fused = eng.run(torch.from_numpy(wp).to(card),
                    options=EngineOptions(impl="fused"))
    labels, recircs, exit_p = pdt.predict(window_features(te, 3),
                                          return_trace=True)
    for name, want in (("labels", labels), ("recircs", recircs),
                       ("exit_partition", exit_p)):
        np.testing.assert_array_equal(getattr(res, name), want)
        np.testing.assert_array_equal(getattr(fused, name), want)
    for a, b in zip(res.regs_trace, fused.regs_trace):
        np.testing.assert_array_equal(a, b)


def _card_fold_inputs(device, C: int, k: int):
    """One packet per row and a mid-window ``(acc, seen)`` state, made on
    the card from a seed: every op and predicate code, out-of-range field
    codes, invalid packets and order-sensitive values (+-1e8)."""
    g = torch.Generator(device=device).manual_seed(C + k)
    u = lambda *s: torch.rand(*s, generator=g, device=device)
    pkt = torch.zeros(C, F.PKT_NFIELDS, device=device)
    pkt[:, F.PKT_TS] = u(C)
    spike = u(C)
    pkt[:, F.PKT_SIZE] = torch.where(
        spike < 0.1, 1e8, torch.where(spike > 0.9, -1e8,
                                      torch.floor(40 + 1460 * u(C))))
    pkt[:, F.PKT_DIR] = (u(C) < 0.4).float()
    pkt[:, F.PKT_FLAGS] = torch.floor(64 * u(C))
    pkt[:, F.PKT_IAT] = u(C) * 1e-2
    pkt[:, F.PKT_VALID] = (u(C) < 0.8).float()
    ri = lambda hi, lo=0: (lo + torch.floor((hi - lo) * u(C, k))).to(
        torch.int32)
    op, field, pred = ri(F.N_OPS), ri(F.PKT_NFIELDS + 2, -1), ri(F.N_PREDS + 1)
    init = torch.where(u(C, k) < 0.5, torch.finfo(torch.float32).max,
                       u(C, k))
    acc0, _ = ref.feature_state_init(op)
    seen = (u(C, k) < 0.5).to(torch.int32)
    acc = torch.where(seen > 0, torch.where(u(C, k) < 0.5, 1e8, -1e8)
                      + torch.floor(100 * u(C, k)), acc0)
    return pkt, op, field, pred, init, acc, seen


@pytest.mark.gpu
@pytest.mark.parametrize("C,k", [(32768, 4), (1000, 4), (333, 41)])
def test_fold_kernels_equal_plain_on_card(card, C, k):
    pkt, op, field, pred, init, acc, seen = _card_fold_inputs(card, C, k)
    before = (feature_window.update_launches,
              feature_window.update_finalize_launches)
    got = feature_window.feature_update_kernel(pkt, op, field, pred, acc,
                                               seen)
    got_f = feature_window.feature_update_finalize_kernel(
        pkt, op, field, pred, init, acc, seen)
    torch.cuda.synchronize()
    assert (feature_window.update_launches,
            feature_window.update_finalize_launches) == (before[0] + 1,
                                                         before[1] + 1)
    for a, b in zip(got, ref.feature_update_ref(pkt, op, field, pred, acc,
                                                seen)):
        assert torch.equal(a, b)
    for a, b in zip(got_f, ref.feature_update_finalize_ref(
            pkt, op, field, pred, init, acc, seen)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("tick_engine", ["fused", "legacy"])
def test_cuda_server_equals_fused_server_on_card(card, tick_engine):
    """The kernel route and the plain route of the flow-table server give
    the same verdicts, call by call and row by row, and the same stats,
    with spill and timeout eviction in play."""
    from repro_torch.flows.synthetic import make_packet_stream
    from repro_torch.serve import FlowTableServer
    ds = make_dataset("d2", 600)
    X = window_features(ds, 3)
    pdt = train_partitioned_dt(X, ds.labels, partition_sizes=[2, 3, 2], k=4)
    eng = Engine.from_model(pdt)
    stream = make_packet_stream(ds, seed=3, concurrency=128.0)
    out = {}
    for impl in ("cuda", "fused"):
        srv = FlowTableServer(eng, n_buckets=8, bucket_size=8,
                              timeout=0.005, tick_engine=tick_engine,
                              options=EngineOptions(impl=impl))
        before = (feature_window.update_launches,
                  feature_window.update_finalize_launches)
        calls = [srv.ingest(b) for b in stream.ticks(1024)] + [srv.flush()]
        launched = (feature_window.update_launches - before[0],
                    feature_window.update_finalize_launches - before[1])
        out[impl] = (calls, srv.stats.as_dict(), launched)
    cuda, cstats, claunch = out["cuda"]
    fused, fstats, flaunch = out["fused"]
    assert len(cuda) == len(fused)
    for a, b in zip(cuda, fused):
        for name in ("flow_id", "labels", "recircs", "exit_partition"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert cstats == fstats
    assert cstats["spilled"] > 0 and cstats["evicted"] > 0
    assert flaunch == (0, 0)
    assert claunch[0 if tick_engine == "legacy" else 1] > 0
