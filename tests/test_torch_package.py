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
from repro_torch.core.inference import Engine, EngineOptions, get_backend
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.device import resolve_device
from repro_torch.flows.synthetic import make_dataset
from repro_torch.flows.windows import window_features, window_packets
from repro_torch.kernels import (
    dispatch, dt_traverse, engine_hop, feature_window, ref,
)
from repro_torch.kernels.ops import cuda_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    examples = os.path.join(REPO, "examples")
    out = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(examples, f) for f in os.listdir(examples)
        if f.endswith("_torch.py")]
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
        "repro_torch.kernels.chunk_scan, repro_torch.models.rwkv, "
        "repro_torch.models.mamba2, repro_torch.models.moe, "
        "repro_torch.models.transformer, "
        "repro_torch.models.model_zoo, repro_torch.serve.batching, "
        "repro_torch.launch.serve, repro_torch.obs, repro_torch.serve\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    assert out.strip() == "[]"


def test_import_and_cpu_path_never_call_nvcc():
    """Importing every module and running the CPU engine, a CPU
    flow-table server (both tick engines) and the reduced RWKV6 batcher
    on the CPU starts no process (no ``nvcc``) and loads no kernel
    library."""
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
        "from repro_torch.kernels import chunk_scan\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.models import rwkv\n"
        "from repro_torch.serve import batching\n"
        "st = serve.main(['--arch', 'rwkv6-1.6b', '--slots', '2', "
        "'--requests', '3', '--max-new', '3', '--device', 'cpu'])\n"
        "assert st.completed == 3 and chunk_scan.launches == 0\n"
        "print(len(_build._LIBS))\n")
    assert out.strip().splitlines()[-1] == "0"


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
    headers = sorted(h.name for h in csrc.glob("*.cuh"))
    assert {"packet_fields.cuh", "fold.cuh"} <= set(headers)
    base = _build.build_dir()
    assert base == _build.build_dir()              # deterministic
    for name in ("packet_fields.cuh", "fold.cuh"):
        header = csrc / name
        before = _build.build_dir()
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        edited = _build.build_dir()
        assert edited != before and edited.parent == base.parent, name
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.build_dir() != edited            # a new header counts
    src = csrc / "feature_update.cu"
    before = _build.build_dir()
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build.build_dir() != before


def test_build_sources_list_every_kernel():
    """Every ``csrc/*.cu`` is built (the tick kernel among them), and
    every source's shared headers are keyed."""
    from repro_torch.kernels import _build
    assert "tick_step.cu" in _build.SOURCES
    assert sorted(_build.SOURCES) == sorted(
        f.name for f in _build.CSRC.glob("*.cu"))
    headers = {h.name for h in _build.CSRC.glob("*.cuh")}
    for src in ("tick_step.cu", "feature_update.cu", "dt_traverse.cu"):
        text = (_build.CSRC / src).read_text()
        assert '#include "fold.cuh"' in text, src
    assert "fold.cuh" in headers


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


def test_get_backend_without_card_raises(no_card):
    """``get_backend(device=None)`` means the card, as every entry point
    does: no silent fall back to the CPU.  Its own refusals come first and
    read as before; a named device only picks the matrix's row."""
    for impl in ("auto", "ref", "fused", "cuda", "looped"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_backend(impl)
    with pytest.raises(ValueError, match="shape-dependent"):
        get_backend("tuned")
    with pytest.raises(ValueError, match="unknown impl"):
        get_backend("pallas")
    assert get_backend("auto", device="cpu").name == "fused"
    assert get_backend("ref", device="cpu").name == "fused"


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
    with pytest.raises(ValueError, match="unknown trainer"):
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


def _tiny_tick(k: int, device="cpu"):
    """A four-slot tick state admitted with 5-packet flows, a one-subtree
    table of k slots, and one rank of packets."""
    from repro_torch.kernels import tick_step as tk
    from repro_torch.kernels.ops import DeviceTables
    i32 = dict(dtype=torch.int32, device=device)
    dev = DeviceTables(
        torch.ones(1, k, **i32), torch.zeros(1, k, **i32),
        torch.zeros(1, k, **i32), torch.zeros(1, k, device=device),
        torch.zeros(1, k, 2, device=device), torch.zeros(1, 2, k, **i32),
        torch.zeros(1, 2, k, **i32), torch.zeros(1, 2, **i32),
        torch.ones(1, 2, **i32))
    st = tk.init_tick_state(dev, 5, 3)
    tk.admit_rows(st, torch.arange(4, **i32), torch.full((4,), 5, **i32),
                  dev)
    slots = torch.arange(4, **i32)[None]
    pkt = torch.zeros(1, 4, F.PKT_NFIELDS, device=device)
    return st, slots, pkt, dev


def test_tick_step_kernel_refuses_cpu_tensors_and_wide_k():
    """The tick kernel takes CUDA tensors only (``cuda=True`` never runs
    the plain loop) and k up to ``K_MAX``; neither refusal launches."""
    from repro_torch.kernels import tick_step as tk
    before = tk.tick_launches
    st, slots, pkt, dev = _tiny_tick(4)
    with pytest.raises(ValueError, match="CUDA"):
        tk.tick_step_kernel(st, slots, pkt, dev, n_subtrees=1)
    with pytest.raises(ValueError, match="CUDA"):
        tk.tick_step(st, slots, pkt, dev, n_subtrees=1, cuda=True)
    st, slots, pkt, dev = _tiny_tick(tk.K_MAX + 1)
    with pytest.raises(ValueError, match=f"1..{tk.K_MAX}"):
        tk.tick_step_kernel(st, slots, pkt, dev, n_subtrees=1)
    assert tk.tick_launches == before
    # the plain loop takes the same wide state
    _, (vm, *_rest) = tk.tick_step(st, slots, pkt, dev, n_subtrees=1,
                                   cuda=False)
    assert vm.shape == (4,) and int(vm.sum()) == 0


@pytest.mark.parametrize("k", [9, 16, 17, 41])
def test_tick_step_kernel_takes_every_k_up_to_k_max(k):
    """k = 9 .. K_MAX (= N_FEATURES) passes the tick wrapper's k check:
    with CPU tensors the refusal is the CUDA one, not the k one."""
    from repro_torch.kernels import tick_step as tk
    assert tk.K_MAX == F.N_FEATURES == 41
    st, slots, pkt, dev = _tiny_tick(k)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.tick_step_kernel(st, slots, pkt, dev, n_subtrees=1)


def test_card_server_refuses_k_above_k_max_at_construction():
    """A server whose tick engine would launch the tick kernel with k
    above K_MAX fails when it is built, naming the limit; the legacy tick
    engine and the plain route take the same model."""
    from repro_torch.core.inference import EngineTables
    from repro_torch.kernels import tick_step as tk
    from repro_torch.serve import FlowTableServer
    _, _, _, dev = _tiny_tick(tk.K_MAX + 1)
    tables = EngineTables(dev=dev, n_subtrees=1, n_partitions=3,
                          n_classes=2)
    # the check runs before anything touches the card
    card_eng = Engine(tables=tables, device=torch.device("cuda"))
    with pytest.raises(ValueError, match=f"K_MAX = {tk.K_MAX}"):
        FlowTableServer(card_eng)
    cpu_eng = Engine(tables=tables, device=torch.device("cpu"))
    FlowTableServer(cpu_eng)
    FlowTableServer(cpu_eng, tick_engine="legacy")


def test_hop_kernel_wrapper_refuses_cpu_tensors(tiny_model):
    """The hop kernel takes CUDA tensors only; its plain in-place version
    takes the same arguments on the CPU."""
    ds, _, pdt = tiny_model
    eng = Engine.from_model(pdt, device="cpu")
    pk = torch.from_numpy(window_packets(ds, 2))
    B = pk.shape[0]
    carry = (torch.zeros(B, dtype=torch.int32),
             torch.zeros(B, dtype=torch.bool),
             torch.full((B,), -1, dtype=torch.int32),
             torch.zeros(B, dtype=torch.int32),
             torch.full((B,), -1, dtype=torch.int32))
    before = engine_hop.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        engine_hop.engine_hop_kernel(pk[:, 0], carry, eng.tables.dev, 0,
                                     n_subtrees=eng.tables.n_subtrees)
    regs = torch.empty(B, eng.tables.dev.slot_op.shape[1])
    engine_hop.engine_hop_plain(pk[:, 0], carry, eng.tables.dev, 0,
                                n_subtrees=eng.tables.n_subtrees,
                                regs_out=regs)
    assert engine_hop.launches == before
    assert int(carry[3].sum()) + int(carry[1].sum()) == B  # every flow hopped


def test_tick_pack_puts_each_slot_in_one_column():
    """The fused server's pack, over random ticks: every real slot lies
    in exactly ONE column and alone there (the tick kernel's
    precondition), its packets in arrival order down the ranks; unused
    cells hold the dummy slot and zero packets; both axes are powers of
    two, the width at least the rank floor."""
    from hypothesis import given, settings
    from hypothesis import strategies as hs

    from repro_torch.serve import FlowTableServer
    dummy = 50

    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(hs.lists(hs.integers(0, dummy - 1), min_size=1, max_size=300),
           hs.sampled_from([1, 4, 64]))
    def prop(slots, rank_floor):
        slots = np.asarray(slots, np.int64)
        pkts = np.repeat(np.arange(1, slots.size + 1, dtype=np.float32),
                         F.PKT_NFIELDS).reshape(-1, F.PKT_NFIELDS)
        slots_rc, pkt_rc = FlowTableServer._pack_tick(
            slots, pkts, dummy=dummy, rank_floor=rank_floor)
        R, C = slots_rc.shape
        assert slots_rc.dtype == np.int32 and pkt_rc.shape == (R, C, 6)
        assert R & (R - 1) == 0 and C & (C - 1) == 0 and C >= rank_floor
        for s in np.unique(slots):
            cols = np.nonzero((slots_rc == s).any(axis=0))[0]
            assert cols.size == 1
            col = slots_rc[:, cols[0]]
            n = int(np.count_nonzero(slots == s))
            assert (col[:n] == s).all() and (col[n:] == dummy).all()
            np.testing.assert_array_equal(pkt_rc[:n, cols[0]],
                                          pkts[slots == s])
        pad = slots_rc == dummy
        assert int((~pad).sum()) == slots.size
        assert not pkt_rc[pad].any()

    prop()


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
    windows, made on ``device`` from a seed; returns the hop-1 view and
    (B, k) slot rows."""
    pk, rows = _window_tensor(device, B, W, k, P)
    return pk[:, 1], rows


def _window_tensor(device, B: int, W: int, k: int, P: int):
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
    return pk, rows


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
@pytest.mark.parametrize("k", [1, 4, 8, 9, 41])
@pytest.mark.parametrize("W", [1, 64, 65])
def test_feature_window_kernel_shapes_on_card(card, k, W):
    """Kernel A over the window walk's geometries: strided hop views of
    one to 65 packets, tiles of 256 // k flows, B no multiple of any."""
    pkts, rows = _card_window_inputs(card, 5003, W, k)
    assert not pkts.is_contiguous()
    got = feature_window.feature_window_kernel(pkts, *rows)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.feature_window_ref(pkts, *rows))


def _hop_inputs(device, B: int, W: int, k: int, S: int = 30, T: int = 8,
                L: int = 8):
    """A hop view, random subtree tables and a mid-walk carry (SIDs over
    [0, S) and -1, a third of the flows done), made on the CPU from a
    seed, so the walk they give is the same on every machine, and moved
    to ``device``."""
    from repro_torch.kernels.ops import DeviceTables
    pk, _ = _window_tensor("cpu", B, W, k, 3)
    pkts = pk.to(device)[:, 1]
    g = torch.Generator().manual_seed(7 * B + W + k)
    u = lambda *s: torch.rand(*s, generator=g)
    ri = lambda hi, *s: torch.floor(hi * u(*s)).to(torch.int32)
    thr = torch.where(u(S, k, T) < 0.5, torch.floor(100 * u(S, k, T)),
                      torch.floor(3000 * u(S, k, T)) - 1000)
    thr = torch.sort(thr, dim=2).values
    thr[:, :, T - 2:] = float("inf")
    full = u(S, L, k) < 1 - 0.5 / k
    lo = torch.where(full, 0, ri(3, S, L, k)).to(torch.int32)
    hi = torch.where(full, T, lo + ri(T, S, L, k)).to(torch.int32)
    dev = DeviceTables(
        ri(F.N_OPS, S, k), ri(F.PKT_NFIELDS + 1, S, k), ri(F.N_PREDS, S, k),
        torch.where(u(S, k) < 0.5, torch.finfo(torch.float32).max,
                    u(S, k)),
        thr, lo, hi, ri(S + 4, S, L), (u(S, L) < 0.9).to(torch.int32))
    done = u(B) < 0.3
    carry = (ri(S + 1, B) - 1, done,
             torch.where(done, ri(4, B), -1).to(torch.int32), ri(3, B),
             torch.where(done, ri(3, B), -1).to(torch.int32))
    return (pkts, DeviceTables(*(t.to(device) for t in dev)),
            tuple(t.to(device) for t in carry))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4, 8, 9, 41])
@pytest.mark.parametrize("W", [1, 64, 65])
def test_hop_kernel_equals_engine_hop_ref_on_card(card, k, W):
    """Three hops from a mid-walk carry: the hop kernel in place on one
    copy, ``engine_hop_ref`` on another; every carry field and the
    registers with ``torch.equal``, hop after hop."""
    S = 30
    pkts, dev, carry = _hop_inputs(card, 5003, W, k, S=S)
    assert (carry[0] == -1).any() and carry[1].any()
    got = tuple(t.clone() for t in carry)
    want = carry
    for p in range(3):
        regs = torch.empty(pkts.shape[0], k, device=card)
        before = engine_hop.launches
        engine_hop.engine_hop_kernel(pkts, got, dev, p, n_subtrees=S,
                                     regs_out=regs)
        want, want_regs = ref.engine_hop_ref(pkts, want, dev, p, S)
        torch.cuda.synchronize()
        assert engine_hop.launches == before + 1
        assert torch.equal(regs, want_regs), p
        for name, a, b in zip(("sid", "done", "labels", "recircs", "exit_p"),
                              got, want):
            assert torch.equal(a, b), (p, name)
    assert want[1].sum() > carry[1].sum() and (want[3] > carry[3]).any()


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


@pytest.mark.gpu
def test_engine_run_on_card_runs_the_hop_kernel_into_pinned_memory(card):
    """``Engine.run`` on the card: P hop launches and no launch of kernel A
    or B; its arrays live in pinned host memory and stay as they were when
    the engine runs again."""
    ds, eng = _serving_model(n_flows=900)
    wp = window_packets(ds, 3)
    before = (engine_hop.launches, feature_window.launches,
              dt_traverse.launches)
    first = eng.run(torch.from_numpy(wp).to(card))
    assert (engine_hop.launches - before[0], feature_window.launches
            - before[1], dt_traverse.launches - before[2]) == (3, 0, 0)
    assert torch.from_numpy(first.labels).is_pinned()
    kept = [a.copy() for a in (first.labels, first.recircs,
                               first.exit_partition, *first.regs_trace)]
    second = eng.run(wp[::-1].copy())
    assert not np.array_equal(second.labels, first.labels)
    for a, b in zip((first.labels, first.recircs, first.exit_partition,
                     *first.regs_trace), kept):
        np.testing.assert_array_equal(a, b)
    fused = eng.run(wp, options=EngineOptions(impl="fused"))
    for name in ("labels", "recircs", "exit_partition"):
        np.testing.assert_array_equal(getattr(first, name),
                                      getattr(fused, name))
    for a, b in zip(first.regs_trace, fused.regs_trace):
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


def _serving_model(k: int = 4, n_flows: int = 600):
    ds = make_dataset("d2", n_flows)
    X = window_features(ds, 3)
    pdt = train_partitioned_dt(X, ds.labels, partition_sizes=[2, 3, 2], k=k)
    return ds, Engine.from_model(pdt)


def _count_ticks(monkeypatch) -> list:
    """Record the (R, C) of every ``tick_step`` call the server makes."""
    from repro_torch.kernels import tick_step as tk
    calls, orig = [], tk.tick_step

    def counted(state, slots_rc, pkt_rc, dev, **kw):
        calls.append(tuple(slots_rc.shape))
        return orig(state, slots_rc, pkt_rc, dev, **kw)

    monkeypatch.setattr(tk, "tick_step", counted)
    return calls


@pytest.mark.gpu
@pytest.mark.parametrize("tick_engine", ["fused", "legacy"])
def test_cuda_server_equals_fused_server_on_card(card, tick_engine,
                                                 monkeypatch):
    """The kernel route and the plain route of the flow-table server give
    the same verdicts, call by call and row by row, and the same stats,
    with spill and timeout eviction in play.  The fused engine's kernel
    route launches the tick kernel once per tick and no fold kernel."""
    from repro_torch.flows.synthetic import make_packet_stream
    from repro_torch.kernels import tick_step as tk
    from repro_torch.serve import FlowTableServer
    ds, eng = _serving_model()
    stream = make_packet_stream(ds, seed=3, concurrency=128.0)
    ticks = _count_ticks(monkeypatch)
    out = {}
    for impl in ("cuda", "fused"):
        srv = FlowTableServer(eng, n_buckets=8, bucket_size=8,
                              timeout=0.005, tick_engine=tick_engine,
                              options=EngineOptions(impl=impl))
        before = (feature_window.update_launches,
                  feature_window.update_finalize_launches, tk.tick_launches)
        n_ticks = len(ticks)
        calls = [srv.ingest(b) for b in stream.ticks(1024)] + [srv.flush()]
        launched = (feature_window.update_launches - before[0],
                    feature_window.update_finalize_launches - before[1],
                    tk.tick_launches - before[2])
        out[impl] = (calls, srv.stats.as_dict(), launched,
                     len(ticks) - n_ticks)
    cuda, cstats, claunch, cticks = out["cuda"]
    fused, fstats, flaunch, _ = out["fused"]
    assert len(cuda) == len(fused)
    for a, b in zip(cuda, fused):
        for name in ("flow_id", "labels", "recircs", "exit_partition"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert cstats == fstats
    assert cstats["spilled"] > 0 and cstats["evicted"] > 0
    assert flaunch == (0, 0, 0)
    if tick_engine == "legacy":
        assert claunch[0] > 0 and claunch[1:] == (0, 0)
    else:
        assert cticks > 0 and claunch == (0, 0, cticks)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4, 1, 8, 9, 41])
def test_tick_kernel_equals_rank_loop_on_card(card, k, monkeypatch):
    """Every tick of a stream with spill and timeout eviction, served by
    the kernel route: the tick kernel on the server's state equals the
    plain rank loop on a clone of the same state, with ``torch.equal`` on
    rows ``[:N]`` of every ``TickState`` field and on the five verdict
    arrays, tick after tick (each tick starts from the kernel's state)."""
    from repro_torch.flows.synthetic import make_packet_stream
    from repro_torch.kernels import tick_step as tk
    from repro_torch.serve import FlowTableServer
    ds, eng = _serving_model(k)
    assert eng.tables.dev.slot_op.shape[1] == k
    orig, compared = tk.tick_step, []

    def both(state, slots_rc, pkt_rc, dev, *, n_subtrees, cuda):
        assert cuda
        clone = tk.TickState(*(t.clone() for t in state))
        _, want = orig(clone, slots_rc, pkt_rc, dev, n_subtrees=n_subtrees,
                       cuda=False)
        before = tk.tick_launches
        got = orig(state, slots_rc, pkt_rc, dev, n_subtrees=n_subtrees,
                   cuda=True)
        torch.cuda.synchronize()
        assert tk.tick_launches == before + 1
        N = state.sid.shape[0] - 1
        for name in tk.TickState._fields:
            assert torch.equal(getattr(state, name)[:N],
                               getattr(clone, name)[:N]), name
        for i, (a, b) in enumerate(zip(got[1], want)):
            assert torch.equal(a, b), i
        compared.append(int(want[0].sum()))
        return got

    monkeypatch.setattr(tk, "tick_step", both)
    srv = FlowTableServer(eng, n_buckets=8, bucket_size=8, timeout=0.005)
    stream = make_packet_stream(ds, seed=3, concurrency=128.0)
    for b in stream.ticks(1024):
        srv.ingest(b)
    srv.flush()
    assert srv.stats.spilled > 0 and srv.stats.evicted > 0
    assert len(compared) > 5 and sum(compared) > 0


def _scan_inputs(device, BH: int, T: int, dk: int, dv: int, decays: str,
                 seed: int = 0):
    """q, k, v, decay, bonus, state made on ``device`` from a seed.
    ``decays="uniform"``: U[0.5, 0.999] (where the chunked form is exact);
    ``"model"``: RWKV6's init decays, exp(-exp(N(0, 0.05))) ~ 0.37."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = lambda *s: torch.randn(*s, generator=g, device=device)
    u = lambda *s: torch.rand(*s, generator=g, device=device)
    w = (0.5 + 0.499 * u(BH, T, dk) if decays == "uniform"
         else torch.exp(-torch.exp(0.05 * n(BH, T, dk))))
    return n(BH, T, dk), n(BH, T, dk), n(BH, T, dv), w, n(BH, dk), n(BH, dk,
                                                                      dv)


#: (B*H, T, chunk, dk, dv): the lm_check shapes of chip_smoke.py --
#: rwkv6-1.6b's prefill, decode, a padded prompt, the reduced model, 32
#: chunks (the state passed across many chunks) and one chunk (none);
#: then the kernel's padded tiles: a chunk of 37 rows and one of 100 (two
#: row tiles, the second of 36 rows), dk = 40 and 44 (padded to 48), dv = 36
#: and 30 (a partial 8-column tile; 30 also unaligned rows of v), dv = 96
#: (a second, half-width dv tile) and dk = dv = 128 (the largest dk, two
#: dv tiles)
LM_SCAN_SHAPES = [(32, 1024, 128, 64, 64), (32, 1, 128, 64, 64),
                  (32, 300, 128, 64, 64), (8, 64, 16, 16, 16),
                  (32, 4096, 128, 64, 64), (32, 128, 128, 64, 64),
                  (32, 37, 128, 64, 64), (32, 100, 128, 64, 64),
                  (8, 256, 128, 40, 36), (8, 200, 64, 44, 30),
                  (8, 256, 128, 64, 96), (8, 256, 128, 128, 128)]


def _kernels_per_call(C: int) -> int:
    """Device kernels the design launches per call: the one-step kernel at
    C == 1, else the prep, state-pass and output kernels."""
    return 1 if C == 1 else 3


def test_chunk_scan_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import chunk_scan as cs
    q, k, v, w, b, s = _scan_inputs("cpu", 2, 8, 4, 4, "uniform")
    before = cs.launches
    with pytest.raises(ValueError, match="CUDA"):
        cs.chunk_scan_kernel(q, k, v, w, b, s, chunk=4)
    from repro_torch.kernels import ops
    with pytest.raises(ValueError, match="unknown impl"):
        ops.chunk_scan(q, k, v, w, b, s, chunk=4, impl="pallas")
    assert cs.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("decays", ["uniform", "model"])
@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("BH,T,chunk,dk,dv", LM_SCAN_SHAPES)
def test_chunk_scan_kernel_matches_plain_on_card(card, BH, T, chunk, dk, dv,
                                                 bonus, decays):
    """The kernel against its plain version through ``ops.chunk_scan``
    (padding included), at the tolerances of tests/test_kernels.py: o
    within 2e-4 * max(|o|, 1), the state within 3e-4."""
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.kernels import ops
    q, k, v, w, u, s0 = _scan_inputs(card, BH, T, dk, dv, decays, seed=T)
    u = u if bonus else None
    before = cs.launches, cs.kernel_launches
    o, s = ops.chunk_scan(q, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert cs.launches == before[0] + 1
    assert cs.kernel_launches == before[1] + _kernels_per_call(
        min(chunk, T))
    o_ref, s_ref = ops.chunk_scan(q, k, v, w, u, s0, chunk=chunk, impl="ref")
    scale = max(float(o_ref.abs().max()), 1.0)
    assert float((o - o_ref).abs().max()) <= 2e-4 * scale
    assert float((s - s_ref).abs().max()) <= 3e-4
    # deterministic: a second launch gives the same bits
    o2, s2 = ops.chunk_scan(q, k, v, w, u, s0, chunk=chunk)
    assert torch.equal(o, o2) and torch.equal(s, s2)


@pytest.mark.gpu
@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("T", [1024, 1])
def test_chunk_scan_graph_replay_equals_eager_on_card(card, T, bonus):
    """A call captured in a CUDA graph and replayed gives the eager call's
    bits, and one call is 3 kernel nodes (chunk-parallel) or 1 (a decode
    step), read from the captured graph through the CUDA runtime, as the
    library's own count says."""
    import ctypes

    from repro_torch.kernels import chunk_scan as cs
    q, k, v, w, u, s0 = _scan_inputs(card, 32, T, 64, 64, "uniform", seed=9)
    u = u if bonus else torch.zeros_like(u)
    run = lambda: cs.chunk_scan_kernel(q, k, v, w, u, s0, chunk=128,
                                       use_bonus=bonus)
    before = cs.kernel_launches
    o, s = run()                                   # eager (and warm)
    torch.cuda.synchronize()
    assert cs.kernel_launches - before == _kernels_per_call(min(128, T))
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        go, gs = run()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(go, o) and torch.equal(gs, s)
    rt = ctypes.CDLL("libcudart.so.12")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    # cudaGraphNodeTypeKernel == 0
    assert kinds == [0] * _kernels_per_call(min(128, T))


@pytest.mark.gpu
def test_rwkv_kernel_route_matches_plain_route_on_card(card):
    """Reduced RWKV6 on the card: prefill logits, the cache and four
    teacher-forced decode steps on the kernel route against the plain
    route, within the bound of tests/test_models.py (0.05 * max |logit|)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import pspec as tp
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.models import rwkv
    cfg = get_arch("rwkv6-1.6b").reduced()
    gen = torch.Generator(device=card).manual_seed(0)
    model = rwkv.RWKV6(cfg, tp.init_params(rwkv.param_defs(cfg), gen, card))
    toks = torch.randint(0, cfg.vocab, (2, 41), generator=gen, device=card,
                         dtype=torch.int32)
    out = {}
    with torch.no_grad():
        for impl in (None, "ref"):
            before = cs.launches
            cache = rwkv.init_cache(cfg, 2, 64, card)
            lg, cache, _ = model({"tokens": toks[:, :37]}, mode="prefill",
                                 cache=cache, impl=impl)
            lgs = [lg[:, -1].float()]
            for t in range(37, 41):
                lg, cache, _ = model({"tokens": toks[:, t:t + 1]},
                                     mode="decode", cache=cache, impl=impl)
                lgs.append(lg[:, -1].float())
            launched = cs.launches - before
            out[impl] = (torch.stack(lgs), cache, launched)
    (a, ca, na), (b, cb, nb) = out[None], out["ref"]
    assert na == 5 * cfg.n_layers and nb == 0
    assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())
    assert float((ca["tm"]["S"] - cb["tm"]["S"]).abs().max()) <= 3e-4 * max(
        1.0, float(cb["tm"]["S"].abs().max()))
