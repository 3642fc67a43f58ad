"""Early-exit compaction and the looped backend of the port vs the JAX
package, at zero tolerance, on the CPU.

* ``bucket_caps`` and ``compact_perm`` equal the JAX package's, the empty
  batch included, and the plain ``compacted_step`` equals JAX's;
* the port's compacted walk (``fused``, and ``looped`` through
  ``Engine.run_looped`` and ``EngineOptions(impl="looped")``) equals the
  JAX ``Engine.run(compact=True)`` fused walk and ``run_looped(compact=
  True)`` -- labels, recircs, exit partitions and the trace, whose rows
  hold zeros for flows done before a hop -- and ``PartitionedDT.predict``,
  on the three exit profiles, on random trees and on a model whose flows
  never exit;
* the plain compacted hop leaves done flows' register rows as they are,
  on every rung of its ladder;
* on the card (marker ``gpu``): the hop kernel's survivor mode against
  the plain compacted hop and ``engine_hop_ref``, with rows and a count
  out of range, and ``run_looped``'s kernel launches.

Inputs are made with numpy from a seed and handed to both packages.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.inference import Engine, EngineOptions
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.flows.synthetic import (
    EXIT_PROFILES, make_dataset, make_profile_dataset,
)
from repro_torch.flows.windows import window_features, window_packets
from repro_torch.kernels import compaction
from repro_torch.kernels import ref as tref
from repro_torch.kernels.compaction import (
    bucket_caps, compact_perm, compacted_step,
)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, the reference.  The card's machine has no JAX, so
    there only the card tests of this file run."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core.inference import Engine, EngineOptions
    from repro.core.partition import train_partitioned_dt
    from repro.kernels import compaction, ops
    return types.SimpleNamespace(
        jnp=jnp, Engine=Engine, Options=EngineOptions,
        train=train_partitioned_dt, comp=compaction, ops=ops)


_COMPACT = EngineOptions(compact=True)


# ---------------------------------------------------------------------------
# the ladder and the survivor permutation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,floor", [(0, 128), (1, 128), (100, 64),
                                     (128, 128), (129, 128), (4096, 128),
                                     (5000, 64), (1 << 20, 128)])
def test_bucket_caps_equal_jax(jx, n, floor):
    assert bucket_caps(n, floor) == jx.comp.bucket_caps(n, floor)


@pytest.mark.parametrize("n,floor", [(-1, 128), (16, 0), (16, -4)])
def test_bucket_caps_errors_equal_jax(jx, n, floor):
    with pytest.raises(ValueError) as want:
        jx.comp.bucket_caps(n, floor)
    with pytest.raises(ValueError) as got:
        bucket_caps(n, floor)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("B,p_done", [(0, 0.5), (1, 0.0), (1, 1.0),
                                      (6, 0.5), (257, 0.0), (257, 1.0),
                                      (1000, 0.3), (4099, 0.9)])
def test_compact_perm_equals_jax(jx, B, p_done):
    done = np.random.default_rng(B).random(B) < p_done
    perm, n_active = compact_perm(torch.from_numpy(done))
    j_perm, j_n = jx.comp.compact_perm(jx.jnp.asarray(done))
    assert perm.dtype == torch.int32 and n_active.dtype == torch.int32
    assert perm.shape == (B,) and n_active.shape == ()
    np.testing.assert_array_equal(perm.numpy(), np.asarray(j_perm))
    assert int(n_active) == int(j_n) == int((~done).sum())


def test_compact_perm_survivors_first_in_order():
    done = torch.tensor([True, False, True, False, False, True])
    perm, n_active = compact_perm(done)
    assert int(n_active) == 3
    assert perm.tolist() == [1, 3, 4, 0, 2, 5]


# ---------------------------------------------------------------------------
# a trained model, its port and its JAX twin
# ---------------------------------------------------------------------------
def _models(ds, sizes, k, p, jx=None):
    """The port's model and, with ``jx``, the JAX package's from the same
    features (the port's window features equal the JAX package's:
    test_torch_engine)."""
    Xw = window_features(ds, p, device="cpu")
    pdt = train_partitioned_dt(Xw, ds.labels, partition_sizes=sizes, k=k)
    pdt_j = (None if jx is None
             else jx.train(Xw, ds.labels, partition_sizes=sizes, k=k))
    return pdt, pdt_j, Xw, window_packets(ds, p)


def _assert_equal(res, ref, *, trace: bool = True, what: str = ""):
    for name in ("labels", "recircs", "exit_partition"):
        got = getattr(res, name)
        assert got.dtype == np.int32, (what, name)
        np.testing.assert_array_equal(got, getattr(ref, name),
                                      err_msg=f"{what}: {name}")
    if trace:
        assert len(res.regs_trace) == len(ref.regs_trace), what
        for p, (a, b) in enumerate(zip(res.regs_trace, ref.regs_trace)):
            np.testing.assert_array_equal(
                np.asarray(a).view(np.int32), np.asarray(b).view(np.int32),
                err_msg=f"{what}: regs hop {p}")


def _assert_oracle(res, oracle, what: str = ""):
    for name, want in zip(("labels", "recircs", "exit_partition"), oracle):
        np.testing.assert_array_equal(getattr(res, name), want,
                                      err_msg=f"{what}: {name}")


def _port_runs(eng, wp, *, trace: bool = True):
    """Every compacted route of the port, by name."""
    return {
        "fused": eng.run(wp, with_trace=trace, options=_COMPACT),
        "fused[floor=4]": eng.run(wp, with_trace=trace, options=EngineOptions(
            compact=True, compact_floor=4)),
        "looped": eng.run_looped(wp, with_trace=trace, options=_COMPACT),
        "impl=looped": eng.run(wp, with_trace=trace, options=EngineOptions(
            impl="looped", compact=True)),
        "looped[tensor]": eng.run_looped(torch.from_numpy(wp),
                                         with_trace=trace, options=_COMPACT),
    }


@pytest.mark.parametrize("profile", EXIT_PROFILES)
def test_compacted_walks_equal_jax_on_exit_profiles(jx, profile):
    """front / uniform / back drive the walk through different shrink
    schedules (front: most flows gone after hop 0; back: almost none
    until the last hop).  Every compacted route of the port equals the
    JAX fused compacted walk and its compacted loop, trace included, and
    the numpy oracle."""
    ds = make_profile_dataset(profile, n_flows=360, seed=3)
    tr, _ = ds.split()
    pdt, pdt_j, Xw, wp = _models(tr, [2, 2, 2], 3, 3, jx)
    oracle = pdt.predict(Xw, return_trace=True)
    j_eng = jx.Engine.from_model(pdt_j)
    j_walk = j_eng.run(wp, options=jx.Options(impl="fused", compact=True))
    j_loop = j_eng.run_looped(wp, options=jx.Options(compact=True))
    _assert_equal(j_loop, j_walk, what="JAX loop == JAX walk")
    eng = Engine.from_model(pdt, device="cpu")
    for name, res in _port_runs(eng, wp).items():
        _assert_equal(res, j_walk, what=f"{profile} {name}")
        _assert_oracle(res, oracle, what=f"{profile} {name}")
    dense = eng.run(wp)
    # the trace is the dense one on live (hop, flow) pairs, zero elsewhere
    live = np.ones(wp.shape[0], bool)
    for p, (c, d) in enumerate(zip(j_walk.regs_trace, dense.regs_trace)):
        np.testing.assert_array_equal(np.asarray(c)[live], d[live])
        assert not np.asarray(c)[~live].any()
        live &= dense.exit_partition != p
    assert (~live).any()              # the walk did drop done flows


def test_compacted_step_equals_jax(jx):
    """The plain compacted step on a model's hop 1, each rung of the
    ladder, with and without the registers."""
    ds = make_profile_dataset("front", n_flows=360, seed=3)
    tr, _ = ds.split()
    pdt, pdt_j, _, wp = _models(tr, [2, 2, 2], 3, 3, jx)
    eng = Engine.from_model(pdt, device="cpu")
    j_dev = jx.Engine.from_model(pdt_j).dev
    dense = eng.run(wp)
    done = dense.exit_partition == 0
    sid = torch.zeros(wp.shape[0], dtype=torch.int32)
    # the SIDs a dense hop 0 leaves: recirculating flows' next subtree
    regs0, action0 = tref.fused_step(torch.from_numpy(wp[:, 0]), sid,
                                     eng.tables.dev)
    sid = torch.where(torch.from_numpy(done), sid, action0)
    pk = wp[:, 1]
    for floor in (8, 1024):           # interior rungs; the full rung
        caps = bucket_caps(pk.shape[0], floor)
        for with_regs in (False, True):
            regs, act = compacted_step(
                torch.from_numpy(pk), sid, torch.from_numpy(done),
                eng.tables.dev, step=tref.fused_step, caps=caps,
                with_regs=with_regs)
            j_regs, j_act = jx.comp.compacted_step(
                *map(jx.jnp.asarray, (pk, sid.numpy(), done)), j_dev,
                step=jx.ops.fused_step, caps=caps, with_regs=with_regs)
            np.testing.assert_array_equal(act.numpy(), np.asarray(j_act))
            if with_regs:
                np.testing.assert_array_equal(
                    regs.numpy().view(np.int32),
                    np.asarray(j_regs).view(np.int32))
            else:
                assert regs is None and j_regs is None


def test_compacted_walks_property_random_trees(jx):
    """Random datasets and tree shapes: no compacted route changes a
    verdict or a live register, whatever the exit pattern."""
    from repro.testing.hypothesis_compat import given, settings
    from repro.testing.hypothesis_compat import strategies as st

    @settings(max_examples=3, deadline=None)
    @given(st.integers(0, 2**31 - 1))
    def prop(seed):
        rng = np.random.default_rng(seed)
        p = int(rng.integers(2, 4))
        sizes = [int(rng.integers(1, 4)) for _ in range(p)]
        k = int(rng.integers(2, 5))
        ds = make_dataset("d2", n_flows=220, seed=seed)
        pdt, pdt_j, Xw, wp = _models(ds, sizes, k, p, jx)
        j_walk = jx.Engine.from_model(pdt_j).run(
            wp, options=jx.Options(impl="fused", compact=True))
        eng = Engine.from_model(pdt, device="cpu")
        oracle = pdt.predict(Xw, return_trace=True)
        for name, res in _port_runs(eng, wp).items():
            _assert_equal(res, j_walk, what=name)
            _assert_oracle(res, oracle, what=name)

    prop()


def _truncate(pdt):
    """The final partition routes instead of exiting (a depth-truncated
    DSE candidate's shape, as in tests/test_compaction.py)."""
    last = pdt.n_partitions - 1
    for st_ in pdt.subtrees:
        if st_.partition == last:
            for leaf in st_.leaf_next_sid:
                st_.leaf_next_sid[leaf] = st_.sid      # self-loop
    return pdt


def test_non_terminating_flows_compacted(jx):
    """Flows that never exit keep the -1 sentinels on every compacted and
    looped route, as in the JAX package and the oracle."""
    ds = make_dataset("d2", n_flows=300, seed=7)
    pdt, pdt_j, Xw, wp = _models(ds, [2, 2, 2], 3, 3, jx)
    pdt, pdt_j = _truncate(pdt), _truncate(pdt_j)
    oracle = pdt.predict(Xw, return_trace=True)
    stuck = oracle[0] == -1
    assert stuck.any() and not stuck.all()
    j_eng = jx.Engine.from_model(pdt_j)
    j_ref = {True: j_eng.run(wp, options=jx.Options(impl="fused",
                                                  compact=True)),
             False: j_eng.run_looped(wp)}
    eng = Engine.from_model(pdt, device="cpu")
    runs = dict(_port_runs(eng, wp),
                **{"looped[dense]": eng.run_looped(wp)})
    for name, res in runs.items():
        _assert_equal(res, j_ref["dense" not in name], what=name)
        _assert_oracle(res, oracle, what=name)
        assert res.n_unterminated == int(stuck.sum())


def test_empty_batch_every_route():
    ds = make_dataset("d2", n_flows=120, seed=5)
    pdt, _, _, wp = _models(ds, [2, 2], 3, 2)
    eng = Engine.from_model(pdt, device="cpu")
    empty = wp[:0]
    for res in (*_port_runs(eng, empty).values(), eng.run(empty),
                eng.run_looped(empty)):
        assert res.labels.shape == (0,) and res.n_unterminated == 0
        assert [r.shape for r in res.regs_trace] == [(0, 3), (0, 3)]


def test_engine_options_compaction_knobs(jx):
    assert EngineOptions(impl="looped", compact=True).compact is True
    # compact="auto" lets the routing plan decide (repro_torch.tuning)
    assert EngineOptions(compact="auto").compact == "auto"
    with pytest.raises(ValueError, match="compact must be"):
        EngineOptions(compact=2)
    with pytest.raises(ValueError, match="compact_floor"):
        EngineOptions(compact_floor=0)
    assert EngineOptions().compact_floor == compaction.COMPACT_FLOOR == \
        jx.comp.COMPACT_FLOOR


@pytest.mark.parametrize("caps", ["default", "floor 16", "full rung"])
def test_plain_survivor_hop_keeps_done_rows(caps):
    """The plain compacted hop, on any rung of its ladder: the survivors
    get ``engine_hop_ref``'s registers and carry, and the done flows keep
    their carry and their ``regs_out`` rows (a fill no hop writes), as
    the hop kernel's survivor mode leaves them."""
    from repro_torch.kernels import engine_hop as eh
    S, k, fill = 30, 4, 3.5
    pkts, dev, carry = _survivor_inputs("cpu", 2003, 9, k, S)
    B = pkts.shape[0]
    ladder = {"default": None, "floor 16": bucket_caps(B, 16),
              "full rung": (0, B)}[caps]
    rows, n_active = compact_perm(carry[1])
    got = tuple(t.clone() for t in carry)
    regs = torch.full((B, k), fill)
    eh.engine_hop_plain(pkts, got, dev, 1, n_subtrees=S, regs_out=regs,
                        rows=rows, n_active=n_active, caps=ladder)
    dense, regs_d = tref.engine_hop_ref(pkts, carry, dev, 1, S)
    live, done = ~carry[1], carry[1]
    assert torch.equal(regs[live], regs_d[live])
    assert torch.equal(regs[done], torch.full_like(regs[done], fill))
    for name, a, c in zip(("sid", "done", "labels", "recircs", "exit_p"),
                          got, dense):
        assert torch.equal(a, c), name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _survivor_inputs(device, B: int, W: int, k: int, S: int = 30):
    """A strided hop view, random tables and a mid-walk carry with SID -1
    among the survivors and about 60% of the flows done, made on the CPU
    from a seed and moved to ``device``."""
    from repro_torch.core import features as F
    from repro_torch.kernels.ops import DeviceTables
    g = torch.Generator().manual_seed(B + W + k)
    u = lambda *s: torch.rand(*s, generator=g)
    ri = lambda hi, *s: torch.floor(hi * u(*s)).to(torch.int32)
    pk = torch.zeros(B, 3, W, F.PKT_NFIELDS)
    pk[..., F.PKT_TS] = u(B, 3, W).cumsum(-1)
    pk[..., F.PKT_SIZE] = torch.floor(40 + 1460 * u(B, 3, W))
    pk[..., F.PKT_DIR] = (u(B, 3, W) < 0.4).float()
    pk[..., F.PKT_FLAGS] = torch.floor(64 * u(B, 3, W))
    pk[..., F.PKT_IAT] = u(B, 3, W) * 1e-2
    pk[..., F.PKT_VALID] = (u(B, 3, W) < 0.8).float()
    T, L = 8, 8
    thr = torch.sort(torch.floor(2000 * u(S, k, T)) - 500, dim=2).values
    thr[:, :, T - 2:] = float("inf")
    full = u(S, L, k) < 1 - 0.5 / k
    lo = torch.where(full, 0, ri(3, S, L, k)).to(torch.int32)
    hi = torch.where(full, T, lo + ri(T, S, L, k)).to(torch.int32)
    dev = DeviceTables(
        ri(F.N_OPS, S, k), ri(F.PKT_NFIELDS, S, k), ri(F.N_PREDS, S, k),
        u(S, k), thr, lo, hi, ri(S + 4, S, L),
        (u(S, L) < 0.9).to(torch.int32))
    done = u(B) < 0.6
    carry = (ri(S + 1, B) - 1, done,
             torch.where(done, ri(4, B), -1).to(torch.int32), ri(3, B),
             torch.where(done, 0, -1).to(torch.int32))
    return (pk.to(device)[:, 1], DeviceTables(*(t.to(device) for t in dev)),
            tuple(t.to(device) for t in carry))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4, 9, 41])
@pytest.mark.parametrize("W", [1, 65])
def test_survivor_mode_equals_plain_compacted_hop_on_card(card, k, W):
    """One compacted hop: the hop kernel in survivor mode on one copy of
    the carry, the plain compacted hop on another, and ``engine_hop_ref``
    on every flow for the survivors' rows; every carry field and the
    registers with ``torch.equal``, done flows' rows keeping their fill."""
    from repro_torch.kernels import engine_hop as eh
    S = 30
    pkts, dev, carry = _survivor_inputs(card, 5003, W, k, S)
    survivors = ~carry[1]
    assert (carry[0][survivors] == -1).any() and carry[1].any()
    rows, n_active = compact_perm(carry[1])
    got, plain = (tuple(t.clone() for t in carry) for _ in range(2))
    regs_k = torch.full((pkts.shape[0], k), 3.5, device=card)
    regs_p = torch.full((pkts.shape[0], k), 3.5, device=card)
    before, before_s = eh.launches, eh.survivor_launches
    eh.engine_hop_kernel(pkts, got, dev, 1, n_subtrees=S, regs_out=regs_k,
                         rows=rows, n_active=n_active)
    eh.engine_hop_plain(pkts, plain, dev, 1, n_subtrees=S, regs_out=regs_p,
                        rows=rows, n_active=n_active)
    dense, regs_d = tref.engine_hop_ref(pkts, carry, dev, 1, S)
    torch.cuda.synchronize()
    assert eh.launches == before + 1
    assert eh.survivor_launches == before_s + 1
    assert torch.equal(regs_k, regs_p)
    assert torch.equal(regs_k[survivors], regs_d[survivors])
    assert (regs_k[carry[1]] == 3.5).all()
    for name, a, b, c in zip(("sid", "done", "labels", "recircs", "exit_p"),
                             got, plain, dense):
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4, 41])
def test_dense_hop_counts_its_done_flows_on_card(card, k):
    """``survivors_out`` on a dense hop: the kernel takes the flows done
    after the hop (those done before it among them) off what the word
    held, as the plain hop does, and writes the same carry; a
    survivor-mode launch refuses the word."""
    from repro_torch.kernels import engine_hop as eh
    S = 30
    pkts, dev, carry = _survivor_inputs(card, 5003, 65, k, S)
    B = pkts.shape[0]
    got, plain = (tuple(t.clone() for t in carry) for _ in range(2))
    left = torch.full((2,), B, dtype=torch.int32, device=card)
    eh.engine_hop_kernel(pkts, got, dev, 1, n_subtrees=S,
                         survivors_out=left[0])
    eh.engine_hop_plain(pkts, plain, dev, 1, n_subtrees=S,
                        survivors_out=left[1])
    torch.cuda.synchronize()
    for name, a, b in zip(("sid", "done", "labels", "recircs", "exit_p"),
                          got, plain):
        assert torch.equal(a, b), name
    want = B - int(got[1].sum())
    assert 0 <= want <= B - int(carry[1].sum())
    assert left.tolist() == [want, want]
    rows, n_active = compact_perm(carry[1])
    for hop in (eh.engine_hop_kernel, eh.engine_hop_plain):
        with pytest.raises(ValueError, match="dense hop only"):
            hop(pkts, tuple(t.clone() for t in carry), dev, 1, n_subtrees=S,
                rows=rows, n_active=n_active, survivors_out=left[0])


@pytest.mark.gpu
def test_survivor_mode_out_of_range_inputs_on_card(card):
    """A survivor count above B reads as B, so every position holds a
    flow, done ones too; a row outside ``[0, B)`` leaves its position
    empty.  The named flows get ``engine_hop_ref``'s registers and carry,
    the dropped ones keep theirs and the fill: nothing is read or written
    out of bounds."""
    from repro_torch.kernels import engine_hop as eh
    S, k = 30, 4
    pkts, dev, carry = _survivor_inputs(card, 5003, 65, k, S)
    B = pkts.shape[0]
    rows, _ = compact_perm(carry[1])
    rows = rows.clone()
    rows[::7] = -3
    rows[3::7] = B + 11
    named = torch.zeros(B, dtype=torch.bool, device=card)
    named[rows[(rows >= 0) & (rows < B)].long()] = True
    got = tuple(t.clone() for t in carry)
    regs = torch.full((B, k), 3.5, device=card)
    eh.engine_hop_kernel(pkts, got, dev, 1, n_subtrees=S, regs_out=regs,
                         rows=rows, n_active=torch.full(
                             (1,), B + 100, dtype=torch.int32, device=card))
    dense, regs_d = tref.engine_hop_ref(pkts, carry, dev, 1, S)
    torch.cuda.synchronize()
    assert named.any() and not named.all()
    assert torch.equal(regs[named], regs_d[named])
    assert (regs[~named] == 3.5).all()
    for name, a, c, o in zip(("sid", "done", "labels", "recircs", "exit_p"),
                             got, dense, carry):
        assert torch.equal(a, torch.where(named, c, o)), name


@pytest.mark.gpu
def test_compacted_walks_on_card(card):
    """``Engine.run(compact=True)`` on the card: P hop launches, equal to
    the dense walk's verdicts and to the plain compacted walk's trace;
    ``run_looped`` with and without ``compact``: one launch of kernel A
    and one of kernel B a hop with survivors, the same verdicts."""
    from repro_torch.kernels import dt_traverse
    from repro_torch.kernels import engine_hop as eh
    from repro_torch.kernels import feature_window as fw
    ds = make_profile_dataset("front", n_flows=900, seed=3)
    pdt, _, Xw, wp = _models(ds, [2, 2, 2], 3, 3)
    eng = Engine.from_model(pdt)
    x = torch.from_numpy(wp).to(card)
    before, before_s = eh.launches, eh.survivor_launches
    comp = eng.run(x, options=_COMPACT)
    assert eh.launches - before == 3
    assert eh.survivor_launches - before_s == 2
    plain = eng.run(x, options=EngineOptions(impl="fused", compact=True))
    _assert_equal(comp, plain, what="kernel == plain")
    _assert_oracle(comp, pdt.predict(Xw, return_trace=True))
    for opt in (EngineOptions(), _COMPACT):
        a0, b0 = fw.launches, dt_traverse.launches
        res = eng.run_looped(x, options=opt)
        # a flow walks hop p unless it exited before it
        exits = res.exit_partition
        live = [int(((exits < 0) | (exits >= p)).sum()) for p in range(3)]
        n_hops = sum(n > 0 for n in live) if opt.compact else 3
        assert fw.launches - a0 == dt_traverse.launches - b0 == n_hops
        _assert_equal(res, comp if opt.compact else eng.run(x),
                      what=f"looped {opt}")
