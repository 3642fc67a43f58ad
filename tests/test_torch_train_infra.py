"""The port's training infrastructure against the JAX package, on the CPU.

Every case of tests/test_train_infra.py has a mirror here, held to the
JAX package on the same numpy inputs: AdamW (params, mu, nu,
``grad_norm`` and ``lr`` within 1e-6 relative over 1, 5 and 120 steps;
the tests print where they are bit-equal), the clip, ``warmup_cosine`` at
every step, ``compress_grads`` with its error feedback and
``compression_ratio`` bit for bit, checkpoints written by either package
and restored by the other (equal arrays and templates),
``latest_committed``, the async writer's gc and its error on ``wait()``,
``run_with_recovery`` on the toy problem, the watchdog's flags, and the
token pipeline (``batch_at``, ``iterate`` and the Markov tables) bit for
bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# the JAX package is the reference; where it is not installed (the card's
# machine) this file is skipped
jnp = pytest.importorskip("jax.numpy")

import jax  # noqa: E402

from repro.data import tokens as jtokens  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed.pspec import (  # noqa: E402
    tree_from_items, tree_items, tree_map,
)
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import elastic as telastic  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

REL = 1e-6
CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _flat(tree) -> dict[str, np.ndarray]:
    """A tree of either package as {dotted name: numpy array}."""
    return {n: _np(v) for n, v in tree_items(tree_map(_np, tree))}


def _rel(got, want) -> float:
    got, want = np.float64(_np(got)), np.float64(_np(want))
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max() / scale)


def _toy_params(seed=0) -> dict[str, np.ndarray]:
    """1-D and 2-D leaves, one nested: the shapes a model's tree mixes."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32),
            "blk": {"s": rng.normal(size=(3, 8)).astype(np.float32)}}


def _both(tree):
    """The same numpy tree as JAX arrays and as CPU tensors."""
    return (jax.tree.map(jnp.asarray, tree),
            tree_map(lambda a: torch.tensor(a), tree))


def _quadratic_grads_j(p):
    return jax.grad(lambda q: sum(jnp.sum((a - 1.0) ** 2)
                                  for a in jax.tree.leaves(q)))(p)


def _quadratic_grads_t(p: dict) -> dict:
    leaves = [t.detach().requires_grad_(True) for _, t in tree_items(p)]
    loss = sum(torch.sum((a - 1.0) ** 2) for a in leaves)
    return tree_from_items([n for n, _ in tree_items(p)],
                           torch.autograd.grad(loss, leaves))


def _compare_states(js, ts, tol=REL) -> dict:
    """Params, mu and nu of both states within ``tol`` relative; returns
    how many leaves were bit-equal of each."""
    equal = {}
    for part in ("params", "mu", "nu"):
        jf = _flat(getattr(js, part))
        tf = _flat(topt.param_tree(getattr(ts, part)))
        assert set(jf) == set(tf), part
        for n in jf:
            assert _rel(tf[n], jf[n]) <= tol, (part, n, _rel(tf[n], jf[n]))
        equal[part] = sum(np.array_equal(tf[n], jf[n]) for n in jf)
    assert int(ts.step) == int(js.step)
    return equal


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_steps", [1, 5, 120])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_jax(n_steps, schedule):
    """The quadratic of test_adamw_converges_quadratic on a tree of 1-D and
    2-D leaves (so weight decay is on for some and off for others), with a
    constant lr and with ``warmup_cosine``.  Each step both optimizers
    take the same numpy gradients (JAX's, at JAX's parameters): params,
    mu, nu, ``grad_norm`` and ``lr`` within 1e-6 relative after every
    step.  The global norm's f32 sum is not bit-equal (XLA and torch add
    in other orders), so with the clip active a last-bit difference of
    the scale can appear from the second step on; the test prints how
    many leaves stayed bit-equal."""
    lr = (lambda pkg: pkg.warmup_cosine(0.05, 10, 120)) if schedule \
        else (lambda pkg: 0.05)
    jo, to = jopt.AdamW(lr=lr(jopt)), topt.AdamW(lr=lr(topt))
    jp, tp = _both(_toy_params())
    js, ts = jo.init(jp), to.init(tp)
    gaps = {"grad_norm": 0.0, "lr": 0.0}
    for _ in range(n_steps):
        g = jax.tree.map(np.asarray, _quadratic_grads_j(js.params))
        js, jm = jo.update(js, jax.tree.map(jnp.asarray, g))
        ts, tm = to.update(ts, tree_map(torch.tensor, g))
        for k in gaps:
            gaps[k] = max(gaps[k], _rel(tm[k], jm[k]))
            assert tm[k].dtype == torch.float32
        equal = _compare_states(js, ts)
    assert max(gaps.values()) <= REL, gaps
    print(f"{n_steps} steps, schedule={schedule}: bit-equal leaves "
          f"{equal} of 3, metric gaps {gaps}")


def test_adamw_converges_quadratic():
    """test_adamw_converges_quadratic on the port, with its own
    gradients."""
    to = topt.AdamW(lr=0.05)
    ts = to.init(_both(_toy_params())[1])
    loss = lambda p: sum(float(((a - 1.0) ** 2).sum())
                         for _, a in tree_items(p))
    l0 = loss(ts.params)
    for _ in range(120):
        ts, _ = to.update(ts, _quadratic_grads_t(ts.params))
    assert loss(ts.params) < 0.05 * l0
    assert int(ts.step) == 120


def test_grad_clip_matches_jax():
    """test_grad_clip_bounds_update: a 1e6 gradient clipped to 1e-3; the
    same norm, lr and parameters as JAX."""
    jo, to = jopt.AdamW(lr=1.0, grad_clip=1e-3), \
        topt.AdamW(lr=1.0, grad_clip=1e-3)
    js = jo.init({"w": jnp.zeros((4,))})
    ts = to.init({"w": torch.zeros(4)})
    js, jm = jo.update(js, {"w": jnp.full((4,), 1e6)})
    ts, tm = to.update(ts, {"w": torch.full((4,), 1e6)})
    assert float(tm["grad_norm"]) > 1e5
    assert float(ts.params["w"].abs().max()) < 2.0
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= REL
    _compare_states(js, ts)


@pytest.mark.parametrize("args", [(1.0, 10, 100), (3e-3, 20, 30),
                                  (3e-3, 20, 50), (0.05, 0, 7)])
def test_warmup_cosine_matches_jax(args):
    """test_warmup_cosine_shape, and every step 0..total (and past it)
    within 1e-6 relative of JAX's f32 values; prints how many are
    bit-equal."""
    jlr, tlr = jopt.warmup_cosine(*args), topt.warmup_cosine(*args)
    total = args[2]
    steps = np.arange(total + 3, dtype=np.int32)
    got = np.array([float(tlr(torch.tensor(s))) for s in steps])
    want = np.array([float(jlr(jnp.asarray(s))) for s in steps])
    assert np.all(np.abs(got - want) <= REL * np.abs(want).max())
    print(f"warmup_cosine{args}: {int((got == want).sum())} of "
          f"{len(steps)} bit-equal")
    if args == (1.0, 10, 100):
        assert got[0] == 0.0
        assert got[10] == pytest.approx(1.0)
        assert got[100] == pytest.approx(0.1, abs=0.01)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def test_compress_grads_bit_equal_to_jax():
    """test_compression_error_feedback_unbiased on two leaves: each of 50
    steps' compressed gradients and residuals equal JAX's bit for bit (half
    to even on both sides), the accumulated compressed gradient tracks the
    true sum, and ``compression_ratio`` equals JAX's."""
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "v": {"b": rng.normal(size=(33,)).astype(np.float32)}}
    jerr = terr = None
    total_c = np.zeros((64, 64))
    total_r = np.zeros((64, 64))
    for i in range(50):
        gi = tree_map(lambda a: (a * np.float32(1 + 0.01 * i))
                      .astype(np.float32), g)
        jg, tg = _both(gi)
        jc, jerr = jcomp.compress_grads(jg, jerr)
        tc, terr = tcomp.compress_grads(tg, terr)
        for a, b in ((jc, tc), (jerr, terr)):
            fa, fb = _flat(a), _flat(b)
            assert set(fa) == set(fb)
            for n in fa:
                assert fb[n].dtype == fa[n].dtype
                assert np.array_equal(fb[n].view(np.int32),
                                      fa[n].view(np.int32)), (i, n)
        total_c += _np(tc["w"])
        total_r += gi["w"]
    assert float(np.abs(total_c - total_r).max()
                 / np.abs(total_r).max()) < 0.01
    assert tcomp.compression_ratio(_both(g)[1]) == \
        jcomp.compression_ratio(_both(g)[0])
    assert tcomp.compression_ratio(_both(g)[1]) < 0.55


def test_quantize_rounds_half_to_even_as_jax():
    """Values on the half-way points of the int8 grid (and -0.0, and an
    all-zero leaf, where the scale floors at 1e-30) quantise as in JAX."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0, -0.0,
                  3.49999976], np.float32)
    for a in (x, np.zeros(5, np.float32)):
        jq, js = jcomp._quantize(jnp.asarray(a))
        tq, ts = tcomp._quantize(torch.tensor(a))
        assert np.array_equal(_np(tq), np.asarray(jq))
        assert _np(ts).tobytes() == np.asarray(js).tobytes()


def test_compressed_training_matches_uncompressed():
    """test_compressed_training_matches_uncompressed on the port (its own
    gradients); then 80 compressed steps on JAX's gradients in both
    packages, within 1e-6 of JAX's state."""
    to = topt.AdamW(lr=0.05)
    ts_plain, ts = (to.init(_both(_toy_params(5))[1]) for _ in range(2))
    terr = None
    for _ in range(80):
        ts_plain, _ = to.update(ts_plain, _quadratic_grads_t(ts_plain.params))
        g, terr = tcomp.compress_grads(_quadratic_grads_t(ts.params), terr)
        ts, _ = to.update(ts, g)
    loss = lambda p: sum(float(((a - 1.0) ** 2).sum())
                         for _, a in tree_items(p))
    assert loss(ts.params) < 1.5 * loss(ts_plain.params) + 1e-3

    jo = jopt.AdamW(lr=0.05)
    js, ts = jo.init(_both(_toy_params(5))[0]), \
        to.init(_both(_toy_params(5))[1])
    jerr = terr = None
    for _ in range(80):
        g = jax.tree.map(np.asarray, _quadratic_grads_j(js.params))
        jg, jerr = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), jerr)
        tg, terr = tcomp.compress_grads(tree_map(torch.tensor, g), terr)
        js, _ = jo.update(js, jg)
        ts, _ = to.update(ts, tg)
    _compare_states(js, ts)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _stepped_states(seed=1):
    """One AdamW step from the same tree in each package."""
    jo, to = jopt.AdamW(lr=0.05), topt.AdamW(lr=0.05)
    jp, tp = _both(_toy_params(seed))
    js, _ = jo.update(jo.init(jp), jax.tree.map(jnp.ones_like, jp))
    ts, _ = to.update(to.init(tp), tree_map(torch.ones_like, tp))
    return js, ts


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _npz(path) -> dict:
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_checkpoint_roundtrip(tmp_path):
    """test_checkpoint_roundtrip on the port: every leaf and the extra
    come back, the step as an int32 scalar."""
    _, ts = _stepped_states()
    path = str(tmp_path / "step_1")
    tckpt.save(path, ts, {"note": "x"})
    restored, extra = tckpt.restore(path, device=CPU)
    assert extra == {"note": "x"}
    assert restored.step.dtype == torch.int32 and restored.step.dim() == 0
    for part in ("params", "mu", "nu"):
        a, b = _flat(getattr(ts, part)), _flat(getattr(restored, part))
        assert set(a) == set(b)
        for n in a:
            assert np.array_equal(a[n], b[n]), (part, n)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """A checkpoint written by either package restores in the other: the
    same ``arrays.npz`` keys and arrays, the same manifest template, step
    and extra, and equal restored trees."""
    js, ts = _stepped_states()
    pj, pt = str(tmp_path / "jax" / "step_1"), str(tmp_path / "port" / "step_1")
    jckpt.save(pj, js, {"note": "x"})
    tckpt.save(pt, ts, {"note": "x"})
    za, zb = _npz(pj), _npz(pt)
    assert set(za) == set(zb)
    assert all(np.array_equal(za[k], zb[k]) and za[k].dtype == zb[k].dtype
               for k in za)
    ma, mb = _manifest(pj), _manifest(pt)
    assert json.dumps(ma["template"]) == json.dumps(mb["template"])
    assert (ma["step"], ma["extra"]) == (mb["step"], mb["extra"]) == (1, {
        "note": "x"})
    src = pt if writer == "port" else pj
    jr, jextra = jckpt.restore(src)
    tr, textra = tckpt.restore(src, device=CPU)
    assert jextra == textra == {"note": "x"}
    assert int(jr.step) == int(tr.step) == 1
    for part in ("params", "mu", "nu"):
        a, b = _flat(getattr(jr, part)), _flat(getattr(tr, part))
        assert set(a) == set(b)
        for n in a:
            assert np.array_equal(a[n], b[n]), (part, n)
            assert np.array_equal(a[n], _flat(getattr(js, part))[n])


def test_latest_committed_picks_max(tmp_path):
    """test_latest_committed_picks_max, and an uncommitted or foreign
    directory is passed over, as by JAX's."""
    to = topt.AdamW(lr=0.05)
    ts = to.init(_both(_toy_params(2))[1])
    for s in (1, 5, 3):
        st = topt.TrainState(step=torch.tensor(s, dtype=torch.int32),
                             params=ts.params, mu=ts.mu, nu=ts.nu)
        tckpt.save(str(tmp_path / f"step_{s}"), st)
    os.makedirs(tmp_path / "step_9")                 # never committed
    os.makedirs(tmp_path / "notes")
    (tmp_path / "notes" / "COMMITTED").write_text("ok")
    got = tckpt.latest_committed(str(tmp_path))
    assert got.endswith("step_5")
    assert got == jckpt.latest_committed(str(tmp_path))
    assert tckpt.latest_committed(str(tmp_path / "absent")) is None


def test_async_checkpointer_gc_and_error(tmp_path):
    """test_async_checkpointer: keep=2 leaves the last two step dirs, as
    JAX's writer does on the same saves; the state is copied before
    ``save`` returns, so a step in place right after it is not saved; a
    writer that cannot write raises on the next ``wait()``; the log has
    one entry a save."""
    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    writers = {"jax": jckpt.AsyncCheckpointer(str(roots["jax"]), keep=2),
               "port": tckpt.AsyncCheckpointer(str(roots["port"]), keep=2)}
    js, ts = _stepped_states(3)
    for s in range(1, 5):
        writers["jax"].save(jopt.TrainState(
            step=jnp.asarray(s, jnp.int32), params=js.params, mu=js.mu,
            nu=js.nu))
        writers["port"].save(topt.TrainState(
            step=torch.tensor(s, dtype=torch.int32), params=ts.params,
            mu=ts.mu, nu=ts.nu))
    for w in writers.values():
        w.wait()
    dirs = {k: sorted(d for d in os.listdir(r) if d.startswith("step_"))
            for k, r in roots.items()}
    assert dirs["port"] == dirs["jax"] == ["step_3", "step_4"]
    log = writers["port"].log
    assert [e["step"] for e in log] == [1, 2, 3, 4]
    assert all(e["write_s"] is not None and e["bytes"] > 0 for e in log)

    # the snapshot is taken before save() returns: an in-place step right
    # after it (the optimizer's) does not reach the files
    w = tckpt.AsyncCheckpointer(str(tmp_path / "race"))
    before = {n: a.copy() for n, a in _flat(ts.params).items()}
    w.save(ts)
    for _, p in tree_items(ts.params):
        p.add_(1.0)
    w.wait()
    saved, _ = tckpt.restore(str(tmp_path / "race" / "step_1"), device=CPU)
    assert all(np.array_equal(_flat(saved.params)[n], a)
               for n, a in before.items())

    blocked = tmp_path / "a_file"
    blocked.write_text("not a directory")
    bad = tckpt.AsyncCheckpointer(str(blocked))
    bad.save(ts)
    with pytest.raises(OSError):
        bad.wait()


# ---------------------------------------------------------------------------
# recovery and the watchdog
# ---------------------------------------------------------------------------
def test_run_with_recovery_matches_jax(tmp_path):
    """test_run_with_recovery_replays_from_checkpoint with
    ``fail_at={12, 23}`` in both packages: the same report (failures,
    restores, steps run, final step; straggler flags are wall-clock and
    are not compared) and final parameters within 1e-6 relative."""
    jo, to = jopt.AdamW(lr=0.05), topt.AdamW(lr=0.05)
    jp, tp = _both(_toy_params(4))

    def jstep(state, batch):
        return jo.update(state, _quadratic_grads_j(state.params))

    def tstep(state, batch):
        return to.update(state, _quadratic_grads_t(state.params))

    js, jrep = jelastic.run_with_recovery(
        jstep, jo.init(jp), range(30), ckpt_root=str(tmp_path / "jax"),
        ckpt_every=5, fail_at={12, 23})
    ts, trep = telastic.run_with_recovery(
        tstep, to.init(tp), range(30), ckpt_root=str(tmp_path / "port"),
        ckpt_every=5, fail_at={12, 23})
    assert trep.failures == 2 and trep.restores == 2
    assert trep.final_step == 30 and trep.steps_run > 30
    assert (trep.failures, trep.restores, trep.steps_run,
            trep.final_step) == (jrep.failures, jrep.restores,
                                 jrep.steps_run, jrep.final_step)
    _compare_states(js, ts)


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_watchdog_flags_match_jax(seed):
    """test_watchdog_flags_stragglers's sequence, then seeded sequences
    with spikes: the same flags, EMA and straggler steps as JAX's."""
    if seed is None:
        dts, kw = [0.1, 0.1, 0.1, 0.1, 0.5, 0.1], dict(threshold=2.0,
                                                       warmup_steps=1)
    else:
        rng = np.random.default_rng(seed)
        dts = (rng.uniform(0.05, 0.15, 40)
               * np.where(rng.random(40) < 0.15, 5.0, 1.0)).tolist()
        kw = {}
    seen = {"jax": [], "port": []}
    wj = jelastic.StepWatchdog(**kw, on_straggler=lambda s, dt, e:
                               seen["jax"].append(s))
    wt = telastic.StepWatchdog(**kw, on_straggler=lambda s, dt, e:
                               seen["port"].append(s))
    flags = [(wt.observe(i, dt), wj.observe(i, dt)) for i, dt in
             enumerate(dts)]
    assert all(a == b for a, b in flags)
    assert seen["port"] == seen["jax"] and wt.ema == wj.ema
    assert wt.stragglers == wj.stragglers
    if seed is None:
        assert wt.stragglers == 1 and seen["port"] == [4]


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,batch,seq,seed", [(128, 4, 16, 7),
                                                   (32000, 2, 64, 0)])
def test_token_pipeline_bit_equal_to_jax(vocab, batch, seq, seed):
    """test_data_pipeline_deterministic_resume: ``batch_at(step)`` and
    ``iterate(start)`` equal JAX's bit for bit, the Markov tables too, and
    ``on_device`` places int32 tensors."""
    jp = jtokens.TokenPipeline(vocab, batch, seq, seed=seed)
    tp = ttokens.TokenPipeline(vocab, batch, seq, seed=seed)
    assert np.array_equal(tp.source.succ, jp.source.succ)
    assert tp.source.p.tobytes() == jp.source.p.tobytes()
    for step in (0, 1, 5, 123):
        a, b = tp.batch_at(step), jp.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    it = tp.iterate(start_step=5)
    for step in (5, 6, 7):
        assert np.array_equal(next(it)["tokens"], jp.batch_at(step)["tokens"])
    it.close()
    placed = ttokens.on_device(torch.device(CPU))(tp.batch_at(5))
    assert all(t.dtype == torch.int32 for t in placed.values())
    assert np.array_equal(placed["labels"].numpy(), jp.batch_at(5)["labels"])


def test_markov_source_learnable_structure():
    """test_markov_source_learnable_structure on the port's copy, and its
    samples equal JAX's."""
    src = ttokens.MarkovText(64, branching=4, seed=0)
    seq = src.sample(np.random.default_rng(0), 1, 4000)[0]
    assert np.array_equal(seq, jtokens.MarkovText(64, branching=4, seed=0)
                          .sample(np.random.default_rng(0), 1, 4000)[0])
    succ_sets = {}
    for a, b in zip(seq[:-1], seq[1:]):
        succ_sets.setdefault(int(a), set()).add(int(b))
    assert np.mean([len(v) for v in succ_sets.values()]) <= 4.5


# ---------------------------------------------------------------------------
# the package boundary and the device rule
# ---------------------------------------------------------------------------
def test_training_modules_load_neither_jax_nor_repro():
    """Importing the training half (and the launcher) in a fresh process
    loads nothing of JAX or of the JAX package."""
    code = ("import sys, repro_torch.train.optimizer, "
            "repro_torch.train.train_step, repro_torch.train.checkpoint, "
            "repro_torch.train.elastic, repro_torch.data.tokens, "
            "repro_torch.distributed.compression, repro_torch.launch.train, "
            "repro_torch.convert\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """``restore``, ``run_with_recovery``'s restore and the launcher take
    the card unless asked for the CPU; without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts = _stepped_states()
    tckpt.save(str(tmp_path / "step_1"), ts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore(str(tmp_path / "step_1"))
    from repro_torch.launch import train as tlaunch
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced",
                      "--steps", "1"])
