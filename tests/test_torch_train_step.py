"""The port's train step and training launcher against the JAX package,
on the CPU, and the ``chunk_scan`` kernel's refusal of autograd on the
card.

Three families start from one JAX ``TrainState`` carried across by
``convert.train_state_from_arrays`` and take three steps of
``make_train_step`` on the same Markov batches, with both packages'
products in f32 (``COMPUTE_DTYPE`` patched in each for the test only):
the per-step loss within 1e-5 relative and each ``mu`` leaf within 1e-3
by relative norm, as the models' gradient tests hold them; ``grad_norm``
and ``nu`` are printed beside.  JAX is imported in a fixture, so on the
card's machine (no JAX) the ``gpu`` tests still run.
"""
import dataclasses
import os
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline, on_device
from repro_torch.distributed import pspec as tpspec
from repro_torch.kernels import chunk_scan as cs_kernel
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as tlaunch
from repro_torch.models import model_zoo
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainLoopCfg, make_train_step

CPU = "cpu"
LOSS_TOL, MU_TOL = 1e-5, 1e-3
PORT_F32 = ("layers", "transformer", "moe", "rwkv", "mamba2", "mla",
            "whisper")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's training modules."""
    pytest.importorskip("jax.numpy")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.distributed import pspec as jpspec
    from repro.launch import train as jlaunch
    from repro.models import model_zoo as jzoo
    from repro.train import optimizer as jopt
    from repro.train import train_step as jstep
    return types.SimpleNamespace(jax=jax, jnp=jnp, j_get_arch=j_get_arch,
                                 jpspec=jpspec, jlaunch=jlaunch, jzoo=jzoo,
                                 jopt=jopt, jstep=jstep)


@pytest.fixture
def f32_products(jx, monkeypatch):
    """Both packages' products in f32, for one test."""
    import importlib
    for name in PORT_F32:
        monkeypatch.setattr(importlib.import_module(f"repro.models.{name}"),
                            "COMPUTE_DTYPE", jx.jnp.float32)
        monkeypatch.setattr(
            importlib.import_module(f"repro_torch.models.{name}"),
            "COMPUTE_DTYPE", torch.float32)


def _flat(tree) -> dict[str, np.ndarray]:
    return {n: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for n, v in tpspec.tree_items(tree)}


def _jax_flat(jx, tree) -> dict[str, np.ndarray]:
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jx.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _norm_gap(got: np.ndarray, want: np.ndarray) -> float:
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(np.float64(got) - np.float64(want)))
    return num / den if den else num


def _worst(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(_norm_gap(got[n], want[n]) for n in want)


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------
CASES = [("tinyllama-1.1b", TrainLoopCfg()),
         ("tinyllama-1.1b", TrainLoopCfg(microbatches=2,
                                         compress_grads=True)),
         ("qwen2-moe-a2.7b", TrainLoopCfg(microbatches=2)),
         ("rwkv6-1.6b", TrainLoopCfg())]


def _levels(deq: np.ndarray) -> tuple[np.ndarray, float]:
    """The int8 levels and the scale behind dequantised values."""
    scale = float(np.abs(deq).max()) / 127
    return np.round(deq / scale), scale


@pytest.mark.parametrize("arch,loop", CASES,
                         ids=[f"{a}-mb{l.microbatches}-c{int(l.compress_grads)}"
                              for a, l in CASES])
def test_train_steps_match_jax(jx, f32_products, monkeypatch, arch, loop):
    """Three steps from one JAX state at AdamW's default lr: the loss of
    every step within 1e-5 relative and every ``mu`` leaf within 1e-3 by
    relative norm of JAX's (the MoE in training mode, which drops over
    capacity; RWKV6 on the plain chunked scan, as JAX runs it on the
    CPU).

    With compression the int8 levels are a rounding of gradients that
    differ in their last bits, so an element near a rounding boundary
    can land one level apart in the two packages; one such element of a
    16,384-element leaf moves its relative norm by ~1e-3.  So that run
    also holds what quantisation with error feedback promises: each
    leaf's scale within 1e-3 relative at the first step (later a carried
    residual a level apart can move a leaf's largest value by a level);
    what each package sent so far equal to the gradients so far less a
    residual of at most half of the current level, element by element,
    in both packages at once (the two sums' gap within a level of the
    gradients' sums' gap); and
    ``mu`` within 1e-3 on the elements whose levels agreed at every step
    so far (the gap over all elements, and the largest share of a leaf's
    elements ever a level apart, are printed)."""
    jcfg, cfg = jx.j_get_arch(arch).reduced(), get_arch(arch).reduced()
    jzoo = jx.jzoo.get_model(jcfg)
    jopt_ = jx.jopt.AdamW()
    jloop = jx.jstep.TrainLoopCfg(microbatches=loop.microbatches,
                                  compress_grads=loop.compress_grads)
    jfn = jx.jstep.make_train_step(jcfg, jopt_, jloop)
    if not loop.compress_grads:       # compressed: eager, to record
        jfn = jx.jax.jit(jfn)
    sent = {"jax": [], "port": []}

    def recorder(fn, log, flat):
        def wrapped(grads, err=None):
            out = fn(grads, err)
            log.append((flat(grads), flat(out[0])))
            return out
        return wrapped

    from repro.distributed import compression as jcomp
    from repro_torch.distributed import compression as tcomp
    monkeypatch.setattr(jcomp, "compress_grads", recorder(
        jcomp.compress_grads, sent["jax"], lambda t: _jax_flat(jx, t)))
    monkeypatch.setattr(tcomp, "compress_grads", recorder(
        tcomp.compress_grads, sent["port"], _flat))
    js = jopt_.init(jx.jpspec.init_params(jzoo.param_defs(jcfg),
                                          jx.jax.random.key(0)))
    ts = convert.train_state_from_arrays(
        {f: jx.jax.tree.map(np.asarray, getattr(js, f))
         for f in ("step", "params", "mu", "nu")}, cfg=cfg, device=CPU)
    tfn = make_train_step(cfg, topt.AdamW(), loop)
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=3)
    jerr = terr = None
    apart: dict[str, np.ndarray] = {}
    sums: dict[str, np.ndarray] = {}
    for i in range(3):
        b = pipe.batch_at(i)
        js, jm, jerr = jfn(js, {k: jx.jnp.asarray(v) for k, v in b.items()},
                           jerr)
        ts, tm, terr = tfn(ts, on_device(torch.device(CPU))(b), terr)
        jl, tl = float(jm["loss"]), float(tm["loss"])
        tmu, jmu = _flat(ts.mu), _jax_flat(jx, js.mu)
        gaps = {"loss": abs(tl - jl) / abs(jl),
                "grad_norm": abs(float(tm["grad_norm"])
                                 - float(jm["grad_norm"]))
                / float(jm["grad_norm"]),
                "mu": _worst(tmu, jmu),
                "nu": _worst(_flat(ts.nu), _jax_flat(jx, js.nu)),
                "params": _worst(_flat(topt.param_tree(ts.params)),
                                 _jax_flat(jx, js.params))}
        assert int(ts.step) == int(js.step) == i + 1
        assert gaps["loss"] <= LOSS_TOL, gaps
        if loop.compress_grads:
            assert len(sent["jax"]) == len(sent["port"]) == i + 1
            (tg, tsent), (jg, jsent) = sent["port"][-1], sent["jax"][-1]
            for n, want in jsent.items():
                got = tsent[n]
                (qt, st), (qj, sj) = _levels(got), _levels(want)
                if i == 0:             # no residual carried yet
                    assert abs(st - sj) <= 1e-3 * sj, (n, st, sj)
                # error feedback: what was sent so far is the gradients
                # so far less the residual carried now (at most half a
                # level), so the gap of the two sums of what was sent is
                # the gap of the gradients' sums within a level
                sums[n] = sums.get(n, 0.0) + (np.float64(got) - want) \
                    - (np.float64(tg[n]) - jg[n])
                assert np.abs(sums[n]).max() <= 0.5001 * (st + sj), n
                apart[n] = apart.get(n, False) | (qt != qj)
            gaps["share_apart"] = max(float(np.mean(a))
                                      for a in apart.values())
            gaps["mu_where_levels_agree"] = max(
                _norm_gap(tmu[n][~apart[n]], jmu[n][~apart[n]]) for n in jmu)
            assert gaps["mu_where_levels_agree"] <= MU_TOL, gaps
        else:
            assert gaps["mu"] <= MU_TOL, gaps
        print(f"{arch} {loop}: step {i + 1} loss {tl:.5f} gaps {gaps}")
    if loop.compress_grads:
        assert set(_flat(terr)) == set(_jax_flat(jx, jerr))


def test_run_with_recovery_over_the_train_step_matches_jax(
        jx, f32_products, tmp_path):
    """``examples/fault_tolerance.py``'s use: ``run_with_recovery`` over
    ``make_train_step`` on the reduced ``tinyllama-1.1b`` from one JAX
    state at AdamW's default lr, 8 batches, a checkpoint every 3 steps and failures after steps
    4 and 7, in both packages.  The same report; every step's loss,
    replays included, within 1e-5 relative of JAX's; the final ``mu``
    within 1e-3.  In the port a replayed step's loss equals the step's
    first loss (``==``: the checkpoint was copied back into the live
    state), and the state's parameters stay the model and its own
    ``nn.Parameter`` leaves."""
    from repro.train import elastic as jelastic
    from repro_torch.train import elastic as telastic
    jcfg, cfg = (jx.j_get_arch("tinyllama-1.1b").reduced(),
                 get_arch("tinyllama-1.1b").reduced())
    jopt_, topt_ = jx.jopt.AdamW(), topt.AdamW()
    jraw = jx.jax.jit(lambda s, b: jx.jstep.make_train_step(
        jcfg, jopt_)(s, b, None)[:2])
    traw = make_train_step(cfg, topt_)
    losses = {"jax": [], "port": []}

    def jstep(s, b):
        s, m = jraw(s, b)
        losses["jax"].append((int(s.step), float(m["loss"])))
        return s, m

    def tstep(s, b):
        s, m, _ = traw(s, b)
        losses["port"].append((int(s.step), float(m["loss"])))
        return s, m

    js = jopt_.init(jx.jpspec.init_params(
        jx.jzoo.get_model(jcfg).param_defs(jcfg), jx.jax.random.key(0)))
    ts = convert.train_state_from_arrays(
        {f: jx.jax.tree.map(np.asarray, getattr(js, f))
         for f in ("step", "params", "mu", "nu")}, cfg=cfg, device=CPU)
    model = ts.params
    leaves = [p for _, p in tpspec.tree_items(topt.param_tree(model))]
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=3)
    batches = [pipe.batch_at(i) for i in range(8)]
    js, jrep = jelastic.run_with_recovery(
        jstep, js, [{k: jx.jnp.asarray(v) for k, v in b.items()}
                    for b in batches],
        ckpt_root=str(tmp_path / "jax"), ckpt_every=3, fail_at={4, 7})
    ts, trep = telastic.run_with_recovery(
        tstep, ts, [on_device(torch.device(CPU))(b) for b in batches],
        ckpt_root=str(tmp_path / "port"), ckpt_every=3, fail_at={4, 7})
    assert (trep.failures, trep.restores, trep.steps_run,
            trep.final_step) == (jrep.failures, jrep.restores,
                                 jrep.steps_run, jrep.final_step) \
        == (2, 2, 10, 8)
    steps = [s for s, _ in losses["port"]]
    assert steps == [s for s, _ in losses["jax"]] \
        == [1, 2, 3, 4, 4, 5, 6, 7, 7, 8]
    for (_, tl), (_, jl) in zip(losses["port"], losses["jax"]):
        assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
    first = dict(reversed(losses["port"]))
    assert all(tl == first[s] for s, tl in losses["port"])
    assert _worst(_flat(ts.mu), _jax_flat(jx, js.mu)) <= MU_TOL
    assert ts.params is model and int(ts.step) == 8
    assert all(a is b and a.requires_grad for a, b in zip(
        (p for _, p in tpspec.tree_items(topt.param_tree(ts.params))),
        leaves))


def test_restore_into_refuses_another_models_checkpoint(tmp_path):
    """``checkpoint.restore_into`` copies only a checkpoint of the live
    state's own leaves and shapes; a state of another width is refused
    before it is touched."""
    from repro_torch.train import checkpoint as tckpt

    def state(cfg):
        zoo = model_zoo.get_model(cfg)
        gen = torch.Generator().manual_seed(0)
        return topt.AdamW().init(zoo.build(cfg, tpspec.init_params(
            zoo.param_defs(cfg), gen, CPU)))

    cfg = get_arch("tinyllama-1.1b").reduced()
    tckpt.save(str(tmp_path / "step_0"), state(cfg))
    wide = state(dataclasses.replace(cfg, d_ff=cfg.d_ff * 2))
    before = {n: p.clone() for n, p in
              tpspec.tree_items(topt.param_tree(wide.params))}
    with pytest.raises(ValueError, match="is .* in the checkpoint"):
        tckpt.restore_into(str(tmp_path / "step_0"), wide)
    other = state(get_arch("rwkv6-1.6b").reduced())
    with pytest.raises(ValueError, match="leaves are not the state's"):
        tckpt.restore_into(str(tmp_path / "step_0"), other)
    # the width check precedes every copy: nothing was written
    for n, p in tpspec.tree_items(topt.param_tree(wide.params)):
        assert torch.equal(p, before[n]), n


def test_train_state_from_arrays_refuses_malformed(jx):
    """The conversion takes exactly step, params, mu and nu, an int32
    scalar step and float32 moments of the parameters' shapes."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    tree = tpspec.tree_map(lambda t: t.numpy(), tpspec.init_params(
        zoo.param_defs(cfg), gen, CPU))
    zeros = tpspec.tree_map(np.zeros_like, tree)
    good = {"step": np.int32(4), "params": tree, "mu": zeros, "nu": zeros}
    state = convert.train_state_from_arrays(good, cfg=cfg, device=CPU)
    assert int(state.step) == 4 and state.step.dtype == torch.int32
    assert isinstance(state.params, model_zoo.get_model(cfg).build)
    with pytest.raises(ValueError, match="exactly step"):
        convert.train_state_from_arrays(dict(good, extra=1), cfg=cfg,
                                        device=CPU)
    with pytest.raises(ValueError, match="int32 scalar"):
        convert.train_state_from_arrays(dict(good, step=np.int64(4)),
                                        cfg=cfg, device=CPU)
    bad_mu = dict(zeros, embed=zeros["embed"][:, :4])
    with pytest.raises(ValueError, match="embed"):
        convert.train_state_from_arrays(dict(good, mu=bad_mu), cfg=cfg,
                                        device=CPU)


def test_optimizer_step_changes_what_the_cached_bf16_copies_serve():
    """``LMModule.bf16`` keys its cached copies on each parameter's
    version: after a train step the model serves the stepped weights
    (its prefill logits equal a fresh model's over the same tensors),
    not the copies cached before the step."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    model = zoo.build(cfg, tpspec.init_params(zoo.param_defs(cfg), gen, CPU))
    toks = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))}

    def logits(m):
        with torch.no_grad():
            return m(toks, mode="prefill")[0]

    before = logits(model)
    assert model._bf16                             # copies are cached
    opt = topt.AdamW(lr=1e-2)
    state = opt.init(model)
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(cfg.vocab, 2, 12, seed=0)
    state, _, _ = step(state, on_device(torch.device(CPU))(pipe.batch_at(0)))
    after = logits(model)
    fresh = zoo.build(cfg, tpspec.tree_map(
        lambda p: p.detach().clone(), topt.param_tree(model)))
    assert not torch.equal(after, before)
    assert torch.equal(after, logits(fresh))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _launch(tmp, *extra):
    return tlaunch.run(["--arch", "tinyllama-1.1b", "--reduced", "--batch",
                        "4", "--seq", "16", "--steps", "6", "--log-every",
                        "1", "--ckpt-every", "3", "--device", "cpu",
                        "--ckpt-dir", str(tmp), *extra])


def test_launcher_resumes_at_the_right_step_and_position(tmp_path, capsys):
    """Run A (6 steps, a checkpoint every 3) writes ``step_3`` and
    ``step_6``.  Run B over a directory holding only ``step_3`` resumes
    there ("resumed from ... at step 3"), replays the stream from
    ``batch_at(3)`` and runs steps 4-6: its losses equal run A's
    (``==``: one process, one CPU, the same state and batches)."""
    a = _launch(tmp_path / "x")
    assert len(a.losses) == 6 and all(np.isfinite(a.losses))
    assert sorted(os.listdir(tmp_path / "x")) == ["step_3", "step_6"]
    # as in JAX, the last step is saved again at the end
    assert [e["step"] for e in a.ckpt_log] == [3, 6, 6]
    os.makedirs(tmp_path / "y")
    shutil.copytree(tmp_path / "x" / "step_3", tmp_path / "y" / "step_3")
    capsys.readouterr()
    b = _launch(tmp_path / "y")
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'y' / 'step_3'} at step 3" in out
    assert b.start_step == 3 and int(b.state.step) == 6
    assert b.losses == a.losses[3:]
    got = dict(tpspec.tree_items(topt.param_tree(b.state.params)))
    for name, p in tpspec.tree_items(topt.param_tree(a.state.params)):
        assert torch.equal(p, got[name]), name
    # the main entry point returns the losses, as JAX's does
    assert tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced",
                         "--batch", "2", "--seq", "8", "--steps", "2",
                         "--device", "cpu"]) != []


def test_both_launchers_refuse_whisper(jx):
    """The Markov batch has no audio frames: JAX's launcher fails on its
    first step (its forward reads ``cache["enc_out"]`` with no cache),
    and the port's refuses before building the model."""
    argv = ["--arch", "whisper-medium", "--reduced", "--steps", "1",
            "--batch", "2", "--seq", "8"]
    with pytest.raises(TypeError):
        jx.jlaunch.main(argv)
    with pytest.raises(SystemExit, match="audio frames"):
        tlaunch.main(argv + ["--device", "cpu"])


# ---------------------------------------------------------------------------
# chunk_scan's kernel has no backward
# ---------------------------------------------------------------------------
def test_require_no_grad_refuses_only_under_autograd():
    """The guard on the kernel route: it raises when grad mode is on and
    an input requires grad, and passes under ``torch.no_grad()`` or when
    no input requires grad."""
    x = torch.ones(2, 3, requires_grad=True)
    y = torch.ones(2, 3)
    with pytest.raises(tops.NoBackwardError, match="no backward"):
        tops.require_no_grad("chunk_scan", y, x, None)
    tops.require_no_grad("chunk_scan", y, None)
    with torch.no_grad():
        tops.require_no_grad("chunk_scan", y, x)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_chunk_scan_kernel_refuses_autograd_on_card(card, arch):
    """On the card a loss under autograd raises ``NoBackwardError`` rather
    than leave the recurrence's inputs without a gradient; the same
    forward under ``torch.no_grad()`` still launches the kernel."""
    cfg = get_arch(arch).reduced()
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator(device=card).manual_seed(0)
    model = zoo.build(cfg, tpspec.init_params(zoo.param_defs(cfg), gen,
                                              card))
    batch = on_device(card)(TokenPipeline(cfg.vocab, 2, 32, seed=0)
                            .batch_at(0))
    with pytest.raises(tops.NoBackwardError):
        zoo.loss_fn(cfg, model, batch)
    before = cs_kernel.launches
    with torch.no_grad():
        loss = zoo.loss_fn(cfg, model, batch)
    assert cs_kernel.launches > before and torch.isfinite(loss)


@pytest.mark.gpu
def test_card_train_step_matches_cpu(card, monkeypatch):
    """Reduced tinyllama from the same parameters on the card and the CPU
    with f32 products (TF32 off): one step's loss within 1e-5 and ``mu``
    within 1e-3, as against JAX."""
    import importlib
    for name in PORT_F32:
        monkeypatch.setattr(
            importlib.import_module(f"repro_torch.models.{name}"),
            "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch("tinyllama-1.1b").reduced()
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    tree = tpspec.init_params(zoo.param_defs(cfg), gen, CPU)
    batch = TokenPipeline(cfg.vocab, 4, 16, seed=0).batch_at(0)
    out = {}
    for dev in (torch.device(CPU), card):
        opt = topt.AdamW(lr=1e-2)
        state = opt.init(zoo.build(cfg, tpspec.tree_map(
            lambda t: t.clone().to(dev), tree)))    # each steps its own copy
        state, m, _ = make_train_step(cfg, opt, TrainLoopCfg(
            microbatches=2))(state, on_device(dev)(batch))
        out[dev.type] = (float(m["loss"]), tpspec.tree_map(
            lambda t: t.cpu().numpy(), state.mu))
    (lc, mc), (lg, mg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) / abs(lc) <= LOSS_TOL
    assert _worst(_flat(mg), _flat(mc)) <= MU_TOL
