"""The port's Zamba2 hybrid (Mamba2 mixers and one shared attention block)
against the JAX package, on the CPU, at ``get_arch("zamba2-2.7b").reduced()``
(4 layers, the shared block every 2, N = hd = 16, chunk 16, window 64).

Inputs are made with numpy from a seed and handed to both packages; the
parameters are JAX's ``init_params`` draws, carried over by
``convert.zamba2_params_from_arrays``.  JAX is imported inside the ``jx``
fixture, so on the card's machine (no JAX) the ``gpu`` tests at the end
still run.

Tolerances, each with its reason:

- ``_causal_conv``: equal bits (the same bf16 steps in the same order);
- ``chunk_scan``: those of tests/test_kernels.py, o within
  2e-4 * max(|o|, 1) and the state within 3e-4; the two chunked forms
  (the same steps in f32) within 2e-5 * max(|x|, 1);
- the mixer and the logits: 0.05 * max |x|, the bound of
  tests/test_models.py.  Where it is held matters.  With bf16 products
  the reduced model is chaotic: its random-init shared attention is near
  one-hot (JAX's init rule gives q and k a std of ~4 at d_head 16), so
  one bf16 ulp moves whole positions, and XLA's compiled forward departs
  from JAX's own op-by-op evaluation (``jax.disable_jit``) by 0.10-0.45
  of max |logit| at the full 4 layers (ROADMAP C).  So the logits are
  held (a) with both packages' products in f32, at full depth, against
  JAX's compiled forward, and (b) with bf16 products, at one group (2
  mixers and the shared block), against JAX's op-by-op evaluation, which
  rounds where the port rounds (``test_torch_zamba2_op_by_op.py``);
- ``loss_fn`` and its gradients with f32 products: the loss within 1e-5
  relative, each gradient within 1e-3 by relative norm (the bars of
  test_torch_transformer.py).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.distributed import pspec as tpspec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import mamba2, model_zoo
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

ARCH = "zamba2-2.7b"
O_TOL, S_TOL, SAME_STEPS_TOL = 2e-4, 3e-4, 2e-5
LOGIT_TOL = 0.05
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reduced model in both packages
    (``model(n_layers)``: the first ``n_layers`` of one set of JAX
    parameters) and an f32-products switch for both packages."""
    pytest.importorskip("jax.numpy")
    import jax
    import jax.numpy as jnp
    import repro.models.layers as JL
    import repro.models.mamba2 as JM
    from repro.configs import get_arch as j_get_arch
    from repro.distributed import pspec as jpspec
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import model_zoo as jzoo
    from repro.serve.batching import ContinuousBatcher as JBatcher
    from repro.serve.batching import Request as JRequest
    from repro.serve.serve_step import make_prefill_step as j_prefill
    jcfg = j_get_arch(ARCH).reduced()
    jp = jpspec.init_params(jzoo.get_model(jcfg).param_defs(jcfg),
                            jax.random.key(0))
    cache = {}

    def model(n_layers=jcfg.n_layers):
        """(JAX cfg, JAX params, port cfg, port model) at ``n_layers``."""
        if n_layers not in cache:
            jc = dataclasses.replace(jcfg, n_layers=n_layers)
            p = dict(jp, mamba_layers=jax.tree.map(
                lambda t: t[:n_layers], jp["mamba_layers"]))
            cfg = dataclasses.replace(get_arch(ARCH).reduced(),
                                      n_layers=n_layers)
            tm = convert.zamba2_params_from_arrays(
                jax.tree.map(np.asarray, p), cfg=cfg, device=CPU)
            cache[n_layers] = (jc, p, cfg, tm)
        return cache[n_layers]

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JL=JL, JM=JM, jops=jops, jref=jref, jzoo=jzoo,
        jpspec=jpspec, j_get_arch=j_get_arch, JBatcher=JBatcher,
        JRequest=JRequest, j_prefill=j_prefill, model=model)


@pytest.fixture
def f32_products(jx, monkeypatch):
    """Both packages' products in f32 for one test (``COMPUTE_DTYPE``
    patched in each); the KV caches stay bf16 in both, as JAX's
    ``init_kv_cache`` binds its dtype at import."""
    for mod in (jx.JL, jx.JM):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx.jnp.float32)
    for mod in (TL, mamba2):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ratio(got, want) -> float:
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


def _bf16(jx, a: np.ndarray):
    """The same bf16 values in both packages (rounded once, by JAX)."""
    j = jx.jnp.asarray(a, jx.jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jx.jnp.float32))).bfloat16()


def _tokens(cfg, seed, B, T) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the mixer's parts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(jx, with_tail):
    """``_causal_conv`` on bf16 inputs, with and without a carried tail:
    the same bits as JAX's (the K taps summed from 0 in tap order, each
    step rounded to bf16), and the new tail the last K - 1 inputs."""
    rng = np.random.default_rng(1)
    B, T, C, K = 2, 7, 24, 4
    jxbc, txbc = _bf16(jx, rng.normal(size=(B, T, C)).astype(np.float32))
    jw, tw = _bf16(jx, rng.normal(size=(K, C)).astype(np.float32))
    jb, tb = _bf16(jx, rng.normal(size=(C,)).astype(np.float32))
    jtail = ttail = None
    if with_tail:
        jtail, ttail = _bf16(jx, rng.normal(size=(B, K - 1, C)).astype(
            np.float32))
    jout, jnew = jx.JM._causal_conv(jxbc, jw, jb, jtail)
    tout, tnew = mamba2._causal_conv(txbc, tw, tb, ttail)
    assert tout.dtype == torch.bfloat16 and tout.shape == (B, T, C)
    np.testing.assert_array_equal(_np(tout), _np(jout))
    if with_tail:
        assert tnew.dtype == torch.bfloat16 and tnew.shape == (B, K - 1, C)
        np.testing.assert_array_equal(_np(tnew), _np(jnew))
    else:
        assert tnew is None and jnew is None


@pytest.mark.parametrize("T,chunk,dk", [(64, 16, 16), (256, 128, 64),
                                        (300, 128, 64)])
def test_chunk_scan_gla_at_mamba2_decays(jx, T, chunk, dk):
    """``chunk_scan``'s GLA form (no bonus) at Mamba2's decays, one per
    head broadcast over the N state channels, drawn in [0.02, 0.9]: the
    port's ``ops.chunk_scan`` on the CPU (its plain chunked version,
    padded as JAX pads) against JAX's chunked reference and its Pallas
    kernel in interpret mode.  At C = 128 such decays put the chunked
    form's +-45 clip in play, and ``q_in . k_in`` overflows to inf above
    the causal mask: the output stays finite."""
    rng = np.random.default_rng(T + dk)
    B = 4
    q = rng.normal(size=(B, T, dk)).astype(np.float32)
    k = rng.normal(size=(B, T, dk)).astype(np.float32)
    v = rng.normal(size=(B, T, dk)).astype(np.float32)
    w = np.repeat(rng.uniform(0.02, 0.9, (B, T, 1)), dk, axis=2).astype(
        np.float32)
    s0 = rng.normal(size=(B, dk, dk)).astype(np.float32)
    args = (q, k, v, w, None, s0)
    ja = [None if a is None else jx.jnp.asarray(a) for a in args]
    ta = [None if a is None else _t(a) for a in args]
    port = tops.chunk_scan(*ta, chunk=chunk)
    assert bool(torch.isfinite(port[0]).all())

    def close(got, want, tol_o, tol_s, what):
        o, s, ro, rs = (_np(x) for x in (*got, *want))
        np.testing.assert_allclose(
            o, ro, rtol=0, atol=tol_o * max(float(np.abs(ro).max()), 1.0),
            err_msg=f"o: {what}")
        np.testing.assert_allclose(
            s, rs, rtol=0, atol=tol_s * max(float(np.abs(rs).max()), 1.0),
            err_msg=f"state: {what}")

    close(port, jx.jops.chunk_scan(*ja, chunk=chunk, impl="ref"),
          SAME_STEPS_TOL, SAME_STEPS_TOL, "port vs JAX chunked")
    close(port, jx.jops.chunk_scan(*ja, chunk=chunk, impl="pallas"), O_TOL,
          S_TOL, "port vs JAX Pallas (interpret)")
    if T % chunk == 0:
        close(tref.chunk_scan_chunked_ref(*ta, chunk=chunk),
              jx.jref.chunk_scan_chunked_ref(*ja, chunk=chunk),
              SAME_STEPS_TOL, SAME_STEPS_TOL, "chunked vs chunked")


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_mixer_matches_jax(jx, impl, with_state):
    """Layer 1's mixer (its residual taken off) and its new state against
    JAX ``mamba_mixer`` with its plain chunked scan and with the Pallas
    kernel in interpret mode; with a state, one carried from a first
    call, so the tail and the matrix state are read."""
    jcfg, jp, cfg, model = jx.model()
    p1 = jx.jax.tree.map(lambda t: t[1], jp["mamba_layers"])
    rng = np.random.default_rng(2)
    B, T = 2, 21
    xs = [_bf16(jx, rng.normal(size=(B, T, cfg.d_model)).astype(np.float32))
          for _ in range(2)]
    jst = tst = None
    if with_state:
        jst = jx.jax.tree.map(lambda t: t[1], jx.JM.init_cache(jcfg, B, 8)[
            "mamba"])
        tst = {n: t[1] for n, t in mamba2.init_cache(cfg, B, 8, CPU)[
            "mamba"].items()}
    ratios = {}
    for step, (jxx, txx) in enumerate(xs if with_state else xs[:1]):
        jout, jst = jx.JM.mamba_mixer(jcfg, p1, jxx, jst, impl)
        with torch.no_grad():
            tout, tst = model.mamba_layers(model, 1, txx, tst, None)
        assert tout.dtype == torch.bfloat16 and tout.shape == (B, T,
                                                               cfg.d_model)
        ratios[f"out{step}"] = _ratio(tout - txx, jout - jxx)
        if with_state:
            ratios[f"S{step}"] = _ratio(tst["S"], jst["S"])
            np.testing.assert_array_equal(_np(tst["conv"]), _np(jst["conv"]))
    print(f"impl={impl}: max |port - JAX| / max |JAX| =",
          {k: round(r, 5) for k, r in ratios.items()})
    assert max(ratios.values()) <= LOGIT_TOL, ratios


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------
def _run_modes(forward, init_cache, toks, n_pre):
    """Logits of ``train`` and of ``prefill`` over the first ``n_pre``
    tokens (into a cache of 64), then of each ``decode`` step after."""
    out = {"train": forward(toks[:, :n_pre], "train", None)[0]}
    lg, cache = forward(toks[:, :n_pre], "prefill", init_cache())
    out["prefill"] = lg
    for t in range(n_pre, toks.shape[1]):
        lg, cache = forward(toks[:, t:t + 1], "decode", cache)
        out[f"decode{t - n_pre}"] = lg
    return out


def _jax_modes(jx, jcfg, jp, toks, n_pre):
    zoo = jx.jzoo.get_model(jcfg)

    def forward(t, mode, cache):
        lg, cache, _ = zoo.forward(jcfg, jp, {"tokens": jx.jnp.asarray(t)},
                                   mode=mode, cache=cache)
        return lg, cache
    return _run_modes(forward, lambda: zoo.init_cache(jcfg, toks.shape[0],
                                                      64), toks, n_pre)


def _port_modes(cfg, model, toks, n_pre):
    def forward(t, mode, cache):
        with torch.no_grad():
            lg, cache, aux = model({"tokens": _t(t)}, mode=mode, cache=cache)
        assert lg.dtype == mamba2.COMPUTE_DTYPE and float(aux) == 0.0
        return lg, cache
    return _run_modes(forward, lambda: mamba2.init_cache(
        cfg, toks.shape[0], 64, CPU), toks, n_pre)


def test_forward_matches_jax_in_f32(jx, f32_products):
    """With both packages' products in f32, at the full reduced depth:
    ``train``, a ``prefill`` of 33 tokens (padded to 48 at the chunk of
    16) into a cache of 64 and five ``decode`` steps, each within 0.05 x
    max |logit| of JAX's compiled forward (observed below 2e-3)."""
    jcfg, jp, cfg, _ = jx.model()
    model = convert.zamba2_params_from_arrays(
        jx.jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    toks = _tokens(cfg, 3, 2, 38)
    want = _jax_modes(jx, jcfg, jp, toks, 33)
    got = _port_modes(cfg, model, toks, 33)
    ratios = {k: _ratio(got[k], want[k]) for k in want}
    print("f32 products, max |port - JAX| / max |JAX| =",
          {k: f"{r:.3g}" for k, r in ratios.items()})
    assert max(ratios.values()) <= LOGIT_TOL, ratios


def test_loss_and_gradients_match_jax_in_f32(jx, f32_products):
    """``loss_fn`` and every parameter's gradient against
    ``jax.value_and_grad`` of JAX's, both packages' products in f32: the
    loss within 1e-5, relative, and each gradient within 1e-3 by
    relative norm, the first row's first five labels masked."""
    jcfg, jp, cfg, _ = jx.model()
    model = convert.zamba2_params_from_arrays(
        jx.jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels[0, :5] = -1
    jb = {"tokens": jx.jnp.asarray(toks), "labels": jx.jnp.asarray(labels)}
    zoo = jx.jzoo.get_model(jcfg)
    jloss, jgrad = jx.jax.value_and_grad(lambda p: zoo.loss_fn(jcfg, p,
                                                               jb))(jp)
    jgrads = {".".join(str(getattr(k, "key", k)) for k in path):
              np.asarray(g, np.float32) for path, g in
              jx.jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    loss = model_zoo.get_model(cfg).loss_fn(
        cfg, model, {"tokens": _t(toks), "labels": _t(labels)})
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert np.isfinite(loss.item()) and loss.item() < 2 * np.log(
        cfg.vocab) + 2
    gap = abs(loss.item() - float(jloss)) / abs(float(jloss))
    assert set(grads) == set(jgrads)
    gaps = {n: float(np.linalg.norm(_np(g) - jgrads[n])
                     / np.linalg.norm(jgrads[n])) for n, g in grads.items()}
    print(f"loss gap {gap:.3g}; worst gradient gap "
          f"{max(gaps.values()):.3g} ({max(gaps, key=gaps.get)})")
    assert gap <= 1e-5
    assert max(gaps.values()) <= 1e-3, gaps


def test_prefill_decode_matches_full_forward(jx):
    """Teacher-forced, the port alone (tests/test_models.py's form):
    prefill(t[:k]) then decode t[k], t[k+1]... reproduce the full
    forward's logits at those positions within 0.05 x max |logit|."""
    *_, cfg, model = jx.model()
    B, T, k = 2, 12, 8
    toks = _t(_tokens(cfg, 3, B, T))
    with torch.no_grad():
        full, _, _ = model({"tokens": toks}, mode="prefill")
        cache = mamba2.init_cache(cfg, B, T + 4, CPU)
        lg, cache, _ = model({"tokens": toks[:, :k]}, mode="prefill",
                             cache=cache)
        outs = [lg[:, -1]]
        for t in range(k, T):
            lg, cache, _ = model({"tokens": toks[:, t:t + 1]},
                                 mode="decode", cache=cache)
            outs.append(lg[:, -1])
    assert cache["attn"]["len"] == T
    ratios = [_ratio(o, full[:, k - 1 + i]) for i, o in
              enumerate(outs[:-1])]
    print("prefill + decode vs full forward:", [f"{r:.3g}" for r in ratios])
    assert max(ratios) < LOGIT_TOL, ratios


def test_ssm_state_is_constant_in_context(jx):
    """tests/test_models.py's case for zamba2: the Mamba2 state's bytes do
    not depend on the context, only the shared block's KV caches grow;
    each part has JAX's bytes (JAX's per-group lengths aside)."""
    cfg, jcfg = get_arch(ARCH).reduced(), jx.j_get_arch(ARCH).reduced()
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    parts = {}
    for S in (1024, 65536):
        c = mamba2.init_cache(cfg, 1, S, CPU)
        j = jx.jax.eval_shape(lambda: jx.jzoo.get_model(jcfg).init_cache(
            jcfg, 1, S))
        jb = lambda ts: sum(int(np.prod(t.shape)) * t.dtype.itemsize
                            for t in ts)
        parts[S] = (nbytes(c["mamba"].values()),
                    nbytes((c["attn"]["k"], c["attn"]["v"])))
        assert parts[S] == (jb(j["mamba"].values()),
                            jb((j["attn"]["k"], j["attn"]["v"])))
    assert parts[1024][0] == parts[65536][0]
    b1, b2 = sum(parts[1024]), sum(parts[65536])
    assert b1 < b2 < b1 * 70


def test_window_slice_matches_the_masked_cache(jx):
    """tests/test_perf_layouts.py's ``test_windowed_decode_slice_correct``
    on the port (``attend`` on the last-``window`` slice against the
    masked whole cache, atol 1e-5, and against JAX's); then the reduced
    model's decode past 2 x window (cache 160, window 64, 100 tokens
    prefilled), where ``attention_block`` takes the slice: the logits
    equal the masked cache's (``set_window_slice(False)``) within 1e-6 of
    max |logit|."""
    rng = np.random.default_rng(2)
    B, S, H, Dh, W = 2, 96, 4, 16, 16
    cur = 70
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    ck = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    cv = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    full = TL.attend(_t(q), _t(ck), _t(cv), causal=True, q_offset=cur,
                     kv_len=cur + 1, window=W)
    start = cur + 1 - W
    sliced = TL.attend(_t(q), _t(ck[:, start:start + W]),
                       _t(cv[:, start:start + W]), causal=True,
                       q_offset=cur - start, kv_len=cur + 1 - start,
                       window=W)
    jfull = jx.JL.attend(*(jx.jnp.asarray(a) for a in (q, ck, cv)),
                         causal=True, q_offset=cur, kv_len=cur + 1, window=W)
    np.testing.assert_allclose(_np(full), _np(sliced), atol=1e-5)
    np.testing.assert_allclose(_np(sliced), _np(jfull), atol=1e-5)

    *_, cfg, model = jx.model()
    assert cfg.sliding_window == 64 and 160 > 2 * cfg.sliding_window
    toks = _t(_tokens(cfg, 9, 1, 104))

    def decode_logits():
        with torch.no_grad():
            cache = mamba2.init_cache(cfg, 1, 160, CPU)
            _, cache, _ = model({"tokens": toks[:, :100]}, mode="prefill",
                                cache=cache)
            outs = []
            for t in range(100, 104):
                lg, cache, _ = model({"tokens": toks[:, t:t + 1]},
                                     mode="decode", cache=cache)
                outs.append(lg)
        return torch.cat(outs, dim=1)

    sliced = decode_logits()
    TL.set_window_slice(False)
    try:
        masked = decode_logits()
    finally:
        TL.set_window_slice(True)
    assert _ratio(sliced, masked) <= 1e-6


def test_conversions_refuse_what_they_cannot_carry(jx):
    jcfg, jp, cfg, _ = jx.model()
    tree = jx.jax.tree.map(np.asarray, jp)
    bad = dict(tree, head=tree["head"].astype(np.float64))
    with pytest.raises(ValueError, match="head"):
        convert.zamba2_params_from_arrays(bad, cfg=cfg, device=CPU)
    with pytest.raises(ValueError, match="missing"):
        convert.zamba2_params_from_arrays(
            {k: v for k, v in tree.items() if k != "shared"}, cfg=cfg,
            device=CPU)
    jc = jx.jax.tree.map(np.asarray, jx.jzoo.get_model(jcfg).init_cache(
        jcfg, 1, 8))
    with pytest.raises(ValueError, match="need"):
        convert.zamba2_cache_from_arrays(jc, cfg=cfg, batch=2, device=CPU)
    uneven = dict(jc, attn=dict(jc["attn"], len=np.arange(
        2, dtype=np.int32)))
    with pytest.raises(ValueError, match="one length"):
        convert.zamba2_cache_from_arrays(uneven, cfg=cfg, batch=1,
                                         device=CPU)
    f32 = dict(jc, mamba=dict(jc["mamba"], conv=jc["mamba"]["conv"].astype(
        np.float32)))
    with pytest.raises(ValueError, match="need torch.bfloat16"):
        convert.zamba2_cache_from_arrays(f32, cfg=cfg, batch=1, device=CPU)
    with pytest.raises(ValueError, match="need exactly"):
        convert.zamba2_cache_from_arrays({"mamba": jc["mamba"]}, cfg=cfg,
                                         batch=1, device=CPU)


def test_full_width_param_count_equals_jax(jx):
    """zamba2-2.7b at full width, counted from the defs (nothing is
    allocated): 2,396,455,840 parameters, the port's count equal to
    ``repro.models.model_zoo.param_count``; the configs equal field for
    field and the trees' shapes, axes and init rules are JAX's."""
    cfg, jcfg = get_arch(ARCH), jx.j_get_arch(ARCH)
    fields = [dataclasses.asdict(c) for c in (cfg, jcfg)]
    for f in fields:
        f["family"] = f["family"].value
    assert fields[0] == fields[1]
    assert cfg.param_count() == jx.jzoo.param_count(jcfg) == 2_396_455_840
    assert cfg.active_param_count() == cfg.param_count()
    jdefs = jx.jax.tree.leaves(
        jx.jzoo.get_model(jcfg).param_defs(jcfg),
        is_leaf=lambda x: isinstance(x, jx.jpspec.ParamDef))
    tdefs = tpspec.tree_leaves(mamba2.param_defs(cfg))
    assert [(d.shape, d.logical, d.init, d.scale) for d in tdefs] == [
        (d.shape, d.logical, d.init, d.scale) for d in jdefs]
    assert model_zoo.get_model(cfg).build is mamba2.Zamba2


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------
def _reduced_model(device=CPU, seed=0):
    cfg = get_arch(ARCH).reduced()
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, zoo.build(cfg, tpspec.init_params(zoo.param_defs(cfg), gen,
                                                  device))


def _reference_decode(cfg, model, prompt, n_new, device=CPU):
    """Single-request greedy decode (no batching engine)."""
    cache = mamba2.init_cache(cfg, 1, 64, device)
    lg, cache = make_prefill_step(cfg)(
        model, {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                       device=device)}, cache)
    out = [int(torch.argmax(lg[0, -1]))]
    decode = make_decode_step(cfg)
    for _ in range(n_new - 1):
        nxt, cache = decode(model, torch.tensor(
            [[out[-1]]], dtype=torch.int32, device=device), cache)
        out.append(int(nxt[0, 0]))
    return out


def test_slot_isolation_outputs_match_reference():
    """Requests through the shared slot pool give the tokens of isolated
    single-request decoding; slots are reused."""
    cfg, model = _reduced_model()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (6, 17, 3)]
    eng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=CPU)
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in
            enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats.completed == 3 and max(stats.slot_occupancy) <= 2
    for r in reqs:
        assert r.out == _reference_decode(cfg, model, r.prompt, 5), r.rid


def test_batcher_tokens_match_jax_batcher(jx, f32_products):
    """Greedy tokens of the port's batcher equal the JAX batcher's on the
    same weights, both packages' products in f32 (with bf16 products the
    reduced model is chaotic, see the module note).  A step whose JAX
    top-2 logit gap is below 0.05 x max |logit| could go either way: from
    that step on the request is no longer compared."""
    jcfg, jp, cfg, _ = jx.model()
    model = convert.zamba2_params_from_arrays(
        jx.jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    jnp = jx.jnp
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 17, 40)]
    n_new = 6
    jeng = jx.JBatcher(jcfg, jp, slots=2, max_len=64)
    teng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=CPU)
    jreqs = [jx.JRequest(rid=i, prompt=p, max_new=n_new)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new=n_new)
             for i, p in enumerate(prompts)]
    for a, b in zip(jreqs, treqs):
        jeng.submit(a)
        teng.submit(b)
    jeng.run_until_drained()
    teng.run_until_drained()
    zoo = jx.jzoo.get_model(jcfg)
    jdecode = jx.jax.jit(lambda p, t, c: zoo.forward(
        jcfg, p, {"tokens": t}, mode="decode", cache=c)[:2])
    compared = 0
    for a, b in zip(jreqs, treqs):
        # JAX's isolated greedy decode, its prefill the batcher's own
        cache = zoo.init_cache(jcfg, 1, 64)
        lg, cache = jeng.prefill(jp, {"tokens": jnp.asarray(
            [a.prompt], jnp.int32)}, cache)
        steps = [np.asarray(lg[0, -1], np.float32)]
        for _ in range(n_new - 1):
            lg, cache = jdecode(jp, jnp.asarray(
                [[int(np.argmax(steps[-1]))]], jnp.int32), cache)
            steps.append(np.asarray(lg[0, -1], np.float32))
        assert a.out == [int(np.argmax(s)) for s in steps]
        assert len(b.out) == n_new
        for step, (x, y) in enumerate(zip(a.out, b.out)):
            s = np.sort(steps[step])
            if s[-1] - s[-2] < LOGIT_TOL * float(np.abs(steps[step]).max()):
                break
            assert x == y, (a.rid, step, a.out, b.out)
            compared += 1
    print(f"greedy tokens compared: {compared} of {n_new * len(prompts)}")
    assert compared >= len(prompts)


def test_launch_serve_cli_completes_on_cpu(capsys):
    from repro_torch.launch import serve
    stats = serve.main(["--arch", ARCH, "--slots", "2", "--requests", "3",
                        "--max-new", "4", "--device", "cpu"])
    assert stats.completed == 3 and max(stats.slot_occupancy) <= 2
    assert "completed 3/3 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_on_reduced_model_on_card(card):
    """Reduced Zamba2 on the card: every layer's ``chunk_scan`` call of a
    prefill (T = 37, padded to 48) and of a decode step runs the kernel
    (one launch a layer) and equals the plain chunked version on that
    call's inputs within tests/test_kernels.py's bounds; the kernel-route
    logits are finite."""
    from repro_torch.kernels import chunk_scan as cs
    cfg, model = _reduced_model(device=card)
    real = tops.chunk_scan
    errs = []

    def beside(*a, **kw):
        got = real(*a, **kw)
        want = real(*a, **dict(kw, impl="ref"))
        scale = max(float(want[0].abs().max()), 1.0)
        errs.append((float((got[0] - want[0]).abs().max()) / scale,
                     float((got[1] - want[1]).abs().max())))
        return got

    toks = torch.tensor(_tokens(cfg, 5, 1, 38), device=card)
    cs.launches = 0
    tops.chunk_scan = beside
    try:
        with torch.no_grad():
            cache = mamba2.init_cache(cfg, 1, 64, card)
            lg, cache, _ = model({"tokens": toks[:, :37]}, mode="prefill",
                                 cache=cache)
            lg2, cache, _ = model({"tokens": toks[:, 37:]}, mode="decode",
                                  cache=cache)
    finally:
        tops.chunk_scan = real
    torch.cuda.synchronize()
    assert cs.launches == 2 * cfg.n_layers and len(errs) == 2 * cfg.n_layers
    assert all(eo <= O_TOL and es <= S_TOL for eo, es in errs), errs
    assert bool(torch.isfinite(lg.float()).all())
    assert bool(torch.isfinite(lg2.float()).all())


@pytest.mark.gpu
def test_batcher_tokens_equal_isolated_decode_on_card(card):
    """Reduced Zamba2 on the card: the batcher's tokens equal an isolated
    batch-1 prefill and decode on the card."""
    cfg, model = _reduced_model(device=card)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (6, 11, 30)]
    eng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=card)
    reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in
            enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats.completed == 3 and max(stats.slot_occupancy) <= 2
    for r in reqs:
        assert r.out == _reference_decode(cfg, model, r.prompt, 6,
                                          device=card), r.rid
