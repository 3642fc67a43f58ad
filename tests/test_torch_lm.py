"""The port's LM slice (RWKV6 serving) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
parameters are JAX's ``init_params`` draws, carried over by
``convert.rwkv_params_from_arrays``.  The JAX side runs its plain
versions and its Pallas ``chunk_scan`` kernel in interpret mode; the port
runs its plain PyTorch versions (the CUDA kernel is held against those
same plain versions on the card, in ``test_torch_package.py`` and
``chip_smoke.py``).

Tolerances, each with its reason:

- ``chunk_scan``: those of tests/test_kernels.py, o within
  2e-4 * max(|o|, 1) and the final state within 3e-4 (f32 sums taken in
  another order); the two chunked forms, the same steps in f32 on one
  CPU, o and state each within 2e-5 * max(|x|, 1).
- RWKV6 logits: 0.05 * max |logit|, the bound of tests/test_models.py.
  Both packages round to bf16 at each product, but not at the same
  points (XLA may keep excess precision), so their logits differ by
  bf16 rounding noise, not by an algorithm.
- ``loss_fn`` and its gradients: at bf16 products the loss within 1e-3
  relative and each gradient within 0.25 by relative norm; with both
  packages' products in f32, 1e-5 and 1e-3 (each test gives the gaps it
  observed).
"""
import numpy as np
import pytest
import torch

# the JAX package is the reference; where it is not installed (the card's
# machine) only test_torch_package.py runs
jnp = pytest.importorskip("jax.numpy")

import jax  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.distributed import pspec as jpspec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.serve.batching import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.batching import Request as JRequest  # noqa: E402
from repro.serve.serve_step import make_prefill_step as j_prefill  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.distributed import pspec as tpspec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import model_zoo, rwkv  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    make_decode_step, make_prefill_step,
)

O_TOL, S_TOL, SAME_STEPS_TOL = 2e-4, 3e-4, 2e-5
LOGIT_TOL = 0.05
CPU = "cpu"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _np(x) -> np.ndarray:
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _scan_case(rng, B, T, dk, dv, bonus, lo=0.5, hi=0.999):
    q = rng.normal(size=(B, T, dk)).astype(np.float32)
    k = rng.normal(size=(B, T, dk)).astype(np.float32)
    v = rng.normal(size=(B, T, dv)).astype(np.float32)
    w = rng.uniform(lo, hi, (B, T, dk)).astype(np.float32)
    u = rng.normal(size=(B, dk)).astype(np.float32) if bonus else None
    s0 = rng.normal(size=(B, dk, dv)).astype(np.float32)
    return q, k, v, w, u, s0


def _close(got, want, tol_o, tol_s, what, state_scaled=False):
    """o within tol_o * max(|o|, 1); the state within tol_s, or within
    tol_s * max(|state|, 1) if ``state_scaled``."""
    (o, s), (o_ref, s_ref) = got, want
    o, s, o_ref, s_ref = _np(o), _np(s), _np(o_ref), _np(s_ref)
    scale = max(float(np.abs(o_ref).max()), 1.0)
    s_scale = max(float(np.abs(s_ref).max()), 1.0) if state_scaled else 1.0
    np.testing.assert_allclose(o, o_ref, rtol=0, atol=tol_o * scale,
                               err_msg=f"o: {what}")
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=tol_s * s_scale,
                               err_msg=f"state: {what}")


# ---------------------------------------------------------------------------
# chunk_scan
# ---------------------------------------------------------------------------
# the grid of tests/test_kernels.py, plus T = 1 (a decode step), T below
# the chunk (one chunk of C = T) and T no multiple of the chunk (padding)
_GRID = [(dk, dv, T, c) for dk, dv in [(16, 16), (64, 32), (64, 64)]
         for T, c in [(32, 16), (128, 64), (256, 128)]]
_EDGES = [(16, 16, 1, 128), (64, 64, 1, 128), (16, 16, 40, 64),
          (64, 32, 100, 32), (64, 64, 300, 128)]


@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("dk,dv,T,chunk", _GRID + _EDGES)
def test_chunk_scan_matches_jax(dk, dv, T, chunk, bonus):
    """The port's ``ops.chunk_scan`` on the CPU (its plain chunked
    version, padded as JAX pads) against JAX's Pallas kernel in interpret
    mode and JAX's naive recurrence; the port's two plain versions
    against JAX's."""
    rng = np.random.default_rng(dk + T + 7 * bonus)
    q, k, v, w, u, s0 = _scan_case(rng, 2, T, dk, dv, bonus)
    jx = [jnp.asarray(a) if a is not None else None
          for a in (q, k, v, w, u, s0)]
    tx = [_t(a) if a is not None else None for a in (q, k, v, w, u, s0)]
    port = tops.chunk_scan(*tx, chunk=chunk)
    pallas = jops.chunk_scan(*jx, chunk=chunk, impl="pallas")
    naive = jref.chunk_scan_ref(*jx)
    _close(port, pallas, O_TOL, S_TOL, "port vs JAX Pallas (interpret)")
    _close(port, naive, O_TOL, S_TOL, "port vs JAX naive recurrence")
    _close(tref.chunk_scan_ref(*tx), naive, O_TOL, S_TOL, "naive vs naive")
    C = min(chunk, T)
    if T % C == 0:
        _close(tref.chunk_scan_chunked_ref(*tx, chunk=C),
               jref.chunk_scan_chunked_ref(*jx, chunk=C), SAME_STEPS_TOL,
               SAME_STEPS_TOL, "chunked vs chunked", state_scaled=True)
    # and the ref route of the JAX wrapper (the same padding)
    _close(port, jops.chunk_scan(*jx, chunk=chunk, impl="ref"),
           SAME_STEPS_TOL, SAME_STEPS_TOL, "port vs JAX ops impl=ref",
           state_scaled=True)


def test_chunk_scan_pins_the_reference_clip():
    """Pins the reference's +-45 clip of the mid-chunk-centred exponents.

    At RWKV6's init decay (exp(-1) ~ 0.368) and C = 128 the clip changes
    the numbers: the chunked form is off the naive recurrence by far more
    than any rounding.  The port keeps the clip, so it equals JAX's
    chunked form, and both stay off the naive recurrence by more than 1
    (ROADMAP C)."""
    rng = np.random.default_rng(0)
    q, k, v, _, u, s0 = _scan_case(rng, 2, 256, 64, 64, True)
    w = np.full_like(q, np.float32(np.exp(-1.0)))
    jx = [jnp.asarray(a) for a in (q, k, v, w, u, s0)]
    tx = [_t(a) for a in (q, k, v, w, u, s0)]
    port = tops.chunk_scan(*tx, chunk=128)
    jax_chunked = jref.chunk_scan_chunked_ref(*jx, chunk=128)
    _close(port, jax_chunked, O_TOL, S_TOL, "port vs JAX chunked at C=128")
    _close(port, jops.chunk_scan(*jx, chunk=128, impl="pallas"), O_TOL,
           S_TOL, "port vs JAX Pallas at C=128")
    naive = _np(jref.chunk_scan_ref(*jx)[0])
    off_port = float(np.abs(_np(port[0]) - naive).max())
    off_jax = float(np.abs(_np(jax_chunked[0]) - naive).max())
    print(f"distance to the naive recurrence: port {off_port:.3g}, "
          f"JAX {off_jax:.3g}")
    assert off_port > 1.0 and off_jax > 1.0


def test_chunk_scan_state_continuity():
    """Two halves with the state carried equal one pass (the window-reuse
    property of test_kernels.py, on the port)."""
    rng = np.random.default_rng(11)
    q, k, v, w, u, _ = _scan_case(rng, 2, 128, 32, 32, True, lo=0.7)
    q, k, v, w, u = map(_t, (q, k, v, w, u))
    o_full, s_full = tops.chunk_scan(q, k, v, w, u, chunk=32)
    h = 64
    _, s1 = tops.chunk_scan(q[:, :h], k[:, :h], v[:, :h], w[:, :h], u,
                            chunk=32)
    o2, s2 = tops.chunk_scan(q[:, h:], k[:, h:], v[:, h:], w[:, h:], u,
                             state=s1, chunk=32)
    torch.testing.assert_close(o_full[:, h:], o2, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s_full, s2, rtol=2e-4, atol=2e-4)


def _tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """x (f32) cut to TF32's 10 mantissa bits: ``"trunc"`` drops the low
    13 bits, ``"rna"`` rounds half away from zero first (cvt.rna.tf32)."""
    b = x.contiguous().view(torch.int32)
    if rounding == "rna":
        b = b + 0x1000
    return (b & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b (f32) as the tensor cores take it: ``terms=3`` is the
    kernel's split TF32 (hi = a cut to TF32, lo = a - hi read as TF32,
    lo*hi + hi*lo + hi*hi), ``terms=1`` plain TF32 (hi*hi, rounded).
    TF32 products are exact; the sums are taken in f64 here, then
    rounded once to f32."""
    d = torch.float64
    if terms == 1:
        return (_tf32(a, "rna").to(d) @ _tf32(b, "rna").to(d)).float()
    ah, bh = _tf32(a, "trunc"), _tf32(b, "trunc")
    al, bl = _tf32(a - ah, "trunc"), _tf32(b - bh, "trunc")
    return (al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d)
            + ah.to(d) @ bh.to(d)).float()


def _kernel_emulation(q, k, v, w, u, s0, C: int, terms: int):
    """The kernel's arithmetic in its three-phase order (csrc/chunk_scan.cu,
    C >= 2), with each of the four products through ``_mm``: per chunk
    cum, the operands and dS_c = (k exp(total - cum))^T v; then the
    states entering each chunk, in order; then o = att v + (q exp(cum_q))
    S_in[c] + (q.u.k) v."""
    B, T, dk = q.shape
    nC = T // C
    f = lambda x: x.reshape(B, nC, C, -1)
    qc, kc, vc, wc = f(q), f(k), f(v), f(w)
    logw = torch.log(torch.clamp(wc, min=1e-38))
    cum = torch.cumsum(logw, dim=2)
    total, m = cum[:, :, -1], cum[:, :, C // 2]
    cum_q = cum if u is None else cum - logw
    q_in = qc * torch.exp(torch.clamp(cum_q - m[:, :, None], -45.0, 45.0))
    q_st = qc * torch.exp(cum_q)
    k_in = kc * torch.exp(torch.clamp(m[:, :, None] - cum, -45.0, 45.0))
    kd = kc * torch.exp(total[:, :, None] - cum)
    ds = _mm(kd.transpose(-1, -2), vc, terms)               # (B, nC, dk, dv)
    s_in, S = [], s0
    for c in range(nC):
        s_in.append(S)
        S = torch.exp(total[:, c])[:, :, None] * S + ds[:, c]
    s_in = torch.stack(s_in, dim=1)
    ones = torch.ones((C, C), dtype=torch.bool)
    mask = torch.tril(ones) if u is None else torch.tril(ones, -1)
    att = torch.where(mask, _mm(q_in, k_in.transpose(-1, -2), terms), 0.0)
    o = _mm(att, vc, terms) + _mm(q_st, s_in, terms)
    if u is not None:
        o = o + ((qc * u[:, None, None, :]) * kc).sum(-1, keepdim=True) * vc
    return o.reshape(B, T, -1), S


@pytest.mark.parametrize("decays", ["uniform", "model"])
@pytest.mark.parametrize("bonus", [False, True])
def test_split_tf32_holds_the_kernel_tolerance(bonus, decays):
    """Pins the precision of the kernel's tensor-core products: its
    arithmetic emulated on the CPU (the three-phase order, each product's
    operands split as the kernel splits them) is within the kernel
    tolerance of JAX's ``chunk_scan_chunked_ref``, and the same order with
    1xTF32 products is not.  B*H = 4, T = 512, dk = dv = 64, C = 128;
    decays U[0.5, 0.999] or exp(-exp(0.3 N)) (~0.37, RWKV6's own range).
    Observed, as error / tolerance (o against 2e-4 * max(|o|, 1), the
    state against 3e-4), over both forms and both decay regimes: split
    TF32 0.007-0.013 (o) and 0.08-0.15 (state, mostly the two f32
    summation orders); 1xTF32 1.95-2.43 (o) and 11.1-16.3 (state)."""
    rng = np.random.default_rng(5 + bonus)
    q, k, v, w, u, s0 = _scan_case(rng, 4, 512, 64, 64, bonus)
    if decays == "model":
        w = np.exp(-np.exp(0.3 * rng.normal(size=w.shape))).astype(
            np.float32)
    want = jref.chunk_scan_chunked_ref(
        *[None if a is None else jnp.asarray(a) for a in (q, k, v, w, u, s0)],
        chunk=128)
    o_ref, s_ref = _np(want[0]), _np(want[1])
    tx = [None if a is None else _t(a) for a in (q, k, v, w, u, s0)]
    ratios = {}
    for terms in (3, 1):
        o, st = map(_np, _kernel_emulation(*tx, C=128, terms=terms))
        ratios[terms] = (
            float(np.abs(o - o_ref).max())
            / (O_TOL * max(float(np.abs(o_ref).max()), 1.0)),
            float(np.abs(st - s_ref).max()) / S_TOL)
    print(f"error / tolerance (o, state): split TF32 {ratios[3]}, "
          f"1xTF32 {ratios[1]}")
    assert max(ratios[3]) <= 1.0, ratios
    assert max(ratios[1]) > 1.0, ratios


# ---------------------------------------------------------------------------
# RWKV6 at reduced size: the port against the JAX model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    """Reduced rwkv6-1.6b: JAX params, and the port's model over them."""
    jcfg = j_get_arch("rwkv6-1.6b").reduced()
    cfg = get_arch("rwkv6-1.6b").reduced()
    zoo = jzoo.get_model(jcfg)
    jp = jpspec.init_params(zoo.param_defs(jcfg), jax.random.key(0))
    model = convert.rwkv_params_from_arrays(
        jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    return jcfg, zoo, jp, cfg, model


def _ratio(got, want) -> float:
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


def _cache_ratio(tc, jc) -> dict:
    return {f"{g}.{n}": _ratio(tc[g][n], np.asarray(jc[g][n], np.float32))
            for g in ("tm", "cm") for n in tc[g]}


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_rwkv_prefill_and_decode_match_jax(lm, impl):
    """Prefill logits and cache, then four teacher-forced decode steps,
    against JAX ``rwkv.forward`` with its plain chunk_scan and with the
    Pallas kernel (interpret mode)."""
    jcfg, zoo, jp, cfg, model = lm
    rng = np.random.default_rng(3)
    B, T, n_dec = 2, 37, 4          # 37: padded to 48 at the chunk of 16
    toks = rng.integers(0, cfg.vocab, (B, T + n_dec)).astype(np.int32)
    jc = zoo.init_cache(jcfg, B, 64)
    tc = rwkv.init_cache(cfg, B, 64, CPU)
    jlg, jc, _ = zoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks[:, :T])},
                             mode="prefill", cache=jc, impl=impl)
    with torch.no_grad():
        tlg, tc, _ = model({"tokens": _t(toks[:, :T])}, mode="prefill",
                           cache=tc)
    ratios = {"prefill": _ratio(tlg, jlg), **_cache_ratio(tc, jc)}
    for t in range(T, T + n_dec):
        jlg, jc, _ = zoo.forward(jcfg, jp,
                                 {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                 mode="decode", cache=jc, impl=impl)
        with torch.no_grad():
            tlg, tc, _ = model({"tokens": _t(toks[:, t:t + 1])},
                               mode="decode", cache=tc)
        ratios[f"decode{t - T}"] = _ratio(tlg, jlg)
    print(f"impl={impl}: max |port - JAX| / max |JAX| =", {
        k: round(r, 4) for k, r in ratios.items()})
    assert tlg.shape == (B, 1, cfg.vocab) and tlg.dtype == torch.bfloat16
    assert max(ratios.values()) <= LOGIT_TOL, ratios


def test_rwkv_decodes_a_jax_prefilled_cache(lm):
    """A cache JAX prefilled, carried by ``rwkv_cache_from_arrays``, is
    decoded by the port as JAX decodes it."""
    jcfg, zoo, jp, cfg, model = lm
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (1, 24)).astype(np.int32)
    jc = zoo.init_cache(jcfg, 1, 64)
    _, jc, _ = zoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks[:, :20])},
                           mode="prefill", cache=jc, impl="ref")
    tc = convert.rwkv_cache_from_arrays(jax.tree.map(np.asarray, jc),
                                        cfg=cfg, batch=1, device=CPU)
    assert tc["tm"]["shift"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tc["tm"]["S"].numpy(),
                                  np.asarray(jc["tm"]["S"]))
    np.testing.assert_array_equal(
        tc["cm"]["shift"].float().numpy(),
        np.asarray(jc["cm"]["shift"], np.float32))
    for t in range(20, 24):
        jlg, jc, _ = zoo.forward(jcfg, jp,
                                 {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                 mode="decode", cache=jc, impl="ref")
        with torch.no_grad():
            tlg, tc, _ = model({"tokens": _t(toks[:, t:t + 1])},
                               mode="decode", cache=tc)
        assert _ratio(tlg, jlg) <= LOGIT_TOL


def test_conversions_refuse_what_they_cannot_carry(lm):
    jcfg, zoo, jp, cfg, _ = lm
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, head=tree["head"].astype(np.float64))
    with pytest.raises(ValueError, match="head"):
        convert.rwkv_params_from_arrays(bad, cfg=cfg, device=CPU)
    with pytest.raises(ValueError, match="missing"):
        convert.rwkv_params_from_arrays(
            {k: v for k, v in tree.items() if k != "ln_f"}, cfg=cfg,
            device=CPU)
    jc = jax.tree.map(np.asarray, zoo.init_cache(jcfg, 1, 8))
    with pytest.raises(ValueError, match="need"):
        convert.rwkv_cache_from_arrays(jc, cfg=cfg, batch=2, device=CPU)
    off = dict(jc, cm={"shift": np.zeros((cfg.n_layers, 1, cfg.d_model),
                                         np.float32)})
    with pytest.raises(ValueError, match="need torch.bfloat16"):
        convert.rwkv_cache_from_arrays(off, cfg=cfg, batch=1, device=CPU)


def _loss_and_grads(jcfg, zoo, jp, cfg, model):
    """JAX's ``loss_fn`` value and gradient tree, and the port's, on one
    seeded batch whose first row masks its first five labels."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels[0, :5] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrad = jax.value_and_grad(lambda p: zoo.loss_fn(jcfg, p, jb))(jp)
    jgrads = {".".join(str(getattr(key, "key", key)) for key in path):
              np.asarray(g, np.float32)
              for path, g in jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    model.zero_grad()
    loss = model_zoo.get_model(cfg).loss_fn(
        cfg, model, {"tokens": _t(toks), "labels": _t(labels)})
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(jloss), jgrads, loss.item(), grads


def _check_loss_and_grads(jloss, jgrads, value, grads, loss_tol, grad_tol,
                          vocab):
    assert np.isfinite(value) and value < 2 * np.log(vocab) + 2
    loss_gap = abs(value - jloss) / abs(jloss)
    assert set(grads) == set(jgrads)
    gaps = {}
    for name, g in grads.items():
        assert g is not None and bool(torch.isfinite(g).all()), name
        want = jgrads[name]
        gaps[name] = float(np.linalg.norm(_np(g) - want)
                           / np.linalg.norm(want))
    worst = max(gaps, key=gaps.get)
    print(f"loss gap {loss_gap:.3g}; worst gradient gap {gaps[worst]:.3g} "
          f"({worst})")
    assert loss_gap <= loss_tol, (value, jloss)
    assert gaps[worst] <= grad_tol, gaps


def test_rwkv_loss_and_gradients_match_jax(lm):
    """``loss_fn`` and every parameter's gradient against JAX's
    (``jax.value_and_grad``), both at their bf16 products.  The loss
    within 1e-3 of JAX's, relative (observed 1.7e-4); each gradient
    within 0.25 of JAX's by the norm of the difference over JAX's norm
    (observed at most 0.17): bf16 rounding at different points in the
    backward, which a wrong label shift, mask or reduction exceeds many
    times (the f32 case below holds the same algebra to 1e-3)."""
    jcfg, zoo, jp, cfg, model = lm
    _check_loss_and_grads(*_loss_and_grads(jcfg, zoo, jp, cfg, model),
                          loss_tol=1e-3, grad_tol=0.25, vocab=cfg.vocab)


def test_rwkv_loss_and_gradients_match_jax_in_f32(lm, monkeypatch):
    """The same with both packages' products in f32 (``COMPUTE_DTYPE``
    patched in each for this test only), so no bf16 rounding separates
    them: the loss within 1e-5 of JAX's, relative (observed 7.5e-8), and
    each gradient within 1e-3 by relative norm (observed at most 2.7e-5).
    This holds the port's cross-entropy, label shift, mask and every
    backward path to JAX's."""
    import repro.models.layers as jlayers
    import repro.models.rwkv as jrwkv
    from repro_torch.models import layers as tlayers
    jcfg, zoo, jp, cfg, _ = lm
    for mod in (jlayers, jrwkv):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tlayers, rwkv):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    model = convert.rwkv_params_from_arrays(
        jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    _check_loss_and_grads(*_loss_and_grads(jcfg, zoo, jp, cfg, model),
                          loss_tol=1e-5, grad_tol=1e-3, vocab=cfg.vocab)


# ---------------------------------------------------------------------------
# the port alone (ports of the RWKV cases of tests/test_models.py)
# ---------------------------------------------------------------------------
def test_prefill_decode_matches_full_forward(lm):
    """Teacher-forced: prefill(t[:k]) then decode t[k], t[k+1]... must
    reproduce the full forward's logits at those positions."""
    *_, cfg, model = lm
    B, T, k = 2, 12, 8
    toks = _t(np.random.default_rng(3).integers(0, cfg.vocab, (B, T))
              .astype(np.int32))
    with torch.no_grad():
        full, _, _ = model({"tokens": toks}, mode="prefill")
        cache = rwkv.init_cache(cfg, B, T + 4, CPU)
        lg, cache, _ = model({"tokens": toks[:, :k]}, mode="prefill",
                             cache=cache)
        outs = [lg[:, -1]]
        for t in range(k, T):
            lg, cache, _ = model({"tokens": toks[:, t:t + 1]},
                                 mode="decode", cache=cache)
            outs.append(lg[:, -1])
    for i, o in enumerate(outs[:-1]):
        assert _ratio(o, full[:, k - 1 + i]) < LOGIT_TOL, i


def test_state_is_constant_in_context():
    cfg = get_arch("rwkv6-1.6b").reduced()
    nbytes = lambda c: sum(t.numel() * t.element_size()
                           for g in c.values() for t in g.values())
    assert nbytes(rwkv.init_cache(cfg, 1, 1024, CPU)) == nbytes(
        rwkv.init_cache(cfg, 1, 65536, CPU))


def test_full_width_param_count_equals_jax():
    """rwkv6-1.6b at full width, counted from the defs (nothing is
    allocated): the port's count equals JAX's, and the tree the same."""
    cfg = get_arch("rwkv6-1.6b")
    jcfg = j_get_arch("rwkv6-1.6b")
    assert cfg.param_count() == jcfg.param_count() == 1_599_670_272
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.ssm.chunk) == (
        24, 2048, 65536, 128)
    jdefs = jax.tree.leaves(
        jzoo.get_model(jcfg).param_defs(jcfg),
        is_leaf=lambda x: isinstance(x, jpspec.ParamDef))
    tdefs = tpspec.tree_leaves(rwkv.param_defs(cfg))
    assert [(d.shape, d.logical, d.init, d.scale) for d in tdefs] == [
        (d.shape, d.logical, d.init, d.scale) for d in jdefs]
    assert tpspec.param_bytes(rwkv.param_defs(cfg)) == jpspec.param_bytes(
        jzoo.get_model(jcfg).param_defs(jcfg))


def test_init_params_follows_the_init_rules():
    cfg = get_arch("rwkv6-1.6b").reduced()
    defs = rwkv.param_defs(cfg)
    gen = torch.Generator().manual_seed(0)
    tree = tpspec.init_params(defs, gen, CPU)
    items = dict(tpspec.tree_items(tree))
    assert torch.equal(items["ln_f"], torch.ones(cfg.d_model))
    assert torch.equal(items["layers.tm.w0"],
                       torch.zeros(cfg.n_layers, cfg.d_model))
    assert abs(float(items["embed"].std()) - 0.02) < 0.002
    assert abs(float(items["layers.tm.decay_a"].std()) - 0.01) < 0.001
    assert abs(float(items["layers.cm.wk"].std()) - cfg.d_model ** -0.5) \
        < 0.1 * cfg.d_model ** -0.5
    again = tpspec.init_params(defs, torch.Generator().manual_seed(0), CPU)
    assert all(torch.equal(a, b) for a, b in zip(
        tpspec.tree_leaves(tree), tpspec.tree_leaves(again)))


def test_registry_names_what_is_not_ported():
    """Nothing is left unported: the registry holds all ten of the JAX
    package's architectures, each equal to JAX's field for field, and
    every family builds through ``model_zoo`` (its ``build`` the
    family's module); an unknown name still raises."""
    import dataclasses

    from repro.configs import ARCHS as J_ARCHS
    from repro_torch.models import mamba2, transformer, whisper
    assert sorted(ARCHS) == sorted(J_ARCHS) and len(ARCHS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("nope")
    builds = {"ssm": rwkv.RWKV6, "hybrid": mamba2.Zamba2,
              "audio": whisper.Whisper}
    for arch in sorted(ARCHS):
        cfg, jcfg = get_arch(arch), j_get_arch(arch)
        fields = [dataclasses.asdict(c) for c in (cfg, jcfg)]
        for f in fields:
            f["family"] = f["family"].value
        assert fields[0] == fields[1], arch
        zoo = model_zoo.get_model(cfg)
        assert zoo.build is builds.get(cfg.family.value,
                                       transformer.Transformer), arch
        small = cfg.reduced()
        model = zoo.build(small, tpspec.init_params(
            zoo.param_defs(small), torch.Generator().manual_seed(0), CPU))
        assert sum(p.numel() for p in model.parameters()) \
            == model_zoo.param_count(small), arch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_equals_jax(arch):
    """The port's ``param_count`` of every registered architecture at
    full width, total and routing-active, equals JAX's (counted from the
    defs, nothing allocated)."""
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    assert model_zoo.param_count(cfg) == jzoo.param_count(jcfg)
    assert model_zoo.param_count(cfg, active_only=True) == jzoo.param_count(
        jcfg, active_only=True)
    assert cfg.param_count() == jzoo.param_count(jcfg)


# ---------------------------------------------------------------------------
# continuous batching (ports of tests/test_serving.py, and against JAX)
# ---------------------------------------------------------------------------
def _reference_decode(cfg, model, prompt, n_new):
    """Single-request greedy decode (no batching engine)."""
    zoo = model_zoo.get_model(cfg)
    cache = zoo.init_cache(cfg, 1, 64, CPU)
    lg, cache = make_prefill_step(cfg)(
        model, {"tokens": torch.tensor([prompt], dtype=torch.int32)}, cache)
    out = [int(torch.argmax(lg[0, -1]))]
    decode = make_decode_step(cfg)
    for _ in range(n_new - 1):
        nxt, cache = decode(model, torch.tensor([[out[-1]]],
                                                dtype=torch.int32), cache)
        out.append(int(nxt[0, 0]))
    return out


def test_engine_drains_and_reuses_slots(lm):
    *_, cfg, model = lm
    eng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=CPU)
    rng = np.random.default_rng(0)
    for rid in range(5):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, 5).tolist(), max_new=4))
    stats = eng.run_until_drained()
    assert stats.completed == 5 and stats.admitted == 5
    assert max(stats.slot_occupancy) <= 2     # fixed register pool
    assert stats.decode_tokens == 5 * 3


def test_slot_isolation_outputs_match_reference(lm):
    """Requests decoded through the shared slot pool produce the same
    tokens as isolated single-request decoding."""
    *_, cfg, model = lm
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 6).tolist() for _ in range(3)]
    eng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=CPU)
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    for r in reqs:
        assert r.out == _reference_decode(cfg, model, r.prompt, 5), r.rid


def _jax_greedy_gaps(jcfg, zoo, jp, prompt, n_new):
    """JAX's isolated greedy decode of one prompt: its tokens and, per
    step, the gap between its top two logits and its largest |logit|."""
    cache = zoo.init_cache(jcfg, 1, 64)
    lg, cache = j_prefill(jcfg)(jp, {"tokens": jnp.asarray([prompt],
                                                            jnp.int32)},
                                cache)
    steps = [np.asarray(lg[0, -1], np.float32)]
    for _ in range(n_new - 1):
        tok = int(np.argmax(steps[-1]))
        lg, cache, _ = zoo.forward(jcfg, jp, {"tokens": jnp.asarray(
            [[tok]], jnp.int32)}, mode="decode", cache=cache)
        steps.append(np.asarray(lg[0, -1], np.float32))
    toks = [int(np.argmax(s)) for s in steps]
    gaps = [float(np.diff(np.sort(s)[-2:])[0]) for s in steps]
    scale = [float(np.abs(s).max()) for s in steps]
    return toks, gaps, scale


def test_batcher_tokens_match_jax_batcher(lm):
    """Greedy tokens of the port's batcher equal the JAX batcher's on the
    same weights.  A step whose JAX top-2 logit gap is below the logit
    tolerance (0.05 * max |logit|) could go either way within it: from
    that step on, the request is no longer compared."""
    jcfg, zoo, jp, cfg, model = lm
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 9, 17,
                                                                   23, 40)]
    n_new = 6
    jeng = JBatcher(jcfg, jp, slots=2, max_len=64)
    teng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=CPU)
    jreqs = [JRequest(rid=i, prompt=p, max_new=n_new)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new=n_new)
             for i, p in enumerate(prompts)]
    for a, b in zip(jreqs, treqs):
        jeng.submit(a)
        teng.submit(b)
    jeng.run_until_drained()
    teng.run_until_drained()
    compared = 0
    for a, b in zip(jreqs, treqs):
        toks, gaps, scale = _jax_greedy_gaps(jcfg, zoo, jp, a.prompt, n_new)
        assert a.out == toks                     # JAX's slot isolation
        assert len(b.out) == n_new
        for step, (x, y) in enumerate(zip(a.out, b.out)):
            if gaps[step] < LOGIT_TOL * scale[step]:
                break
            assert x == y, (a.rid, step, a.out, b.out)
            compared += 1
    print(f"greedy tokens compared: {compared} of {n_new * len(prompts)}")
    assert compared >= len(prompts)


def test_launch_serve_cli_completes_on_cpu(capsys):
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "rwkv6-1.6b", "--slots", "2",
                        "--requests", "3", "--max-new", "4",
                        "--device", "cpu"])
    assert stats.completed == 3 and max(stats.slot_occupancy) <= 2
    assert "completed 3/3 requests" in capsys.readouterr().out
    with pytest.raises(SystemExit,            # JAX's launcher refuses it
                       match="enc-dec serving requires audio frames"):
        serve.main(["--arch", "whisper-medium", "--device", "cpu"])
