"""The port's Whisper encoder-decoder against the JAX package, on the CPU,
at ``get_arch("whisper-medium").reduced()`` (2 encoder and 2 decoder
layers, D = 64, 4 heads of 16, d_ff 128, gelu, vocab 256).

Inputs (frame embeddings: the conv frontend is a stub in both packages,
and tokens) are made with numpy from a seed and handed to both packages;
the parameters are JAX's ``init_params`` draws, carried over by
``convert.whisper_params_from_arrays``.  JAX is imported inside the
``jx`` fixture, so on the card's machine (no JAX) the ``gpu`` tests at
the end still run.

Tolerances, each with its reason:

- ``_sinusoid`` cast to bf16: equal bits (the f64-rounded power makes
  the angles XLA's; the sines and cosines differ in the last f32 bits,
  which the bf16 cast drops);
- with both packages' products in f32: the encoder output within 1e-4 x
  max |x| and the logits of ``train``, ``prefill`` (with frames) and
  ``decode`` within 0.05 x max |logit| (observed ~1e-4), against JAX's
  compiled forward;
- with bf16 products the reduced model is chaotic, as Zamba2 is (ROADMAP
  C): its random-init attention is near one-hot, and at two layers XLA's
  compiled forward lies farther than 0.05 x max |logit| from JAX's own
  op-by-op evaluation (``jax.disable_jit``).  So bf16 is held at one
  encoder and one decoder layer against JAX op by op, within 0.05 x max
  |logit| (the test prints both distances);
- ``loss_fn`` with f32 products: the loss within 1e-5 relative, each
  gradient within 1e-3 by relative norm (the bars of
  test_torch_transformer.py), at one encoder and one decoder layer, on
  one CPU thread.  Even with f32 products the model amplifies ulps: the
  port's multi-threaded CPU products change their summation order from
  one process to the next, which moved its gradients past 1e-3 at two
  layers, and at one layer in some processes; one thread makes the
  port's sums repeatable (the test prints the gaps);
- a cache from ``make_cache`` and one filled by a prefill with frames:
  equal bits (the same products in the same order).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.distributed import pspec as tpspec
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo, whisper
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

ARCH = "whisper-medium"
LOGIT_TOL = 0.05
ENC_F32_TOL = 1e-4
CPU = "cpu"
B, T_DEC, N_PRE = 2, 12, 8      # decoder tokens, of which prefilled


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules and the reduced model in both packages
    (``model(n)``: the JAX config and parameters cut to ``n`` encoder and
    ``n`` decoder layers, and the port's config and model over the same
    parameters)."""
    pytest.importorskip("jax.numpy")
    import jax
    import jax.numpy as jnp
    import repro.models.layers as JL
    import repro.models.whisper as JW
    from repro.configs import get_arch as j_get_arch
    from repro.distributed import pspec as jpspec
    from repro.models import model_zoo as jzoo
    from repro.serve import serve_step as jstep
    jcfg0 = j_get_arch(ARCH).reduced()
    jp0 = jpspec.init_params(JW.param_defs(jcfg0), jax.random.key(0))
    cache = {}

    def model(n=jcfg0.n_layers):
        if n not in cache:
            jcfg = dataclasses.replace(jcfg0, n_layers=n, enc_layers=n)
            cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=n,
                                      enc_layers=n)
            jp = dict(jp0, enc_layers=jax.tree.map(
                lambda t: t[:n], jp0["enc_layers"]),
                dec_layers=jax.tree.map(lambda t: t[:n], jp0["dec_layers"]))
            tm = convert.whisper_params_from_arrays(
                jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
            cache[n] = (jcfg, jp, cfg, tm)
        return cache[n]

    return types.SimpleNamespace(jax=jax, jnp=jnp, JL=JL, JW=JW, jzoo=jzoo,
                                 jpspec=jpspec, jstep=jstep,
                                 j_get_arch=j_get_arch, model=model)


@pytest.fixture
def f32_products(jx, monkeypatch):
    """Both packages' products in f32 (``COMPUTE_DTYPE`` patched in every
    module that reads it), for one test."""
    for mod in (jx.JL, jx.JW):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx.jnp.float32)
    for mod in (TL, whisper):
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


def _inputs(cfg, seed=3):
    """Tokens (B, 12) and frames (B, 12 x dec_ratio, D), as
    tests/test_models.py makes them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T_DEC)).astype(np.int32)
    frames = rng.normal(size=(B, T_DEC * cfg.dec_ratio, cfg.d_model)).astype(
        np.float32)
    return toks, frames


# ---------------------------------------------------------------------------
# parameters and the position table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_defs_equal_jax(jx, width):
    """``param_defs`` equal JAX's leaf for leaf (shape, logical axes, init
    rule, scale), reduced and at full width (65,536 learned decoder
    positions); the configs equal field for field; full width counts
    824,986,624 parameters (nothing allocated)."""
    cfg, jcfg = get_arch(ARCH), jx.j_get_arch(ARCH)
    if width == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    fields = [dataclasses.asdict(c) for c in (cfg, jcfg)]
    for f in fields:
        f["family"] = f["family"].value
    assert fields[0] == fields[1]
    defs = whisper.param_defs(cfg)
    jleaves = jx.jax.tree.leaves(jx.JW.param_defs(jcfg), is_leaf=lambda x:
                                 isinstance(x, jx.jpspec.ParamDef))
    assert [(d.shape, d.logical, d.init, d.scale)
            for d in tpspec.tree_leaves(defs)] == [
        (d.shape, d.logical, d.init, d.scale) for d in jleaves]
    assert defs["dec_pos"].shape == (whisper.MAX_DEC_POS, cfg.d_model)
    assert set(defs["dec_layers"]) == {"ln1", "attn", "ln_x", "xattn", "ln2",
                                       "mlp"}
    assert model_zoo.get_model(cfg).build is whisper.Whisper
    cache = whisper.init_cache(cfg, 1, 448, CPU)
    kv = (cfg.n_layers, 1, 448 // cfg.dec_ratio, cfg.n_kv_heads, cfg.head_dim)
    assert cache["self"]["k"].shape == (cfg.n_layers, 1, 448, cfg.n_kv_heads,
                                        cfg.head_dim)
    assert [t.shape for t in cache["xkv"]] == [kv, kv]
    assert cache["enc_out"].shape == (1, 448 // cfg.dec_ratio, cfg.d_model)
    assert cache["len"] == cache["self"]["len"] == 0
    if width == "full":
        assert cfg.param_count() == jx.jzoo.param_count(jcfg) == 824_986_624


def test_converted_parameters_hold_jax_bits(jx):
    """Every parameter of the converted model holds JAX's array bit for
    bit under JAX's dotted name; the conversion refuses a tree without
    the cross-attention's ``wq``."""
    jcfg, jp, cfg, model = jx.model()
    tree = jx.jax.tree.map(np.asarray, jp)
    want = dict(tpspec.tree_items(tree))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[name], name)
    dec = dict(tree["dec_layers"])
    bad = dict(tree, dec_layers=dict(dec, xattn={
        k: v for k, v in dec["xattn"].items() if k != "wq"}))
    with pytest.raises(ValueError, match="missing.*xattn.wq"):
        convert.whisper_params_from_arrays(bad, cfg=cfg, device=CPU)


@pytest.mark.parametrize("T,d", [(1500, 1024), (96, 64), (448, 512)])
def test_sinusoid_in_bf16_equals_jax(jx, T, d):
    """The encoder's position table cast to bf16 (as ``encode`` adds it)
    equals JAX's bit for bit, at whisper-medium's 1,500 frames by 1,024
    and at the reduced test shape; the f32 tables' differences are
    printed."""
    want = jx.JW._sinusoid(T, d)
    got = whisper._sinusoid(T, d)
    assert got.shape == (T, d) and got.dtype == torch.float32
    w16 = np.asarray(want.astype(jx.jnp.bfloat16)).astype(np.float32)
    g16 = got.to(torch.bfloat16).float().numpy()
    f32_diff = np.abs(got.numpy() - np.asarray(want))
    print(f"({T}, {d}): f32 elements differing {(f32_diff > 0).sum()}, "
          f"max {f32_diff.max():.3g}")
    np.testing.assert_array_equal(g16, w16)


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------
def _jax_modes(jx, jcfg, jp, toks, frames):
    zoo = jx.jzoo.get_model(jcfg)
    j = jx.jnp.asarray
    out = {"encode": jx.JW.encode(jcfg, jp, j(frames))}
    out["train"], _, _ = zoo.forward(jcfg, jp, {"tokens": j(toks),
                                                "frames": j(frames)})
    cache = zoo.init_cache(jcfg, B, T_DEC + 4)
    lg, cache, _ = zoo.forward(jcfg, jp, {"tokens": j(toks[:, :N_PRE]),
                                          "frames": j(frames)},
                               mode="prefill", cache=cache)
    out["prefill"] = lg
    for t in range(N_PRE, T_DEC):
        lg, cache, _ = zoo.forward(jcfg, jp, {"tokens": j(toks[:, t:t + 1])},
                                   mode="decode", cache=cache)
        out[f"decode{t - N_PRE}"] = lg
    return out


def _port_modes(cfg, model, toks, frames):
    out = {}
    with torch.no_grad():
        out["encode"] = model.encode(_t(frames))
        out["train"], _, _ = model({"tokens": _t(toks),
                                    "frames": _t(frames)})
        cache = whisper.init_cache(cfg, B, T_DEC + 4, CPU)
        lg, cache, _ = model({"tokens": _t(toks[:, :N_PRE]),
                              "frames": _t(frames)}, mode="prefill",
                             cache=cache)
        out["prefill"] = lg
        for t in range(N_PRE, T_DEC):
            lg, cache, _ = model({"tokens": _t(toks[:, t:t + 1])},
                                 mode="decode", cache=cache)
            out[f"decode{t - N_PRE}"] = lg
    assert cache["len"] == cache["self"]["len"] == T_DEC
    assert cache["xkv"][0].shape == (cfg.n_layers, B, T_DEC * cfg.dec_ratio,
                                     cfg.n_kv_heads, cfg.head_dim)
    return out


def _held(got, want, what):
    ratios = {k: _ratio(got[k], want[k]) for k in want}
    print(what, {k: f"{r:.3g}" for k, r in ratios.items()})
    assert ratios.pop("encode") <= (ENC_F32_TOL if "f32" in what
                                    else LOGIT_TOL), what
    assert max(ratios.values()) <= LOGIT_TOL, (what, ratios)


def test_forward_matches_jax_in_f32(jx, f32_products):
    """With both packages' products in f32, the reduced model: the
    encoder output within 1e-4 x max |x|, and the logits of ``train``, a
    ``prefill`` of 8 tokens with frames (the cross K/V computed once for
    every layer) and four ``decode`` steps from the cache within 0.05 x
    max |logit| of JAX's compiled forward."""
    jcfg, jp, cfg, model = jx.model()
    toks, frames = _inputs(cfg)
    _held(_port_modes(cfg, model, toks, frames),
          _jax_modes(jx, jcfg, jp, toks, frames), "f32 products:")


def test_forward_matches_jax_op_by_op_at_one_layer(jx):
    """With bf16 products, one encoder and one decoder layer: the encoder
    output and the logits of all three modes within 0.05 x max |logit|
    of JAX evaluated op by op (``jax.disable_jit``), which rounds each
    bf16 step where the port does; JAX's compiled forward and its own
    distance from the op-by-op one are printed (the reference's floor)."""
    jcfg, jp, cfg, model = jx.model(1)
    toks, frames = _inputs(cfg)
    with jx.jax.disable_jit():
        eager = _jax_modes(jx, jcfg, jp, toks, frames)
    got = _port_modes(cfg, model, toks, frames)
    compiled = _jax_modes(jx, jcfg, jp, toks, frames)
    print("port vs JAX compiled",
          {k: f"{_ratio(got[k], compiled[k]):.3g}" for k in compiled},
          "| JAX compiled vs op by op",
          {k: f"{_ratio(compiled[k], eager[k]):.3g}" for k in compiled})
    _held(got, eager, "bf16, one layer, port vs JAX op by op:")


def test_make_cache_then_decode_equals_prefill_with_frames(jx):
    """``make_cache(frames)`` then a prefill and decode steps without
    frames equal ``init_cache`` then a prefill with frames and the same
    decode steps, bit for bit (logits and every cache buffer); and JAX's
    ``make_cache`` path within 0.05 x max |logit| at one layer op by op
    (bf16)."""
    jcfg, jp, cfg, model = jx.model(1)
    toks, frames = _inputs(cfg, seed=4)
    with torch.no_grad():
        made = whisper.make_cache(cfg, model, _t(frames), T_DEC + 4)
        assert made["len"] == 0 and made["self"]["k"].dtype == torch.bfloat16
        a, ca, _ = model({"tokens": _t(toks[:, :N_PRE])}, mode="prefill",
                         cache=made)
        b, cb, _ = model({"tokens": _t(toks[:, :N_PRE]),
                          "frames": _t(frames)}, mode="prefill",
                         cache=whisper.init_cache(cfg, B, T_DEC + 4, CPU))
        outs = [(a, b)]
        for t in range(N_PRE, T_DEC):
            step = {"tokens": _t(toks[:, t:t + 1])}
            a, ca, _ = model(step, mode="decode", cache=ca)
            b, cb, _ = model(step, mode="decode", cache=cb)
            outs.append((a, b))
    for a, b in outs:
        assert torch.equal(a, b)
    for x, y in ((ca["self"]["k"], cb["self"]["k"]), (ca["xkv"][0],
                                                     cb["xkv"][0]),
                 (ca["xkv"][1], cb["xkv"][1]), (ca["enc_out"],
                                               cb["enc_out"])):
        assert torch.equal(x, y)
    zoo = jx.jzoo.get_model(jcfg)
    with jx.jax.disable_jit():
        jc = jx.JW.make_cache(jcfg, jp, jx.jnp.asarray(frames), T_DEC + 4)
        jlg, jc, _ = zoo.forward(jcfg, jp, {"tokens": jx.jnp.asarray(
            toks[:, :N_PRE])}, mode="prefill", cache=jc)
        assert _ratio(outs[0][0], jlg) <= LOGIT_TOL
        for i, t in enumerate(range(N_PRE, T_DEC)):
            jlg, jc, _ = zoo.forward(jcfg, jp, {"tokens": jx.jnp.asarray(
                toks[:, t:t + 1])}, mode="decode", cache=jc)
            assert _ratio(outs[i + 1][0], jlg) <= LOGIT_TOL, t


def _loss_batch(jx, cfg):
    toks, frames = _inputs(cfg, seed=6)
    labels = np.random.default_rng(7).integers(0, cfg.vocab, toks.shape)
    labels = labels.astype(np.int32)
    labels[0, :3] = -1
    j = jx.jnp.asarray
    return ({"tokens": j(toks), "frames": j(frames), "labels": j(labels)},
            {"tokens": _t(toks), "frames": _t(frames), "labels": _t(labels)})


def test_loss_and_gradients_match_jax_in_f32(jx, f32_products):
    """With both packages' products in f32, at one encoder and one
    decoder layer, the port on one CPU thread: the loss within 1e-5 of
    JAX's and every parameter's gradient (the encoder's, the cross
    attention's and the 65,536 learned positions' included) within 1e-3
    by relative norm."""
    jcfg, jp, cfg, _ = jx.model(1)
    model = convert.whisper_params_from_arrays(
        jx.jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    jb, tb = _loss_batch(jx, cfg)
    zoo = jx.jzoo.get_model(jcfg)
    jloss, jgrad = jx.jax.value_and_grad(
        lambda p: zoo.loss_fn(jcfg, p, jb))(jp)
    jgrads = {".".join(str(getattr(k, "key", k)) for k in path):
              np.asarray(g, np.float32) for path, g in
              jx.jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss = model_zoo.get_model(cfg).loss_fn(cfg, model, tb)
        loss.backward()
    finally:
        torch.set_num_threads(threads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    gap = abs(loss.item() - float(jloss)) / abs(float(jloss))
    gaps = {n: float(np.linalg.norm(_np(g) - jgrads[n])
                     / max(np.linalg.norm(jgrads[n]), 1e-30))
            for n, g in grads.items()}
    print(f"loss {loss.item():.6f} JAX {float(jloss):.6f} gap {gap:.3g}; "
          f"worst gradient gap {max(gaps.values()):.3g} "
          f"({max(gaps, key=gaps.get)})")
    assert np.isfinite(loss.item()) and loss.item() < 2 * np.log(
        cfg.vocab) + 2
    assert gap <= 1e-5
    assert max(gaps.values()) <= 1e-3, gaps
    for name in ("enc_layers.attn.wq", "dec_layers.xattn.wk", "dec_pos"):
        assert np.linalg.norm(jgrads[name]) > 0, name


def test_prefill_decode_matches_full_forward(jx):
    """Teacher-forced, the port alone (tests/test_models.py's case for
    the audio family): prefill(t[:8]) with frames then decode t[8], ...
    reproduce the full forward's logits (inference mode, with frames)
    within 0.05 x max |logit|."""
    *_, cfg, model = jx.model()
    toks, frames = _inputs(cfg)
    with torch.no_grad():
        full, _, _ = model({"tokens": _t(toks), "frames": _t(frames)},
                           mode="prefill")
        cache = whisper.init_cache(cfg, B, T_DEC + 4, CPU)
        lg, cache, _ = model({"tokens": _t(toks[:, :N_PRE]),
                              "frames": _t(frames)}, mode="prefill",
                             cache=cache)
        outs = [lg[:, -1]]
        for t in range(N_PRE, T_DEC):
            lg, cache, _ = model({"tokens": _t(toks[:, t:t + 1])},
                                 mode="decode", cache=cache)
            outs.append(lg[:, -1])
    for i, o in enumerate(outs[:-1]):
        assert _ratio(o, full[:, N_PRE - 1 + i]) < LOGIT_TOL, i


def test_serve_steps_match_jax_in_f32(jx, f32_products):
    """``serve_step``'s prefill (with frames) and greedy decode, JAX's
    serving path for an encoder-decoder, with f32 products: the
    next-token logits within 0.05 x max |logit| of JAX's steps, then
    three greedy decode steps giving JAX's tokens."""
    jcfg, jp, cfg, model = jx.model()
    toks, frames = _inputs(cfg, seed=8)
    j = jx.jnp.asarray
    jcache = jx.jzoo.get_model(jcfg).init_cache(jcfg, B, T_DEC + 4)
    jlg, jcache = jx.jstep.make_prefill_step(jcfg)(
        jp, {"tokens": j(toks[:, :4]), "frames": j(frames)}, jcache)
    lg, cache = make_prefill_step(cfg)(
        model, {"tokens": _t(toks[:, :4]), "frames": _t(frames)},
        whisper.init_cache(cfg, B, T_DEC + 4, CPU))
    assert lg.shape == (B, 1, cfg.vocab)
    assert _ratio(lg, jlg) <= LOGIT_TOL
    nxt = torch.argmax(lg[:, -1].float(), dim=-1)[:, None].to(torch.int32)
    jnxt = j(nxt.numpy())
    decode, jdecode = make_decode_step(cfg), jx.jstep.make_decode_step(jcfg)
    for _ in range(3):
        nxt, cache = decode(model, nxt, cache)
        jnxt, jcache = jdecode(jp, jnxt, jcache, None)
        assert nxt.tolist() == np.asarray(jnxt).tolist()
    assert cache["len"] == 4 + 3


def test_launcher_refuses_an_encoder_decoder():
    """``launch.serve`` refuses ``whisper-medium``, reduced or not, with
    JAX's reason: the batcher has no audio path."""
    from repro_torch.launch import serve
    for extra in ([], ["--no-reduced"]):
        with pytest.raises(SystemExit,
                           match="enc-dec serving requires audio frames"):
            serve.main(["--arch", ARCH, "--device", "cpu", *extra])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_logits_match_cpu(card, monkeypatch):
    """The same reduced parameters on the card and on the CPU, products
    in f32: a prefill with frames and two decode steps within 0.05 x max
    |logit|; ``make_cache`` on the card gives the prefill's logits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(ARCH).reduced()
    defs = whisper.param_defs(cfg)
    tree = tpspec.init_params(defs, torch.Generator().manual_seed(0), CPU)
    cpu_model = whisper.Whisper(cfg, tree)
    card_model = whisper.Whisper(cfg, tpspec.tree_map(lambda t: t.to(card),
                                                      tree))
    toks, frames = _inputs(cfg)
    for mod in (TL, whisper):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)

    def logits(m, dev):
        with torch.no_grad():
            cache = whisper.init_cache(cfg, B, T_DEC + 4, dev)
            lg, cache, _ = m({"tokens": _t(toks[:, :N_PRE]).to(dev),
                              "frames": _t(frames).to(dev)}, mode="prefill",
                             cache=cache)
            outs = [lg]
            for t in (N_PRE, N_PRE + 1):
                lg, cache, _ = m({"tokens": _t(toks[:, t:t + 1]).to(dev)},
                                 mode="decode", cache=cache)
                outs.append(lg)
        return torch.cat(outs, dim=1).cpu()

    assert _ratio(logits(card_model, card), logits(cpu_model, CPU)) \
        <= LOGIT_TOL
    with torch.no_grad():
        made = whisper.make_cache(cfg, card_model, _t(frames).to(card),
                                  T_DEC + 4)
        lg, _, _ = card_model({"tokens": _t(toks[:, :N_PRE]).to(card)},
                              mode="prefill", cache=made)
    assert _ratio(lg.cpu(), logits(card_model, card)[:, :N_PRE]) <= 1e-6
