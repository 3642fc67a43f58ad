"""The port's Multi-head Latent Attention and the MLA transformer against
the JAX package, on the CPU, at ``get_arch("deepseek-v2-236b").reduced()``
(2 layers: one dense lead layer and one MoE layer of 8 routed experts,
top-2, one shared expert; 4 heads; q_lora 32, kv_lora 16, qk_nope 16,
qk_rope 8, v_head 16).

Inputs are made with numpy from a seed and handed to both packages; the
parameters are JAX's ``init_params`` draws, carried over by
``convert.transformer_params_from_arrays``.  JAX is imported inside the
``jx`` fixture, so on the card's machine (no JAX) the ``gpu`` tests at
the end still run.

Tolerances, each with its reason:

- ``mla_attention`` in each of its three forms (direct without a cache,
  cached direct, absorbed): with both packages' products in f32, within
  1e-5 x max |o| (the same algebra in f32, summed in another order); in
  bf16 within 0.01 x max |o|, the bound of
  tests/test_models.py::test_mla_absorbed_equals_direct (observed equal
  bits: the port rounds to bf16 where XLA does);
- the absorbed form against the cached direct form: 0.01 x max |o|, the
  same test's bound (bf16 rounding in another association);
- logits: 0.05 x max |logit|, the bound of tests/test_models.py, at f32
  products and at bf16 products against JAX's compiled forward (the
  reduced MLA model is not chaotic in bf16: observed 0.015);
- ``loss_fn`` with f32 products: the loss within 1e-5 relative, each
  gradient within 1e-3 by relative norm (the bars of
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
from repro_torch.models import layers as TL
from repro_torch.models import mla, model_zoo, moe, transformer
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

ARCH = "deepseek-v2-236b"
F32_TOL, BF16_TOL = 1e-5, 0.01      # x max |o| of an MLA layer
LOGIT_TOL = 0.05
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules and the reduced model in both packages
    (JAX config, zoo and parameters; the port's config and model over
    the same parameters)."""
    pytest.importorskip("jax.numpy")
    import jax
    import jax.numpy as jnp
    import repro.models.layers as JL
    import repro.models.mla as JMLA
    import repro.models.moe as JMoE
    import repro.models.transformer as JT
    from repro.configs import get_arch as j_get_arch
    from repro.distributed import pspec as jpspec
    from repro.models import model_zoo as jzoo
    jcfg, cfg = j_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    zoo = jzoo.get_model(jcfg)
    jp = jpspec.init_params(zoo.param_defs(jcfg), jax.random.key(0))
    model = convert.transformer_params_from_arrays(
        jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JL=JL, JMLA=JMLA, JMoE=JMoE, JT=JT, jzoo=jzoo,
        jpspec=jpspec, j_get_arch=j_get_arch, jcfg=jcfg, zoo=zoo, jp=jp,
        cfg=cfg, model=model)


@pytest.fixture
def f32_products(jx, monkeypatch):
    """Both packages' products in f32 (``COMPUTE_DTYPE`` patched in every
    module that reads it), for one test."""
    for mod in (jx.JL, jx.JMLA, jx.JT, jx.JMoE):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx.jnp.float32)
    for mod in (TL, mla, transformer, moe):
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


def _layer(jx, i=0, stack="layers"):
    """Stack ``stack``'s layer ``i`` MLA parameters in both packages."""
    p = jx.jax.tree.map(lambda t: t[i], jx.jp[stack]["attn"])
    return p, {k: _t(v) for k, v in p.items()}


def _x(cfg, seed, B, T):
    return np.random.default_rng(seed).normal(size=(B, T, cfg.d_model)).astype(
        np.float32)


def _leaves(jx, jdefs) -> list:
    return [(d.shape, d.logical, d.init, d.scale) for d in jx.jax.tree.leaves(
        jdefs, is_leaf=lambda x: isinstance(x, jx.jpspec.ParamDef))]


def _port_leaves(defs) -> list:
    return [(d.shape, d.logical, d.init, d.scale)
            for d in tpspec.tree_leaves(defs)]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_defs_equal_jax(jx, width):
    """``mla_defs`` and the MLA transformer's defs equal JAX's leaf for
    leaf (shape, logical axes, init rule, scale), reduced and at full
    width; the configs equal field for field; full width counts
    235,741,434,880 parameters, 21,375,800,320 routing-active (nothing
    allocated)."""
    cfg, jcfg = get_arch(ARCH), jx.j_get_arch(ARCH)
    if width == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    fields = [dataclasses.asdict(c) for c in (cfg, jcfg)]
    for f in fields:
        f["family"] = f["family"].value
    assert fields[0] == fields[1]
    assert _port_leaves(mla.mla_defs(cfg)) == _leaves(
        jx, jx.JMLA.mla_defs(jcfg))
    tdefs = transformer.param_defs(cfg)
    assert _port_leaves(tdefs) == _leaves(jx, jx.JT.param_defs(jcfg))
    assert all(d.dtype == torch.float32 for d in tpspec.tree_leaves(tdefs))
    assert set(tdefs) == {"embed", "layers", "lead_layers", "ln_f", "head"}
    cache = transformer.init_cache(cfg, 2, 16, CPU)
    m = cfg.mla
    for key, n in (("lead", 1), ("layers", cfg.n_layers - 1)):
        assert cache[key]["c_kv"].shape == (n, 2, 16, m.kv_lora_rank)
        assert cache[key]["k_rope"].shape == (n, 2, 16, 1, m.qk_rope_dim)
        assert cache[key]["c_kv"].dtype == torch.bfloat16
        assert cache[key]["len"] == 0
    if width == "full":
        assert cfg.param_count() == 235_741_434_880
        assert cfg.active_param_count() == 21_375_800_320


def test_converted_parameters_hold_jax_bits(jx):
    """Every parameter of the converted model holds JAX's array bit for
    bit, under JAX's dotted name; the conversion refuses a tree without
    an MLA leaf and one with an f64 leaf."""
    tree = jx.jax.tree.map(np.asarray, jx.jp)
    want = dict(tpspec.tree_items(tree))
    got = dict(jx.model.named_parameters())
    assert set(got) == set(want)
    assert {"layers.attn.wkv_a", "lead_layers.attn.q_norm",
            "layers.moe.router", "lead_layers.mlp.wg"} <= set(got)
    for name, t in got.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[name], name)
    attn = dict(tree["layers"]["attn"])
    bad = dict(tree, layers=dict(tree["layers"], attn={
        k: v for k, v in attn.items() if k != "wkv_a"}))
    with pytest.raises(ValueError, match="missing.*wkv_a"):
        convert.transformer_params_from_arrays(bad, cfg=jx.cfg, device=CPU)
    f64 = dict(tree, layers=dict(tree["layers"], attn=dict(
        attn, wk_b=attn["wk_b"].astype(np.float64))))
    with pytest.raises(ValueError, match="wk_b"):
        convert.transformer_params_from_arrays(f64, cfg=jx.cfg, device=CPU)


# ---------------------------------------------------------------------------
# mla_attention against JAX
# ---------------------------------------------------------------------------
def _forms(attend, init_cache, p, x, cfg, form):
    """``form`` on x's last 3 tokens: the direct form without a cache on
    all of x, or, after a cached direct prefill of x's first 5 tokens
    into a cache of 10, the cached direct or the absorbed form.  Returns
    (o, c_kv, k_rope) of the call under test."""
    if form == "direct":
        o, c = attend(p, x, cfg, cache=None)
        assert c is None
        return o, None, None
    _, cache = attend(p, x[:, :5], cfg, cache=init_cache(cfg, 2, 10),
                      absorbed=False)
    o, cache = attend(p, x[:, 5:], cfg, cache=cache,
                      absorbed=form == "absorbed")
    assert int(cache["len"]) == 8
    return o, cache["c_kv"], cache["k_rope"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["direct", "cached_direct", "absorbed"])
def test_mla_attention_matches_jax(jx, request, form, dtype):
    """Each form on the MoE layer's MLA parameters, in both packages:
    o within 1e-5 x max |o| with f32 products, within 0.01 x max |o| in
    bf16; the cache's latents and rope keys alike."""
    if dtype == "f32":
        request.getfixturevalue("f32_products")
    jpl, tpl = _layer(jx)
    x = _x(jx.cfg, 1, 2, 8)
    want = _forms(jx.JMLA.mla_attention, jx.JMLA.init_mla_cache, jpl,
                  jx.jnp.asarray(x), jx.jcfg, form)
    with torch.no_grad():
        got = _forms(mla.mla_attention,
                     lambda c, b, n: mla.init_mla_cache(c, b, n, device=CPU),
                     tpl, _t(x), jx.cfg, form)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    assert got[0].shape == (x.shape if form == "direct" else x[:, 5:].shape)
    assert got[0].dtype == torch.float32
    ratios = [_ratio(g, w) for g, w in zip(got, want) if w is not None]
    print(f"{form} {dtype}: o, c_kv, k_rope ratios {ratios}")
    assert max(ratios) <= tol, ratios
    if form != "direct":
        assert got[1].dtype == torch.bfloat16      # bound at import, as JAX


def test_mla_absorbed_equals_direct():
    """tests/test_models.py's case on the port: from empty caches, the
    absorbed form equals the cached direct form within 0.01 x max |o|."""
    cfg = get_arch(ARCH).reduced()
    params = tpspec.init_params(mla.mla_defs(cfg),
                                torch.Generator().manual_seed(1), CPU)
    x = _t(np.random.default_rng(0).normal(size=(2, 6, cfg.d_model))
           .astype(np.float32))
    with torch.no_grad():
        o1, _ = mla.mla_attention(params, x, cfg, absorbed=True,
                                  cache=mla.init_mla_cache(cfg, 2, 8))
        o2, _ = mla.mla_attention(params, x, cfg, absorbed=False,
                                  cache=mla.init_mla_cache(cfg, 2, 8))
    scale = float(o2.abs().max())
    np.testing.assert_allclose(_np(o1), _np(o2), atol=0.01 * scale)


def test_a_write_past_the_cache_end_raises(jx):
    """A cache of 8 positions holding 6 refuses 3 more, in
    ``mla_attention`` and through the model (JAX would clamp the start
    and overwrite earlier positions, ROADMAP C); nothing is written."""
    _, tpl = _layer(jx)
    cfg = jx.cfg
    x = _t(_x(cfg, 2, 1, 9))
    with torch.no_grad():
        _, cache = mla.mla_attention(tpl, x[:, :6], cfg, absorbed=False,
                                     cache=mla.init_mla_cache(cfg, 1, 8))
        before = cache["c_kv"].clone()
        with pytest.raises(ValueError, match="holds 8 positions; 6 are"):
            mla.mla_attention(tpl, x[:, 6:], cfg, cache=cache)
        assert torch.equal(cache["c_kv"], before)
        tc = transformer.init_cache(cfg, 1, 4, CPU)
        toks = torch.zeros((1, 3), dtype=torch.int32)
        _, tc, _ = jx.model({"tokens": toks}, mode="prefill", cache=tc)
        with pytest.raises(ValueError, match="MLA cache holds 4"):
            jx.model({"tokens": toks[:, :2]}, mode="decode", cache=tc)


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------
def _modes(forward, init_cache, toks, n_pre):
    """Logits of ``train`` and ``prefill`` over the first ``n_pre`` tokens
    (into a cache of 32), then of each ``decode`` step."""
    out = {"train": forward(toks[:, :n_pre], "train", None)[0]}
    lg, cache = forward(toks[:, :n_pre], "prefill", init_cache())
    out["prefill"] = lg
    for t in range(n_pre, toks.shape[1]):
        lg, cache = forward(toks[:, t:t + 1], "decode", cache)
        out[f"decode{t - n_pre}"] = lg
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_jax(jx, request, dtype):
    """The reduced model (MLA, the dense lead layer and the MoE layer):
    ``train`` (capacity dropping), a dropless ``prefill`` of 20 tokens
    into a cache of 32 (MLA's cached direct form) and four ``decode``
    steps (the absorbed form): logits within 0.05 x max |logit| of
    JAX's compiled forward, with both packages' products in f32 and in
    bf16."""
    if dtype == "f32":
        request.getfixturevalue("f32_products")
    toks = np.random.default_rng(5).integers(0, jx.cfg.vocab, (2, 24)).astype(
        np.int32)

    def jforward(t, mode, cache):
        lg, cache, _ = jx.zoo.forward(jx.jcfg, jx.jp, {
            "tokens": jx.jnp.asarray(t)}, mode=mode, cache=cache)
        return lg, cache

    def tforward(t, mode, cache):
        with torch.no_grad():
            lg, cache, _ = jx.model({"tokens": _t(t)}, mode=mode,
                                    cache=cache)
        return lg, cache

    want = _modes(jforward, lambda: jx.zoo.init_cache(jx.jcfg, 2, 32), toks,
                  20)
    got = _modes(tforward, lambda: transformer.init_cache(jx.cfg, 2, 32, CPU),
                 toks, 20)
    ratios = {k: _ratio(got[k], want[k]) for k in want}
    print(f"{dtype}: max |port - JAX| / max |JAX| =",
          {k: f"{r:.3g}" for k, r in ratios.items()})
    assert max(ratios.values()) <= LOGIT_TOL, ratios


def _loss_batch(jx):
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jx.cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, jx.cfg.vocab, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    return ({"tokens": jx.jnp.asarray(toks), "labels": jx.jnp.asarray(labels)},
            {"tokens": _t(toks), "labels": _t(labels)})


def test_loss_and_gradients_match_jax_in_f32(jx, f32_products):
    """With both packages' products in f32: the loss (cross-entropy and
    the router's aux term) within 1e-5 of JAX's and every parameter's
    gradient, MLA's latents and norms included, within 1e-3 by relative
    norm."""
    model = convert.transformer_params_from_arrays(
        jx.jax.tree.map(np.asarray, jx.jp), cfg=jx.cfg, device=CPU)
    jb, tb = _loss_batch(jx)
    jloss, jgrad = jx.jax.value_and_grad(
        lambda p: jx.zoo.loss_fn(jx.jcfg, p, jb))(jx.jp)
    jgrads = {".".join(str(getattr(k, "key", k)) for k in path):
              np.asarray(g, np.float32) for path, g in
              jx.jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    loss = transformer.loss_fn(jx.cfg, model, tb)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    gap = abs(loss.item() - float(jloss)) / abs(float(jloss))
    gaps = {n: float(np.linalg.norm(_np(g) - jgrads[n])
                     / max(np.linalg.norm(jgrads[n]), 1e-30))
            for n, g in grads.items()}
    print(f"loss gap {gap:.3g}; worst gradient gap "
          f"{max(gaps.values()):.3g} ({max(gaps, key=gaps.get)})")
    assert gap <= 1e-5
    assert max(gaps.values()) <= 1e-3, gaps
    assert np.linalg.norm(jgrads["layers.attn.wkv_a"]) > 0


def test_prefill_decode_matches_full_forward(jx):
    """Teacher-forced, the port alone (tests/test_models.py's form, the
    full forward in inference mode): prefill(t[:8]) then decode t[8],
    t[9], ... reproduce the full forward's logits within 0.05 x max
    |logit|; the cache's one host length counts every token."""
    cfg, model = jx.cfg, jx.model
    B, T, k = 2, 12, 8
    toks = _t(np.random.default_rng(3).integers(0, cfg.vocab, (B, T))
              .astype(np.int32))
    with torch.no_grad():
        full, _, _ = model({"tokens": toks}, mode="prefill")
        cache = transformer.init_cache(cfg, B, T + 4, CPU)
        lg, cache, _ = model({"tokens": toks[:, :k]}, mode="prefill",
                             cache=cache)
        outs = [lg[:, -1]]
        for t in range(k, T):
            lg, cache, _ = model({"tokens": toks[:, t:t + 1]},
                                 mode="decode", cache=cache)
            outs.append(lg[:, -1])
    for i, o in enumerate(outs[:-1]):
        assert _ratio(o, full[:, k - 1 + i]) < LOGIT_TOL, i
    assert set(cache) == {"layers", "lead"}
    assert cache["layers"]["len"] == cache["lead"]["len"] == T
    assert cache["lead"]["k_rope"].shape == (1, B, T + 4, 1,
                                             cfg.mla.qk_rope_dim)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _reduced_model(device=CPU, seed=0):
    cfg = get_arch(ARCH).reduced()
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, zoo.build(cfg, tpspec.init_params(zoo.param_defs(cfg), gen,
                                                  device))


def _reference_decode(cfg, model, prompt, n_new, device=CPU):
    """Single-request greedy decode (no batching engine)."""
    cache = transformer.init_cache(cfg, 1, 64, device)
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


def _served(cfg, model, prompts, device=CPU):
    eng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=device)
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in
            enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats.completed == len(prompts) and max(stats.slot_occupancy) <= 2
    return reqs


def test_batcher_tokens_equal_isolated_decode():
    """Requests through the shared slot pool (each slot's latent cache)
    give the tokens of isolated single-request decoding."""
    cfg, model = _reduced_model()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (6, 17, 3)]
    for r in _served(cfg, model, prompts):
        assert r.out == _reference_decode(cfg, model, r.prompt, 5), r.rid


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
def test_batcher_tokens_equal_isolated_decode_on_card(card):
    """The reduced MLA model on the card: the batcher's tokens equal an
    isolated batch-1 prefill and decode on the card."""
    cfg, model = _reduced_model(device=card)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (6, 11, 30)]
    for r in _served(cfg, model, prompts, device=card):
        assert r.out == _reference_decode(cfg, model, r.prompt, 5,
                                          device=card), r.rid


@pytest.mark.gpu
def test_card_logits_match_cpu(card, monkeypatch):
    """The same reduced parameters on the card and on the CPU, products
    in f32: prefill (cached direct) and decode (absorbed) logits within
    0.05 x max |logit|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu_model = _reduced_model()
    card_model = transformer.Transformer(cfg, tpspec.tree_map(
        lambda t: t.to(card), _tree(cpu_model)))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 21)).astype(np.int32))
    for mod in (TL, mla, transformer, moe):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)

    def logits(m, dev):
        with torch.no_grad():
            cache = transformer.init_cache(cfg, 2, 48, dev)
            lg, cache, _ = m({"tokens": toks[:, :20].to(dev)},
                             mode="prefill", cache=cache)
            lg2, _, _ = m({"tokens": toks[:, 20:].to(dev)}, mode="decode",
                          cache=cache)
        return torch.cat([lg, lg2], dim=1).cpu()

    assert _ratio(logits(card_model, card), logits(cpu_model, CPU)) \
        <= LOGIT_TOL


def _tree(model) -> dict:
    tree: dict = {}
    for name, p in model.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.data
    return tree
