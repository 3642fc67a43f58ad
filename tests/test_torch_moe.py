"""The port's MoE transformer family against the JAX package, on the CPU,
at ``get_arch("qwen2-moe-a2.7b").reduced()`` (2 layers, 8 routed experts
padded to 16, top-2, one shared expert of 64).

Inputs are made with numpy from a seed and handed to both packages; the
parameters are JAX's ``init_params`` draws, carried over by
``convert.transformer_params_from_arrays``.  JAX is imported inside the
``jx`` fixture, so on the card's machine (no JAX) the ``gpu`` tests at the
end still run.

Tolerances, each with its reason:

- ``moe_ffn`` on both dispatch paths: 0.05 x max |out|, the bound of
  tests/test_models.py (observed equal: both packages round to bf16 at
  the same steps here), the aux loss within 1e-6 relative; the einsum
  path against the scatter path 0.02 x max |out|, the bound of
  tests/test_perf_layouts.py;
- logits: 0.05 x max |logit| against JAX's compiled forward (bf16
  rounding at other points: XLA fuses the compiled forward);
- ``loss_fn``: within 1e-3 relative at bf16 products; with both
  packages' products in f32 the loss within 1e-5 and each gradient
  within 1e-3 by relative norm (the bars of test_torch_transformer.py).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import MoECfg
from repro_torch.distributed import pspec as tpspec
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo, moe, transformer
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

ARCH = "qwen2-moe-a2.7b"
LOGIT_TOL = 0.05
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules and the reduced model in both packages
    (``model(first_dense_layers)``: the JAX config, zoo and parameters of
    the reduced config with that many dense lead layers, and the port's
    config and model over the same parameters)."""
    pytest.importorskip("jax.numpy")
    import jax
    import jax.numpy as jnp
    import repro.models.layers as JL
    import repro.models.moe as JMoE
    import repro.models.transformer as JT
    from repro.configs import get_arch as j_get_arch
    from repro.distributed import pspec as jpspec
    from repro.models import model_zoo as jzoo
    cache = {}

    def model(first_dense_layers=0):
        if first_dense_layers not in cache:
            jcfg, cfg = j_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
            if first_dense_layers:
                jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                    jcfg.moe, first_dense_layers=first_dense_layers,
                    d_ff_dense=128))
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, first_dense_layers=first_dense_layers,
                    d_ff_dense=128))
            zoo = jzoo.get_model(jcfg)
            jp = jpspec.init_params(zoo.param_defs(jcfg), jax.random.key(0))
            tm = convert.transformer_params_from_arrays(
                jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
            cache[first_dense_layers] = (jcfg, zoo, jp, cfg, tm)
        return cache[first_dense_layers]

    return types.SimpleNamespace(jax=jax, jnp=jnp, JL=JL, JMoE=JMoE, JT=JT,
                                 jzoo=jzoo, jpspec=jpspec,
                                 j_get_arch=j_get_arch, model=model)


@pytest.fixture
def einsum_decode(jx):
    """Sets both packages' einsum-dispatch switch; restores it after."""
    jprev, tprev = jx.JMoE._EINSUM_DECODE, moe._EINSUM_DECODE

    def set_to(v):
        jx.JMoE.set_einsum_decode(v)
        moe.set_einsum_decode(v)
    yield set_to
    jx.JMoE.set_einsum_decode(jprev)
    moe.set_einsum_decode(tprev)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ratio(got, want) -> float:
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


def _layer(jx, jp, i=0):
    """Layer ``i``'s ``moe`` parameters in both packages."""
    p = jx.jax.tree.map(lambda t: t[i], jp["layers"]["moe"])
    return p, jx.jax.tree.map(lambda a: _t(a), p)


def _x(cfg, seed, B, T):
    return np.random.default_rng(seed).normal(size=(B, T, cfg.d_model)).astype(
        np.float32)


def _dropped(p, x, m: MoECfg) -> int:
    """(token, slot) choices past their expert's capacity on the scatter
    path, by the port's routing."""
    B, T, _ = x.shape
    E = p["router"].shape[1]
    _, _, eidx = moe._route(x.to(moe.COMPUTE_DTYPE), p["router"], m, E)
    oh = torch.nn.functional.one_hot(eidx, E).to(torch.int32)
    pos = moe._positions(oh.reshape(B, T * m.top_k, E))
    C = max(int(T * m.top_k / m.n_experts * m.capacity_factor), 1)
    return int((pos >= C).sum())


# ---------------------------------------------------------------------------
# moe_ffn against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["scatter-dropless", "einsum-dropless",
                                  "scatter-dropping",
                                  "scatter-small-capacity"])
def test_moe_ffn_matches_jax(jx, einsum_decode, case):
    """``moe_ffn`` on both dispatch paths (``set_einsum_decode``) and with
    capacity dropping (``dropless=False``; then at capacity factor 0.5,
    where most choices drop), against JAX's: the output and the aux
    loss."""
    jcfg, _, jp, cfg, _ = jx.model()
    jm, m = jcfg.moe, cfg.moe
    if case == "scatter-small-capacity":
        jm = dataclasses.replace(jm, capacity_factor=0.5)
        m = dataclasses.replace(m, capacity_factor=0.5)
    jpl, tpl = _layer(jx, jp, 1)
    x = _x(cfg, 1, 2, 16)
    einsum_decode(case.startswith("einsum"))
    dropless = case.endswith("dropless")
    jo, ja = jx.JMoE.moe_ffn(jpl, jx.jnp.asarray(x), jm, dropless=dropless)
    to, ta = moe.moe_ffn(tpl, _t(x), m, dropless=dropless)
    assert to.shape == x.shape and to.dtype == torch.float32
    r = _ratio(to, jo)
    drops = 0 if dropless else _dropped(tpl, _t(x), m)
    print(f"{case}: ratio {r:.3g}, aux {float(ta):.6f} JAX {float(ja):.6f}, "
          f"dropped choices {drops}")
    assert r <= LOGIT_TOL
    assert abs(float(ta) - float(ja)) <= 1e-6 * abs(float(ja))
    if case == "scatter-small-capacity":
        assert drops > 0


def test_moe_routing_is_sparse_and_normalised(jx):
    """tests/test_models.py's case on the port: the output keeps x's shape,
    the aux loss is finite and ~1 when balanced; each token's gates are
    its top-k probabilities, renormalised to 1, on top_k distinct real
    experts."""
    jcfg, _, _, cfg, _ = jx.model()
    defs = moe.moe_defs(cfg.d_model, cfg.moe)
    params = tpspec.init_params(defs, torch.Generator().manual_seed(2), CPU)
    x = _t(_x(cfg, 0, 2, 16))
    out, aux = moe.moe_ffn(params, x, cfg.moe)
    assert out.shape == x.shape
    assert np.isfinite(float(aux)) and float(aux) > 0.5
    E = params["router"].shape[1]
    probs, gate, eidx = moe._route(x.to(moe.COMPUTE_DTYPE),
                                   params["router"], cfg.moe, E)
    torch.testing.assert_close(gate.sum(-1), torch.ones(2, 16))
    assert eidx.shape == (2, 16, cfg.moe.top_k)
    assert bool((eidx < cfg.moe.n_experts).all())
    assert bool((eidx[..., 0] != eidx[..., 1]).all())
    top = torch.sort(probs, dim=-1, descending=True).values[..., :2]
    torch.testing.assert_close(gate, top / top.sum(-1, keepdim=True))


@pytest.mark.parametrize("einsum", [False, True])
def test_moe_pad_experts_never_routed(jx, einsum_decode, einsum):
    """Qwen's 60 experts pad to 64 and DeepSeek's 160 stay (JAX's
    ``padded_experts``); pad experts are masked out of routing even when
    their router columns are the largest, on both paths."""
    assert moe.padded_experts(get_arch(ARCH).moe) == 64
    ds = jx.j_get_arch("deepseek-v2-236b").moe
    assert moe.padded_experts(MoECfg(**dataclasses.asdict(ds))) == 160
    jcfg, _, jp, cfg, _ = jx.model()
    jpl, tpl = _layer(jx, jp)
    n = cfg.moe.n_experts
    router = np.asarray(jpl["router"]).copy()
    router[:, n:] = 10.0                         # pad columns dominate
    jpl = dict(jpl, router=jx.jnp.asarray(router))
    tpl = dict(tpl, router=_t(router))
    x = _x(cfg, 3, 2, 8)
    einsum_decode(einsum)
    _, _, eidx = moe._route(_t(x).to(moe.COMPUTE_DTYPE), tpl["router"],
                            cfg.moe, router.shape[1])
    assert bool((eidx < n).all())
    jo, _ = jx.JMoE.moe_ffn(jpl, jx.jnp.asarray(x), jcfg.moe, dropless=True)
    to, _ = moe.moe_ffn(tpl, _t(x), cfg.moe, dropless=True)
    assert _ratio(to, jo) <= LOGIT_TOL


def test_moe_einsum_decode_equals_scatter_path(jx, einsum_decode):
    """tests/test_perf_layouts.py's case on the port: the einsum dispatch
    equals the dropless scatter dispatch (0.02 x max |out|), and each
    equals JAX's."""
    jcfg, _, jp, cfg, _ = jx.model()
    jpl, tpl = _layer(jx, jp)
    x = _x(cfg, 1, 2, 4)
    E = tpl["router"].shape[1]
    out_e, _ = moe._moe_decode_einsum(tpl, _t(x), cfg.moe, E)
    einsum_decode(False)
    out_s, _ = moe.moe_ffn(tpl, _t(x), cfg.moe, dropless=True)
    scale = float(out_s.abs().max())
    np.testing.assert_allclose(_np(out_e), _np(out_s), atol=0.02 * scale)
    jo_e, _ = jx.JMoE._moe_decode_einsum(jpl, jx.jnp.asarray(x), jcfg.moe, E)
    assert _ratio(out_e, jo_e) <= LOGIT_TOL


@pytest.mark.parametrize("einsum", [False, True])
def test_ties_pick_the_lower_index(jx, einsum_decode, einsum):
    """Equal router probabilities pick the lower expert index first, as
    ``jax.lax.top_k`` does, on both paths: a zero router (all experts
    tie, so experts 0..k-1 win), and two equal columns above the rest
    (the lower of the two first)."""
    jcfg, _, jp, cfg, _ = jx.model()
    jpl, tpl = _layer(jx, jp)
    E, k = tpl["router"].shape[1], cfg.moe.top_k
    x = np.abs(_x(cfg, 4, 1, 6))
    einsum_decode(einsum)
    tied = np.zeros_like(np.asarray(jpl["router"]))
    two = np.asarray(jpl["router"]).copy() * 0.01
    two[:, 5] = two[:, 3] = 1.0                  # x >= 0: columns 3, 5 win
    for router, want in ((tied, list(range(k))), (two, [3, 5])):
        _, _, eidx = moe._route(_t(x).to(moe.COMPUTE_DTYPE), _t(router),
                                cfg.moe, E)
        assert eidx.reshape(-1, k).tolist() == [want] * 6
        _, jidx = jx.jax.lax.top_k(jx.jax.nn.softmax(
            (jx.jnp.asarray(x, jx.jnp.bfloat16) @ jx.jnp.asarray(
                router, jx.jnp.bfloat16)).astype(jx.jnp.float32)), k)
        assert np.asarray(jidx).reshape(-1, k).tolist() == [want] * 6
        jo, _ = jx.JMoE.moe_ffn(dict(jpl, router=jx.jnp.asarray(router)),
                                jx.jnp.asarray(x), jcfg.moe, dropless=True)
        to, _ = moe.moe_ffn(dict(tpl, router=_t(router)), _t(x), cfg.moe,
                            dropless=True)
        assert _ratio(to, jo) <= LOGIT_TOL


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------
def _modes(forward, init_cache, toks, n_pre):
    """Logits and aux of ``train`` and ``prefill`` over the first
    ``n_pre`` tokens (into a cache of 32), then of each ``decode`` step."""
    out = {"train": forward(toks[:, :n_pre], "train", None)}
    lg, aux, cache = forward(toks[:, :n_pre], "prefill", init_cache())
    out["prefill"] = (lg, aux, cache)
    for t in range(n_pre, toks.shape[1]):
        lg, aux, cache = forward(toks[:, t:t + 1], "decode", cache)
        out[f"decode{t - n_pre}"] = (lg, aux, cache)
    return out


@pytest.mark.parametrize("lead", [0, 1])
def test_forward_matches_jax(jx, lead):
    """``train`` (capacity dropping), a dropless ``prefill`` of 20 tokens
    into a cache of 32 and four ``decode`` steps: logits within 0.05 x
    max |logit| of JAX's compiled forward, the aux loss within 1e-2; with
    ``first_dense_layers=1`` (a ``dataclasses.replace`` of the reduced
    config in both packages) the first layer is a dense ``lead_layers``
    stack with its own cache, as in JAX."""
    jcfg, zoo, jp, cfg, model = jx.model(lead)
    assert ("lead_layers" in jp) == bool(lead)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)

    def jforward(t, mode, cache):
        lg, cache, aux = zoo.forward(jcfg, jp, {"tokens": jx.jnp.asarray(t)},
                                     mode=mode, cache=cache)
        return lg, aux, cache

    def tforward(t, mode, cache):
        with torch.no_grad():
            lg, cache, aux = model({"tokens": _t(t)}, mode=mode, cache=cache)
        return lg, aux, cache

    want = _modes(jforward, lambda: zoo.init_cache(jcfg, 2, 32), toks, 20)
    got = _modes(tforward, lambda: transformer.init_cache(cfg, 2, 32, CPU),
                 toks, 20)
    ratios = {k: _ratio(got[k][0], want[k][0]) for k in want}
    print(f"lead={lead}: max |port - JAX| / max |JAX| =",
          {k: f"{r:.3g}" for k, r in ratios.items()})
    assert max(ratios.values()) <= LOGIT_TOL, ratios
    for k in want:
        assert abs(float(got[k][1]) - float(want[k][1])) <= 1e-2 * abs(
            float(want[k][1])), k
    cache = got["decode3"][2]
    assert cache["layers"]["len"] == 24 and set(cache) == (
        {"layers", "lead"} if lead else {"layers"})


def test_loss_matches_jax(jx):
    """``loss_fn`` (with the router's aux term) at bf16 products within
    1e-3 of JAX's, relative; the first row masks its first three
    labels."""
    jcfg, zoo, jp, cfg, model = jx.model()
    jb, tb = _loss_batch(jx, cfg)
    jloss = float(zoo.loss_fn(jcfg, jp, jb))
    with torch.no_grad():
        loss = float(model_zoo.get_model(cfg).loss_fn(cfg, model, tb))
    gap = abs(loss - jloss) / abs(jloss)
    print(f"loss {loss:.6f} JAX {jloss:.6f} gap {gap:.3g}")
    assert np.isfinite(loss) and loss < 2 * np.log(cfg.vocab) + 2
    assert gap <= 1e-3


def _loss_batch(jx, cfg):
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    return ({"tokens": jx.jnp.asarray(toks), "labels": jx.jnp.asarray(labels)},
            {"tokens": _t(toks), "labels": _t(labels)})


def test_loss_and_gradients_match_jax_in_f32(jx, monkeypatch):
    """With both packages' products in f32 (``COMPUTE_DTYPE`` patched in
    each for this test only): the loss (cross-entropy and the router's
    aux term) within 1e-5 of JAX's and every parameter's gradient within
    1e-3 by relative norm, the routers' and the experts' included."""
    jcfg, zoo, jp, cfg, _ = jx.model()
    for mod in (jx.JL, jx.JT, jx.JMoE):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx.jnp.float32)
    for mod in (TL, transformer, moe):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    model = convert.transformer_params_from_arrays(
        jx.jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    jb, tb = _loss_batch(jx, cfg)
    jloss, jgrad = jx.jax.value_and_grad(
        lambda p: zoo.loss_fn(jcfg, p, jb))(jp)
    jgrads = {".".join(str(getattr(k, "key", k)) for k in path):
              np.asarray(g, np.float32) for path, g in
              jx.jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    loss = transformer.loss_fn(cfg, model, tb)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    gap = abs(loss.item() - float(jloss)) / abs(float(jloss))
    assert set(grads) == set(jgrads)
    # experts no token reached have zero gradients in both packages
    gaps = {n: float(np.linalg.norm(_np(g) - jgrads[n])
                     / max(np.linalg.norm(jgrads[n]), 1e-30))
            for n, g in grads.items()}
    print(f"loss gap {gap:.3g}; worst gradient gap "
          f"{max(gaps.values()):.3g} ({max(gaps, key=gaps.get)})")
    assert gap <= 1e-5
    assert max(gaps.values()) <= 1e-3, gaps


def test_prefill_decode_matches_full_forward(jx):
    """Teacher-forced, the port alone (tests/test_models.py's form, the
    full forward in inference mode, dropless): prefill(t[:k]) then decode
    reproduce the full forward's logits within 0.05 x max |logit|."""
    *_, cfg, model = jx.model()
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


def test_full_width_param_count_equals_jax(jx):
    """qwen2-moe-a2.7b at full width, counted from the defs (nothing is
    allocated): 15,146,256,384 parameters with the padded experts, the
    routing-active count and the trees equal to JAX's; the configs equal
    field for field."""
    cfg, jcfg = get_arch(ARCH), jx.j_get_arch(ARCH)
    fields = [dataclasses.asdict(c) for c in (cfg, jcfg)]
    for f in fields:
        f["family"] = f["family"].value
    assert fields[0] == fields[1]
    assert cfg.param_count() == jx.jzoo.param_count(jcfg) == 15_146_256_384
    assert cfg.active_param_count() == jx.jzoo.param_count(
        jcfg, active_only=True)
    jdefs = jx.jax.tree.leaves(
        jx.jzoo.get_model(jcfg).param_defs(jcfg),
        is_leaf=lambda x: isinstance(x, jx.jpspec.ParamDef))
    tdefs = tpspec.tree_leaves(transformer.param_defs(cfg))
    assert [(d.shape, d.logical, d.init, d.scale) for d in tdefs] == [
        (d.shape, d.logical, d.init, d.scale) for d in jdefs]
    assert model_zoo.get_model(cfg).build is transformer.Transformer


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


def test_slot_isolation_outputs_match_reference():
    """Requests through the shared slot pool give the tokens of isolated
    single-request decoding."""
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
    """Reduced MoE on the card: the batcher's tokens equal an isolated
    batch-1 prefill and decode on the card."""
    cfg, model = _reduced_model(device=card)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (6, 11, 30)]
    for r in _served(cfg, model, prompts, device=card):
        assert r.out == _reference_decode(cfg, model, r.prompt, 5,
                                          device=card), r.rid


@pytest.mark.gpu
@pytest.mark.parametrize("einsum", [False, True])
def test_card_logits_and_ties_match_cpu(card, monkeypatch, einsum):
    """The same reduced parameters on the card and on the CPU, on each
    dispatch path: prefill logits within 0.05 x max |logit| with the
    products in f32, and on the card too equal router probabilities pick
    the lower expert index."""
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(moe, "_EINSUM_DECODE", einsum)
    cfg, cpu_model = _reduced_model()
    nested: dict = {}
    for name, p in cpu_model.named_parameters():
        node = nested
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.data.to(card)
    card_model = transformer.Transformer(cfg, nested)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))

    def logits(m, dev):
        with torch.no_grad():
            lg, _, _ = m({"tokens": toks.to(dev)}, mode="prefill",
                         cache=transformer.init_cache(cfg, 2, 48, dev))
        return lg.cpu()

    for mod in (TL, transformer, moe):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    assert _ratio(logits(card_model, card), logits(cpu_model, CPU)) \
        <= LOGIT_TOL
    router = torch.zeros(cfg.d_model, 16, device=card)
    _, _, eidx = moe._route(torch.ones(1, 5, cfg.d_model, device=card),
                            router, cfg.moe, 16)
    assert eidx.reshape(-1, cfg.moe.top_k).tolist() == [[0, 1]] * 5
