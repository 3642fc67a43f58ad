"""The port's dense/VLM transformer family against the JAX package, on the
CPU.

Inputs are made with numpy from a seed and handed to both packages; the
parameters are JAX's ``init_params`` draws, carried over by
``convert.transformer_params_from_arrays``.  JAX is imported inside the
``jx`` fixture, so on the card's machine (no JAX) the ``gpu`` tests at the
end still run.

Tolerances, each with its reason:

- attention on f32 inputs (naive and blockwise, JAX and port):
  ``atol=2e-5``, the bound of tests/test_perf_layouts.py (f32 sums taken
  in another order);
- ``rope`` on f32 inputs: 1e-5 absolute at angles up to 4,096 rad (the
  two libraries' f32 cos/sin differ in the last bits after range
  reduction); on bf16 inputs one bf16 ulp of the largest value;
- ``mlp``: 2e-2 x max |out|, a couple of bf16 ulps: both packages round
  to bf16 at each product, not at the same points;
- logits: 0.05 x max |logit|, the bound of tests/test_models.py, for the
  same reason; ``loss_fn`` within 1e-3 of JAX's, relative (the RWKV6 bar
  of tests/test_torch_lm.py).  With both packages' products patched to
  f32 the loss is held to 1e-5 and each gradient to 1e-3 by relative
  norm.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import Family, MLACfg, MoECfg
from repro_torch.distributed import pspec as tpspec
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo, transformer
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

DENSE = ["tinyllama-1.1b", "granite-3-2b", "stablelm-3b", "minitron-8b",
         "paligemma-3b"]
LOGIT_TOL = 0.05
ATTN_ATOL = 2e-5
CPU = "cpu"
MASK_CASES = [dict(causal=True, q_offset=40),
              dict(causal=True, q_offset=16, window=8),
              dict(causal=True, q_offset=0, prefix_len=4, kv_len=30),
              dict(causal=False, q_offset=0)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, and a cache of reduced models: per
    architecture the JAX config and parameters and the port's config and
    model over the same parameters."""
    pytest.importorskip("jax.numpy")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.distributed import pspec as jpspec
    from repro.models import layers as JL
    from repro.models import model_zoo as jzoo
    from repro.models import transformer as jtr
    from repro.serve.batching import ContinuousBatcher as JBatcher
    from repro.serve.batching import Request as JRequest
    from repro.serve.serve_step import make_prefill_step as j_prefill
    cache = {}

    def model(arch):
        if arch not in cache:
            jcfg = j_get_arch(arch).reduced()
            cfg = get_arch(arch).reduced()
            zoo = jzoo.get_model(jcfg)
            jp = jpspec.init_params(zoo.param_defs(jcfg), jax.random.key(0))
            tm = convert.transformer_params_from_arrays(
                jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
            cache[arch] = (jcfg, zoo, jp, cfg, tm)
        return cache[arch]

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JL=JL, jzoo=jzoo, jtr=jtr, jpspec=jpspec,
        j_get_arch=j_get_arch, JBatcher=JBatcher, JRequest=JRequest,
        j_prefill=j_prefill, model=model)


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


def _batch(jx, cfg, rng, B, T, with_labels=False):
    """One seeded batch for both packages (image embeddings for the VLM)."""
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    jb, tb = {"tokens": jx.jnp.asarray(toks)}, {"tokens": _t(toks)}
    if cfg.family == Family.VLM:
        jb["img_embeds"], tb["img_embeds"] = _bf16(jx, rng.normal(
            size=(B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    if with_labels:
        labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        labels[0, :3] = -1
        jb["labels"], tb["labels"] = jx.jnp.asarray(labels), _t(labels)
    return jb, tb


@pytest.fixture
def blockwise_min(jx):
    """Sets both packages' blockwise threshold; restores it after."""
    jprev, tprev = jx.JL._BLOCKWISE_MIN, TL._BLOCKWISE_MIN

    def set_min(n):
        jx.JL.set_blockwise_min(n)
        TL.set_blockwise_min(n)
    yield set_min
    jx.JL.set_blockwise_min(jprev)
    TL.set_blockwise_min(tprev)


# ---------------------------------------------------------------------------
# the layer library against JAX
# ---------------------------------------------------------------------------
def _qkv(seed, B=2, Tq=8, Tk=48, Hq=8, Hkv=2, Dh=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Tq, Hq, Dh)).astype(np.float32),
            rng.normal(size=(B, Tk, Hkv, Dh)).astype(np.float32),
            rng.normal(size=(B, Tk, Hkv, Dh)).astype(np.float32))


def _bw_kw(kw, Dh):
    return dict(scale=Dh ** -0.5, block=16, causal=kw.get("causal", True),
                q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"),
                prefix_len=kw.get("prefix_len", 0),
                window=kw.get("window", 0))


@pytest.mark.parametrize("form", ["naive", "blockwise", "port_pair"])
@pytest.mark.parametrize("case", range(len(MASK_CASES)))
def test_attention_matches_jax(jx, case, form):
    """``attend``'s naive path and ``_attend_blockwise`` (KV blocks of 16,
    the last one padded) against JAX's at the four mask cases of
    tests/test_perf_layouts.py, 8 query heads on 2 KV heads; and the
    port's two forms against each other."""
    kw = MASK_CASES[case]
    q, k, v = _qkv(0)
    jq, jk, jv = (jx.jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (_t(a) for a in (q, k, v))
    if form == "naive":
        got = TL.attend(tq, tk, tv, **kw)
        want = jx.JL.attend(jq, jk, jv, **kw)
    elif form == "blockwise":
        got = TL._attend_blockwise(tq, tk, tv, **_bw_kw(kw, 16))
        want = jx.JL._attend_blockwise(jq, jk, jv, **_bw_kw(kw, 16))
    else:
        got = TL._attend_blockwise(tq, tk, tv, **_bw_kw(kw, 16))
        want = TL.attend(tq, tk, tv, **kw)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_ATOL)


def test_gqa_broadcast_keeps_query_head_on_kv_head_h_div_g():
    """Query head h reads KV head h // G (``repeat_interleave``): with
    one-hot values per KV head, each query head's output names its KV
    head."""
    B, T, Hq, Hkv, Dh = 1, 3, 8, 2, 4
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, T, Hq, Dh, generator=g)
    k = torch.randn(B, T, Hkv, Dh, generator=g)
    v = torch.zeros(B, T, Hkv, Dh)
    v[:, :, 1] = 1.0                        # KV head 1 is all ones
    out = TL.attend(q, k, v, causal=True)
    heads = out[0, -1, :, 0]
    # softmax weights sum to 1 within f32 rounding
    torch.testing.assert_close(heads, torch.tensor([0.0] * 4 + [1.0] * 4),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_dispatch_and_bf16_scores_match_jax(jx, blockwise_min,
                                                      dtype):
    """``attend`` takes the blockwise path at Tk >= the threshold and
    Tq > 1, the naive one at Tq = 1, in both packages; on bf16 inputs the
    f32 scores (q, k upcast before the product) and the bf16 cast of the
    probabilities give JAX's output within one bf16 ulp."""
    q, k, v = _qkv(1, Tk=40)
    if dtype == "f32":
        jq, jk, jv = (jx.jnp.asarray(a) for a in (q, k, v))
        tq, tk, tv = (_t(a) for a in (q, k, v))
    else:
        (jq, tq), (jk, tk), (jv, tv) = (_bf16(jx, a) for a in (q, k, v))
    blockwise_min(32)
    for sl in (slice(None), slice(-1, None)):      # Tq = 8, then Tq = 1
        kw = dict(causal=True, q_offset=40 - (8 if sl.start is None else 1),
                  kv_len=40)
        got = TL.attend(tq[:, sl], tk, tv, **kw)
        want = jx.JL.attend(jq[:, sl], jk, jv, **kw)
        assert got.dtype == tv.dtype
        atol = ATTN_ATOL if dtype == "f32" else 2 ** -8 * float(
            np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got), _np(want), atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches_jax(jx, dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 10)).astype(np.int32)
    if dtype == "f32":
        jxx, tx = jx.jnp.asarray(x), _t(x)
    else:
        jxx, tx = _bf16(jx, x)
    got = TL.rope(tx, _t(pos), 10000.0)
    want = jx.JL.rope(jxx, jx.jnp.asarray(pos), 10000.0)
    assert got.dtype == tx.dtype
    atol = 1e-5 if dtype == "f32" else 2 ** -8 * float(np.abs(x).max())
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


@pytest.mark.parametrize("act", ["silu", "relu_sq", "gelu"])
def test_mlp_matches_jax(jx, act):
    """Gated silu and relu_sq, and gelu (JAX's default tanh
    approximation), at bf16 products."""
    rng = np.random.default_rng(3)
    D, Fd = 64, 128
    defs = TL.mlp_defs(D, Fd, act)
    p = {n: (rng.normal(size=d.shape) * d.shape[0] ** -0.5).astype(
        np.float32) for n, d in defs.items()}
    x = rng.normal(size=(2, 5, D)).astype(np.float32)
    got = TL.mlp({n: _t(a) for n, a in p.items()}, _t(x), act)
    want = jx.JL.mlp({n: jx.jnp.asarray(a) for n, a in p.items()},
                     jx.jnp.asarray(x), act)
    assert got.dtype == torch.float32
    assert _ratio(got, want) <= 2e-2


def test_window_slice_matches_jax_and_the_masked_cache(jx):
    """Sliding-window decode through ``attention_block``: the sliced
    last-``window`` read equals JAX's and the masked whole cache."""
    rng = np.random.default_rng(4)
    D, shape = 32, TL.AttnShape(4, 2, 8)
    defs = TL.attention_defs(D, shape)
    p = {n: (rng.normal(size=d.shape) * 0.2).astype(np.float32)
         for n, d in defs.items()}
    x = rng.normal(size=(1, 12, D)).astype(np.float32)
    jsh = jx.JL.AttnShape(4, 2, 8)
    S, window = 16, 4
    jc = jx.JL.init_kv_cache(1, S, jsh)
    tc = TL.init_kv_cache(1, S, shape)
    jp = {n: jx.jnp.asarray(a) for n, a in p.items()}
    tp = {n: _t(a) for n, a in p.items()}
    outs = []
    for t in range(12):
        jo, jc = jx.JL.attention_block(jp, jx.jnp.asarray(x[:, t:t + 1]),
                                       shape=jsh, window=window, cache=jc)
        to, tc = TL.attention_block(tp, _t(x[:, t:t + 1]), shape=shape,
                                    window=window, cache=tc)
        assert tc["len"] == t + 1 == int(jc["len"])
        assert _ratio(to, jo) <= LOGIT_TOL, t
        outs.append(to)
    TL.set_window_slice(False)
    try:
        tc = TL.init_kv_cache(1, S, shape)
        for t in range(12):
            to, tc = TL.attention_block(tp, _t(x[:, t:t + 1]), shape=shape,
                                        window=window, cache=tc)
            np.testing.assert_allclose(_np(to), _np(outs[t]), atol=1e-6)
    finally:
        TL.set_window_slice(True)
    with pytest.raises(ValueError, match="do not fit"):
        TL.attention_block(tp, _t(x[:, :5]), shape=shape, cache=tc)


# ---------------------------------------------------------------------------
# the five architectures, reduced, against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "prefill", "prefill_blockwise"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(jx, blockwise_min, arch, mode):
    """Logits against JAX ``transformer.forward``: ``train`` (no cache),
    ``prefill`` into a KV cache of 32 positions (the naive path), and the
    same with both packages' blockwise threshold at 16, so the cached
    prefill takes ``_attend_blockwise`` as every prefill does at
    max_len = 2048; PaliGemma with its image prefix."""
    jcfg, zoo, jp, cfg, model = jx.model(arch)
    jb, tb = _batch(jx, cfg, np.random.default_rng(5), 2, 12)
    jc = tc = None
    if mode != "train":
        jc = zoo.init_cache(jcfg, 2, 32)
        tc = transformer.init_cache(cfg, 2, 32, CPU)
    if mode == "prefill_blockwise":
        blockwise_min(16)
    jlg, jc, _ = zoo.forward(jcfg, jp, jb, mode=mode.split("_")[0],
                             cache=jc)
    with torch.no_grad():
        tlg, tc, aux = model(tb, mode=mode.split("_")[0], cache=tc)
    assert tlg.shape == tuple(jlg.shape) and tlg.dtype == torch.bfloat16
    assert float(aux) == 0.0
    r = _ratio(tlg, jlg)
    print(f"{arch} {mode}: max |port - JAX| / max |JAX| = {r:.4g}")
    assert r <= LOGIT_TOL
    if tc is not None:
        assert tc["layers"]["len"] == int(jc["layers"]["len"][0])
        assert _ratio(tc["layers"]["k"], jc["layers"]["k"]) <= LOGIT_TOL


@pytest.mark.parametrize("arch", DENSE)
def test_loss_matches_jax(jx, arch):
    """``loss_fn`` at bf16 products within 1e-3 of JAX's, relative; the
    first row masks its first three labels (and PaliGemma's image span
    is masked by the loss itself)."""
    jcfg, zoo, jp, cfg, model = jx.model(arch)
    jb, tb = _batch(jx, cfg, np.random.default_rng(6), 2, 16,
                    with_labels=True)
    jloss = float(zoo.loss_fn(jcfg, jp, jb))
    with torch.no_grad():
        loss = float(model_zoo.get_model(cfg).loss_fn(cfg, model, tb))
    gap = abs(loss - jloss) / abs(jloss)
    print(f"{arch}: loss {loss:.6f} JAX {jloss:.6f} gap {gap:.3g}")
    assert np.isfinite(loss) and loss < 2 * np.log(cfg.vocab) + 2
    assert gap <= 1e-3


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "paligemma-3b"])
def test_loss_and_gradients_match_jax_in_f32(jx, monkeypatch, arch):
    """With both packages' products in f32 (``COMPUTE_DTYPE`` patched in
    each for this test only) no bf16 rounding separates them: the loss
    within 1e-5 of JAX's and every parameter's gradient within 1e-3 by
    relative norm.  This holds rope, the GQA broadcast, the masks, the
    gemma scaling, the tied logits and the label shift to JAX's
    algebra."""
    jcfg, zoo, jp, cfg, _ = jx.model(arch)
    for mod in (jx.JL, jx.jtr):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx.jnp.float32)
    for mod in (TL, transformer):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    model = convert.transformer_params_from_arrays(
        jx.jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    jb, tb = _batch(jx, cfg, np.random.default_rng(7), 2, 16,
                    with_labels=True)
    if "img_embeds" in tb:
        jb["img_embeds"] = jb["img_embeds"].astype(jx.jnp.float32)
        tb["img_embeds"] = tb["img_embeds"].float()
    jloss, jgrad = jx.jax.value_and_grad(
        lambda p: zoo.loss_fn(jcfg, p, jb))(jp)
    jgrads = {".".join(str(getattr(k, "key", k)) for k in path):
              np.asarray(g, np.float32) for path, g in
              jx.jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    loss = transformer.loss_fn(cfg, model, tb)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert abs(loss.item() - float(jloss)) / abs(float(jloss)) <= 1e-5
    assert set(grads) == set(jgrads)
    gaps = {n: float(np.linalg.norm(_np(g) - jgrads[n])
                     / np.linalg.norm(jgrads[n])) for n, g in grads.items()}
    print(f"{arch}: worst gradient gap {max(gaps.values()):.3g}")
    assert max(gaps.values()) <= 1e-3, gaps


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_full_forward(jx, arch):
    """Teacher-forced: prefill(t[:k]) then decode t[k], t[k+1]... must
    reproduce the full forward's logits at those positions (the port of
    tests/test_models.py's case), PaliGemma behind its image prefix."""
    *_, cfg, model = jx.model(arch)
    B, T, k = 2, 12, 8
    _, batch = _batch(jx, cfg, np.random.default_rng(3), B, T)
    toks = batch["tokens"]
    off = cfg.n_image_tokens if "img_embeds" in batch else 0
    with torch.no_grad():
        full, _, _ = model(batch, mode="prefill")
        cache = transformer.init_cache(cfg, B, T + off + 4, CPU)
        lg, cache, _ = model(dict(batch, tokens=toks[:, :k]),
                             mode="prefill", cache=cache)
        outs = [lg[:, -1]]
        for t in range(k, T):
            lg, cache, _ = model({"tokens": toks[:, t:t + 1]},
                                 mode="decode", cache=cache)
            outs.append(lg[:, -1])
    assert cache["layers"]["len"] == off + T
    for i, o in enumerate(outs[:-1]):
        assert _ratio(o, full[:, off + k - 1 + i]) < LOGIT_TOL, i


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "paligemma-3b"])
def test_decodes_a_jax_prefilled_cache(jx, arch):
    """A KV cache JAX prefilled, carried by
    ``transformer_cache_from_arrays`` (its per-layer lengths become one
    host length), is decoded by the port as JAX decodes it."""
    jcfg, zoo, jp, cfg, model = jx.model(arch)
    jb, tb = _batch(jx, cfg, np.random.default_rng(8), 1, 24)
    toks = np.asarray(jb["tokens"])
    jc = zoo.init_cache(jcfg, 1, 48)
    pre = dict(jb, tokens=jb["tokens"][:, :20])
    _, jc, _ = zoo.forward(jcfg, jp, pre, mode="prefill", cache=jc)
    tc = convert.transformer_cache_from_arrays(
        jx.jax.tree.map(np.asarray, jc), cfg=cfg, batch=1, device=CPU)
    off = cfg.n_image_tokens if "img_embeds" in jb else 0
    assert tc["layers"]["len"] == 20 + off
    assert tc["layers"]["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tc["layers"]["k"]),
                                  _np(jc["layers"]["k"]))
    for t in range(20, 24):
        jlg, jc, _ = zoo.forward(jcfg, jp,
                                 {"tokens": jb["tokens"][:, t:t + 1]},
                                 mode="decode", cache=jc)
        with torch.no_grad():
            tlg, tc, _ = model({"tokens": _t(toks[:, t:t + 1])},
                               mode="decode", cache=tc)
        assert _ratio(tlg, jlg) <= LOGIT_TOL, t


def test_conversions_refuse_what_they_cannot_carry(jx):
    jcfg, zoo, jp, cfg, _ = jx.model("tinyllama-1.1b")
    tree = jx.jax.tree.map(np.asarray, jp)
    bad = dict(tree, head=tree["head"].astype(np.float64))
    with pytest.raises(ValueError, match="head"):
        convert.transformer_params_from_arrays(bad, cfg=cfg, device=CPU)
    with pytest.raises(ValueError, match="missing"):
        convert.transformer_params_from_arrays(
            {k: v for k, v in tree.items() if k != "ln_f"}, cfg=cfg,
            device=CPU)
    jc = jx.jax.tree.map(np.asarray, zoo.init_cache(jcfg, 1, 8))
    with pytest.raises(ValueError, match="need"):
        convert.transformer_cache_from_arrays(jc, cfg=cfg, batch=2,
                                              device=CPU)
    uneven = {"layers": dict(jc["layers"], len=np.arange(
        cfg.n_layers, dtype=np.int32))}
    with pytest.raises(ValueError, match="one length"):
        convert.transformer_cache_from_arrays(uneven, cfg=cfg, batch=1,
                                              device=CPU)
    f32 = {"layers": dict(jc["layers"], k=jc["layers"]["k"].astype(
        np.float32))}
    with pytest.raises(ValueError, match="need torch.bfloat16"):
        convert.transformer_cache_from_arrays(f32, cfg=cfg, batch=1,
                                              device=CPU)


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_param_count_equals_jax(jx, arch):
    """At full width, counted from the defs (nothing is allocated): the
    port's count equals ``repro.models.model_zoo.param_count``, and the
    trees' shapes, axes and init rules are JAX's."""
    cfg, jcfg = get_arch(arch), jx.j_get_arch(arch)
    fields = [dataclasses.asdict(c) for c in (cfg, jcfg)]
    for f in fields:
        f["family"] = f["family"].value
    assert fields[0] == fields[1]
    assert cfg.param_count() == jx.jzoo.param_count(jcfg)
    jdefs = jx.jax.tree.leaves(
        jx.jzoo.get_model(jcfg).param_defs(jcfg),
        is_leaf=lambda x: isinstance(x, jx.jpspec.ParamDef))
    tdefs = tpspec.tree_leaves(transformer.param_defs(cfg))
    assert [(d.shape, d.logical, d.init, d.scale) for d in tdefs] == [
        (d.shape, d.logical, d.init, d.scale) for d in jdefs]


def test_moe_and_mla_name_their_roadmap_item():
    """MoE, MLA alone and MLA with MoE each build: the ``cfg.moe`` branch
    gives the layers ``moe``, the ``cfg.mla`` branch gives them MLA's
    ``attn`` and its latent cache, and the zoo builds the transformer
    for all three; an unknown mode still raises."""
    base = get_arch("tinyllama-1.1b").reduced()
    moe = dataclasses.replace(base, moe=MoECfg(n_experts=8, top_k=2,
                                               d_ff_expert=64))
    mla = dataclasses.replace(base, mla=MLACfg(32, 16, 16, 8, 16))
    assert "moe" in transformer.param_defs(moe)["layers"]
    assert model_zoo.get_model(dataclasses.replace(
        moe, family=Family.MOE)).build is transformer.Transformer
    for cfg in (mla, dataclasses.replace(moe, mla=mla.mla)):
        defs = transformer.param_defs(cfg)
        assert "wkv_a" in defs["layers"]["attn"]
        assert ("moe" in defs["layers"]) == (cfg.moe is not None)
        zoo = model_zoo.get_model(dataclasses.replace(cfg, family=Family.MOE))
        assert zoo.build is transformer.Transformer
        model = zoo.build(cfg, tpspec.init_params(
            defs, torch.Generator().manual_seed(0), CPU))
        cache = transformer.init_cache(cfg, 1, 8, CPU)["layers"]
        assert cache["c_kv"].shape == (cfg.n_layers, 1, 8, 16)
        with torch.no_grad():
            lg, cache, _ = model({"tokens": torch.zeros(
                (1, 3), dtype=torch.int32)}, mode="prefill",
                cache={"layers": cache})
        assert lg.shape == (1, 3, cfg.vocab) and cache["layers"]["len"] == 3
    with pytest.raises(ValueError, match="mode"):
        _reduced_model("tinyllama-1.1b")[1](
            {"tokens": torch.zeros((1, 2), dtype=torch.int32)},
            mode="score")


# ---------------------------------------------------------------------------
# continuous batching on tinyllama (ports of tests/test_serving.py)
# ---------------------------------------------------------------------------
def _reduced_model(arch, device=CPU, seed=0):
    cfg = get_arch(arch).reduced()
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, zoo.build(cfg, tpspec.init_params(zoo.param_defs(cfg), gen,
                                                  device))


def _reference_decode(cfg, model, prompt, n_new, device=CPU):
    """Single-request greedy decode (no batching engine)."""
    cache = model_zoo.get_model(cfg).init_cache(cfg, 1, 64, device)
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


def test_engine_drains_and_reuses_slots():
    cfg, model = _reduced_model("tinyllama-1.1b")
    eng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=CPU)
    rng = np.random.default_rng(0)
    for rid in range(5):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, 5).tolist(), max_new=4))
    stats = eng.run_until_drained()
    assert stats.completed == 5 and stats.admitted == 5
    assert max(stats.slot_occupancy) <= 2     # fixed register pool
    assert stats.decode_tokens == 5 * 3


def test_slot_isolation_outputs_match_reference():
    """Requests decoded through the shared slot pool produce the same
    tokens as isolated single-request decoding."""
    cfg, model = _reduced_model("tinyllama-1.1b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 6).tolist() for _ in range(3)]
    eng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=CPU)
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    for r in reqs:
        assert r.out == _reference_decode(cfg, model, r.prompt, 5), r.rid


def _jax_greedy_gaps(jx, jcfg, zoo, jp, prompt, n_new):
    """JAX's isolated greedy decode of one prompt: its tokens and, per
    step, the gap between its top two logits and its largest |logit|."""
    jnp = jx.jnp
    cache = zoo.init_cache(jcfg, 1, 64)
    lg, cache = jx.j_prefill(jcfg)(jp, {"tokens": jnp.asarray(
        [prompt], jnp.int32)}, cache)
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


def test_batcher_tokens_match_jax_batcher(jx):
    """Greedy tokens of the port's batcher equal the JAX batcher's on the
    same weights (tinyllama reduced).  A step whose JAX top-2 logit gap
    is below the logit tolerance (0.05 x max |logit|) could go either
    way within it: from that step on, the request is no longer compared
    (the caveat of tests/test_torch_lm.py's RWKV6 case)."""
    jcfg, zoo, jp, cfg, model = jx.model("tinyllama-1.1b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 9, 17,
                                                                   23, 40)]
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
    compared = 0
    for a, b in zip(jreqs, treqs):
        toks, gaps, scale = _jax_greedy_gaps(jx, jcfg, zoo, jp, a.prompt,
                                             n_new)
        assert a.out == toks                     # JAX's slot isolation
        assert len(b.out) == n_new
        for step, (x, y) in enumerate(zip(a.out, b.out)):
            if gaps[step] < LOGIT_TOL * scale[step]:
                break
            assert x == y, (a.rid, step, a.out, b.out)
            compared += 1
    print(f"greedy tokens compared: {compared} of {n_new * len(prompts)}")
    assert compared >= len(prompts)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "paligemma-3b"])
def test_launch_serve_cli_completes_on_cpu(capsys, arch):
    from repro_torch.launch import serve
    stats = serve.main(["--arch", arch, "--slots", "2", "--requests", "3",
                        "--max-new", "4", "--device", "cpu"])
    assert stats.completed == 3 and max(stats.slot_occupancy) <= 2
    assert "completed 3/3 requests" in capsys.readouterr().out


def test_registry_serves_the_dense_and_vlm_families():
    for arch in DENSE:
        cfg = get_arch(arch)
        assert model_zoo.get_model(cfg).build is transformer.Transformer


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
    """Reduced tinyllama on the card: the batcher's tokens equal an
    isolated batch-1 prefill and decode on the card."""
    cfg, model = _reduced_model("tinyllama-1.1b", device=card)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (6, 11, 30)]
    eng = ContinuousBatcher(cfg, model, slots=2, max_len=64, device=card)
    reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats.completed == 3 and max(stats.slot_occupancy) <= 2
    for r in reqs:
        assert r.out == _reference_decode(cfg, model, r.prompt, 6,
                                          device=card), r.rid


@pytest.mark.gpu
@pytest.mark.parametrize("arch", DENSE)
def test_card_logits_match_cpu(card, monkeypatch, arch):
    """The same reduced parameters on the card and on the CPU: prefill
    logits into a cache (the naive path, then the blockwise one at a
    threshold of 16) within 0.05 x max |logit| with the products in f32.
    With bf16 products the ratio is printed, not held: random-init
    attention is near one-hot, so one bf16 ulp in q or k can move a whole
    position (chip_smoke.py phase ``lm_dense`` prints the same beside the
    CPU's own bf16-against-f32 ratio)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu_model = _reduced_model(arch)
    nested: dict = {}
    for name, p in cpu_model.named_parameters():
        node = nested
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.data.to(card)
    card_model = transformer.Transformer(cfg, nested)
    rng = np.random.default_rng(9)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))}
    if cfg.n_image_tokens:
        batch["img_embeds"] = torch.from_numpy(rng.normal(size=(
            2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))

    def logits(m, dev):
        with torch.no_grad():
            lg, _, _ = m({k: v.to(dev) for k, v in batch.items()},
                         mode="prefill",
                         cache=transformer.init_cache(cfg, 2, 48, dev))
        return lg.cpu()

    prev = TL._BLOCKWISE_MIN
    try:
        for threshold in (prev, 16):
            TL.set_blockwise_min(threshold)
            r16 = _ratio(logits(card_model, card), logits(cpu_model, CPU))
            print(f"{arch}, blockwise at {threshold}: bf16 products, card "
                  f"vs CPU {r16:.4g}")
            with monkeypatch.context() as mp:
                for mod in (TL, transformer):
                    mp.setattr(mod, "COMPUTE_DTYPE", torch.float32)
                r = _ratio(logits(card_model, card),
                           logits(cpu_model, CPU))
            assert r <= LOGIT_TOL, (threshold, r)
    finally:
        TL.set_blockwise_min(prev)
