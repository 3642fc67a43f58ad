"""The port's remat (``layers.remat``: the transformer's two regions a
layer under ``transformer.set_remat``, each blockwise-attention step,
RWKV6's layers and Zamba2's groups), on the CPU at reduced widths.

- Remat on against off: the loss and every gradient of the train step's
  ``loss_and_grads`` are ``torch.equal`` (the recompute runs the same ops
  on the same inputs), for the dense family on the naive and the
  blockwise attention, MoE, MLA, the VLM prefix, RWKV6 and Zamba2.  Off
  is every region run as a plain call (``layers.remat`` the identity,
  as :func:`no_regions` patches it): the blockwise steps, RWKV6 and
  Zamba2 have no switch, as in JAX.
- Remat on against JAX's ``loss_fn`` under ``jax.grad`` (which remats
  too), both packages' products in f32, on the blockwise path: the loss
  within 1e-5 relative and each gradient within 1e-3 by relative norm,
  the bars of tests/test_torch_train_step.py.
- What autograd keeps after a train forward, counted with
  ``saved_tensors_hooks``: affine in T with remat, superlinear without.

Inputs are made with numpy from a seed (``model_zoo.concrete_batch``).
JAX is imported in a fixture, so on the card's machine (no JAX) the
``gpu`` test still runs.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCfg
from repro_torch.distributed import pspec as tpspec
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo, transformer
from repro_torch.train.train_step import loss_and_grads

CPU = "cpu"
LOSS_TOL, GRAD_TOL = 1e-5, 1e-3
BLOCKWISE_MIN, KV_BLOCK = 32, 16     # 4 KV blocks at T = 64
FAMILIES = [("tinyllama-1.1b", False), ("tinyllama-1.1b", True),
            ("qwen2-moe-a2.7b", False), ("deepseek-v2-236b", False),
            ("paligemma-3b", True), ("rwkv6-1.6b", False),
            ("zamba2-2.7b", False)]


def _model(arch: str, device=CPU, n_layers: int | None = None):
    cfg = get_arch(arch).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, zoo.build(cfg, tpspec.init_params(zoo.param_defs(cfg), gen,
                                                  device))


def _batch(cfg, T: int, device=CPU, B: int = 2) -> dict:
    return model_zoo.concrete_batch(cfg, ShapeCfg("t", T, B, "train"),
                                    seed=7, device=device)


@pytest.fixture
def blockwise(monkeypatch):
    """The port's blockwise attention from ``BLOCKWISE_MIN`` keys on, in
    blocks of ``KV_BLOCK``, for one test."""
    monkeypatch.setattr(TL, "_BLOCKWISE_MIN", BLOCKWISE_MIN)
    monkeypatch.setattr(TL, "_KV_BLOCK", KV_BLOCK)


@pytest.fixture
def no_regions(monkeypatch):
    """``no_regions()`` runs every checkpoint region as a plain call from
    then on in the test."""
    return lambda: monkeypatch.setattr(TL, "remat", lambda fn: fn)


@pytest.fixture
def layer_remat():
    """Sets ``transformer.set_remat``; restores it (on) after the test."""
    yield transformer.set_remat
    transformer.set_remat(True)


@contextlib.contextmanager
def _saved_bytes():
    """Counts the bytes of every tensor autograd saves in the block (a
    checkpoint region's inputs, not what it recomputes) into ``n[0]``."""
    n = [0]

    def pack(t):
        n[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield n


def _step(cfg, model, batch) -> tuple:
    """``loss_and_grads``: the loss, the gradients by name and the bytes
    autograd saved in the forward."""
    with _saved_bytes() as n:
        loss, grads = loss_and_grads(cfg, model, batch)
    return loss, dict(tpspec.tree_items(grads)), n[0]


@pytest.mark.parametrize("arch,blocks", FAMILIES,
                         ids=[f"{a}-{'blockwise' if b else 'naive'}"
                              for a, b in FAMILIES])
def test_remat_equals_no_remat(request, no_regions, arch, blocks):
    """Loss and every gradient bit for bit, and the checkpoints ran: the
    forward saved fewer bytes with remat."""
    if blocks:
        request.getfixturevalue("blockwise")
    cfg, model = _model(arch)
    batch = _batch(cfg, 64)
    l_on, g_on, saved_on = _step(cfg, model, batch)
    no_regions()
    l_off, g_off, saved_off = _step(cfg, model, batch)
    print(f"{arch}: saved {saved_on} B with remat, {saved_off} B without")
    assert torch.isfinite(l_on) and torch.equal(l_on, l_off)
    assert set(g_on) == set(g_off)
    assert [n for n in g_on if not torch.equal(g_on[n], g_off[n])] == []
    assert 0 < saved_on < saved_off


def _checkpoint_calls(monkeypatch) -> list:
    calls = []
    real = TL.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(TL, "checkpoint", counted)
    return calls


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-1.6b",
                                  "zamba2-2.7b"])
def test_regions_a_forward_and_none_outside_autograd(
        monkeypatch, blockwise, arch):
    """A train forward under autograd opens JAX's regions: two a layer
    (attention, FFN) and one a KV block of each layer's attention in the
    transformer; one a layer in RWKV6; one a group in Zamba2, and one a
    KV block of its shared attention.  Serving modes, and the train mode
    under ``no_grad``, open none."""
    cfg, model = _model(arch)
    zoo = model_zoo.get_model(cfg)
    batch = _batch(cfg, 64)
    calls = _checkpoint_calls(monkeypatch)
    with torch.no_grad():
        zoo.loss_fn(cfg, model, batch)
        for mode in ("train", "prefill"):
            model(batch, mode=mode)
    assert calls == []
    with torch.enable_grad():
        zoo.loss_fn(cfg, model, batch)
    blocks = 64 // KV_BLOCK
    if cfg.shared_attn_every:
        want = cfg.n_layers // cfg.shared_attn_every * (1 + blocks)
    elif cfg.ssm is not None:
        want = cfg.n_layers
    else:
        want = cfg.n_layers * (2 + blocks)
    assert len(calls) == want


def test_blockwise_step_alone_equals_its_plain_loop(
        blockwise, layer_remat, no_regions):
    """With layer remat off (``set_remat(False)``, as the dry run's FSDP-2D
    train cells run), the checkpointed blockwise steps alone give the
    plain loop's loss and gradients bit for bit, and save less."""
    cfg, model = _model("tinyllama-1.1b")
    batch = _batch(cfg, 64)
    layer_remat(False)
    l1, g1, saved1 = _step(cfg, model, batch)
    no_regions()
    l0, g0, saved0 = _step(cfg, model, batch)
    assert torch.equal(l1, l0)
    assert [n for n in g1 if not torch.equal(g1[n], g0[n])] == []
    assert saved1 < saved0


def _forward_bytes(cfg, model, T: int) -> int:
    batch = _batch(cfg, T, B=1)
    with torch.enable_grad(), _saved_bytes() as n:
        model_zoo.get_model(cfg).loss_fn(cfg, model, batch)
    return n[0]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_saved_bytes_are_affine_in_T_with_remat(blockwise, no_regions,
                                                remat):
    """At the blockwise path, what autograd keeps after a train forward:
    with remat, each layer's input and residual sum plus the loss's
    logits, affine in T (equal second differences over T = 64, 128,
    256); without, every KV block's (Tq, block) logits too, superlinear
    in T."""
    cfg, model = _model("tinyllama-1.1b")
    if not remat:
        no_regions()
    b = {T: _forward_bytes(cfg, model, T) for T in (64, 128, 256)}
    d1, d2 = b[128] - b[64], b[256] - b[128]
    print(f"remat={remat}: saved bytes {b}")
    if remat:
        assert d2 == 2 * d1
    else:
        assert d2 > 2 * d1


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax.numpy")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.distributed import pspec as jpspec
    from repro.models import layers as JL
    from repro.models import model_zoo as jzoo
    from repro.models import transformer as jtr
    return types.SimpleNamespace(jax=jax, jnp=jnp, j_get_arch=j_get_arch,
                                 jpspec=jpspec, JL=JL, jzoo=jzoo, jtr=jtr)


def test_remat_matches_jax_grad_on_the_blockwise_path(jx, monkeypatch,
                                                      blockwise):
    """Reduced tinyllama, both packages on the blockwise path (4 KV blocks
    of 16) with their products in f32 and remat on: the port's loss
    within 1e-5 of JAX's ``loss_fn`` and every gradient within 1e-3 by
    relative norm of ``jax.grad``'s."""
    assert transformer._USE_REMAT and jx.jtr._USE_REMAT
    monkeypatch.setattr(jx.JL, "_BLOCKWISE_MIN", BLOCKWISE_MIN)
    monkeypatch.setattr(jx.JL, "_KV_BLOCK", KV_BLOCK)
    for mod in (jx.JL, jx.jtr):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx.jnp.float32)
    for mod in (TL, transformer):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    jcfg = jx.j_get_arch("tinyllama-1.1b").reduced()
    cfg = get_arch("tinyllama-1.1b").reduced()
    zoo = jx.jzoo.get_model(jcfg)
    jp = jx.jpspec.init_params(zoo.param_defs(jcfg), jx.jax.random.key(0))
    model = convert.transformer_params_from_arrays(
        jx.jax.tree.map(np.asarray, jp), cfg=cfg, device=CPU)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    labels[0, :3] = -1
    jloss, jgrad = jx.jax.value_and_grad(lambda p: zoo.loss_fn(
        jcfg, p, {"tokens": jx.jnp.asarray(toks),
                  "labels": jx.jnp.asarray(labels)}))(jp)
    jgrads = {".".join(str(getattr(k, "key", k)) for k in path):
              np.asarray(g, np.float32) for path, g in
              jx.jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    loss, grads = loss_and_grads(cfg, model, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    grads = dict(tpspec.tree_items(grads))
    assert abs(float(loss) - float(jloss)) / abs(float(jloss)) <= LOSS_TOL
    assert set(grads) == set(jgrads)
    gaps = {n: float(np.linalg.norm(g.numpy() - jgrads[n])
                     / np.linalg.norm(jgrads[n])) for n, g in grads.items()}
    print(f"worst gradient gap {max(gaps.values()):.3g}")
    assert max(gaps.values()) <= GRAD_TOL, gaps


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_remat_equals_no_remat_on_card(monkeypatch, blockwise):
    """Reduced tinyllama (2 layers) on the card, blockwise path forced: the
    loss with remat ``==`` without, and each gradient within 4x the
    largest difference of two runs without remat (0 when those two are
    bit-equal: then remat must be too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda")
    cfg, model = _model("tinyllama-1.1b", card, n_layers=2)
    batch = _batch(cfg, 64, card)
    checkpointed = TL.remat
    runs = []
    for on in (False, True, False):
        monkeypatch.setattr(TL, "remat", checkpointed if on else
                            (lambda fn: fn))
        runs.append(_step(cfg, model, batch))
    (l_off, g_off, _), (l_on, g_on, _), (_, g_rep, _) = runs
    gap = lambda a, b: float((a.double() - b.double()).abs().max())
    repeat = max(gap(g_rep[n], g_off[n]) for n in g_off)
    assert torch.equal(l_on, l_off)
    assert max(gap(g_on[n], g_off[n]) for n in g_off) <= 4 * repeat
