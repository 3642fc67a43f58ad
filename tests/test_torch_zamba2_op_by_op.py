"""The port's Zamba2 at bf16 products against JAX evaluated op by op
(``jax.disable_jit``), at one group of the reduced model (2 Mamba2 mixers
and the shared block), on the CPU.

Split from ``test_torch_zamba2.py`` (whose note gives the tolerances and
why bf16 logits are held here and not against JAX's compiled forward) so
that the test workers, which take a file each, run the two halves side
by side: under ``jax.disable_jit`` JAX compiles every primitive at its
first use, which is most of this file's time.  Both tests use the same
shapes, so the second reuses the first one's compiled primitives.
"""
import numpy as np
import torch

from repro_torch import convert
from tests.test_torch_zamba2 import (  # noqa: F401  (jx: the fixture)
    LOGIT_TOL, CPU, _jax_modes, _np, _port_modes, _ratio, _t, _tokens, jx,
)


def test_forward_matches_jax_op_by_op_at_one_group(jx):
    """With bf16 products, the model cut to one group (2 mixers and the
    shared block): ``train``, ``prefill`` and ``decode`` logits within
    0.05 x max |logit| of JAX evaluated op by op (``jax.disable_jit``),
    which rounds each bf16 step where the port does.  JAX's compiled
    forward is printed beside it, and its own distance from the op-by-op
    one (the reference's floor, ROADMAP C)."""
    jcfg, jp, cfg, model = jx.model(2)
    toks = _tokens(cfg, 4, 2, 24)
    with jx.jax.disable_jit():
        eager = _jax_modes(jx, jcfg, jp, toks, 20)
    compiled = _jax_modes(jx, jcfg, jp, toks, 20)
    got = _port_modes(cfg, model, toks, 20)
    ratios = {k: _ratio(got[k], eager[k]) for k in eager}
    print("bf16, one group: port vs JAX op by op",
          {k: f"{r:.3g}" for k, r in ratios.items()},
          "| port vs JAX compiled",
          {k: f"{_ratio(got[k], compiled[k]):.3g}" for k in compiled},
          "| JAX compiled vs op by op",
          {k: f"{_ratio(compiled[k], eager[k]):.3g}" for k in compiled})
    assert max(ratios.values()) <= LOGIT_TOL, ratios


def test_decodes_a_jax_prefilled_cache(jx):
    """A cache JAX prefilled (its per-group ``attn.len`` a (G,) int32),
    carried by ``zamba2_cache_from_arrays``, holds JAX's bits and is
    decoded by the port as JAX decodes it, at one group with bf16
    products against JAX op by op (the shapes of the test above)."""
    jcfg, jp, cfg, model = jx.model(2)
    zoo = jx.jzoo.get_model(jcfg)
    toks = _tokens(cfg, 8, 2, 24)
    with jx.jax.disable_jit():
        jc = zoo.init_cache(jcfg, 2, 64)
        _, jc, _ = zoo.forward(jcfg, jp, {"tokens": jx.jnp.asarray(
            toks[:, :20])}, mode="prefill", cache=jc)
        tc = convert.zamba2_cache_from_arrays(
            jx.jax.tree.map(np.asarray, jc), cfg=cfg, batch=2, device=CPU)
        assert tc["attn"]["len"] == 20
        assert tc["mamba"]["conv"].dtype == torch.bfloat16
        for a, b in ((tc["mamba"]["conv"], jc["mamba"]["conv"]),
                     (tc["mamba"]["S"], jc["mamba"]["S"]),
                     (tc["attn"]["k"], jc["attn"]["k"])):
            np.testing.assert_array_equal(_np(a), _np(b))
        for t in range(20, 24):
            jlg, jc, _ = zoo.forward(jcfg, jp, {"tokens": jx.jnp.asarray(
                toks[:, t:t + 1])}, mode="decode", cache=jc)
            with torch.no_grad():
                tlg, tc, _ = model({"tokens": _t(toks[:, t:t + 1])},
                                   mode="decode", cache=tc)
            assert _ratio(tlg, jlg) <= LOGIT_TOL, t
    assert tc["attn"]["len"] == 24
