"""``examples/splidt_dse_torch.py`` on the CPU against the JAX script.

One Bayesian-optimisation round (``--iterations 1``: the 8 initial
configurations and one batch of 4) on each package at the scripts' own
size (d1, 3,000 flows, 5 windows): the printed search (evaluations, the
best configuration, the Pareto frontier) is the same text, with the
port's host trainer (the JAX script's, which the example takes on the
CPU) and the batched evaluator (``fleet_predict``, the plain hop on the CPU).  Apart
from ``tests/test_torch_examples.py`` because the two searches take
about a minute together.  JAX is imported inside the test.
"""
import contextlib
import io
import sys

import numpy as np
import pytest

from test_torch_examples import _load


def test_splidt_dse_prints_the_jax_search(monkeypatch):
    pytest.importorskip("jax")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _load("splidt_dse_torch").main(
            ["--iterations", "1", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["splidt_dse.py", "--iterations", "1"])
    buf_j = io.StringIO()
    with contextlib.redirect_stdout(buf_j):
        _load("splidt_dse").main()
    assert buf.getvalue() == buf_j.getvalue()
    assert out["evaluations"] == 12 and out["device"] == "cpu"
    assert out["best_f1"] == max(e.f1 for e in out["history"]
                                 if e.feasible)
    assert np.all(np.diff([f1 for f1, _, _ in out["pareto"]]) <= 0)
