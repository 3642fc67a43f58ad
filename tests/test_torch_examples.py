"""The port's examples (``examples/*_torch.py``) on the CPU.

Each runs in-process through its ``main(argv)`` with ``--device cpu`` at
its smoke or quick size.  Where the JAX script computes the same numbers
at the same size, the printed lines are equal (``quickstart``,
``observe_serving`` but for the scrape's port and the span tree's wall
times; ``splidt_dse`` in ``tests/test_torch_examples_dse.py``); the rest
hold their own checks.  Without ``--device`` each raises the port's
``RuntimeError`` where no card is present (``device=None`` is the card,
never a fall back to the CPU).  The ``gpu`` test holds kernel A at
``full_flow_features``' shape (P = 1, W = 192, k = 41) against its plain
version; it decides inside its fixture whether there is a card.

JAX is imported inside the comparisons only, so the card's machine,
which has no JAX, collects this file.
"""
import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.flows.synthetic import make_dataset
from repro_torch.flows.windows import (
    _all_feature_rows, full_flow_features, window_features, window_packets,
)
from repro_torch.kernels import feature_window as fw
from repro_torch.kernels import ref

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
NAMES = ("quickstart", "splidt_dse", "autotune_engine", "observe_serving",
         "serve_lm", "train_lm", "fault_tolerance")


def _load(name: str):
    """``examples/<name>.py`` as a module (the folder is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, argv=None):
    """``main(argv)`` of an example, with what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _load(name).main(argv) if argv is not None \
            else _load(name).main()
    return out, buf.getvalue()


@pytest.fixture
def obs_state():
    """The examples switch span timing on; leave it as it was."""
    was = obs.enabled()
    yield
    obs.set_enabled(was)
    obs.reset_spans()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_every_example_has_a_port():
    for name in NAMES:
        assert (EXAMPLES / f"{name}.py").is_file()
        assert (EXAMPLES / f"{name}_torch.py").is_file()
    assert not (EXAMPLES / "torch").exists()   # would shadow the package


@pytest.mark.parametrize("name", NAMES)
def test_example_without_a_card_raises(no_card, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(f"{name}_torch").main([])


def test_quickstart_prints_the_jax_lines():
    pytest.importorskip("jax")
    out, text = _run("quickstart_torch", ["--device", "cpu"])
    _, text_j = _run("quickstart")
    assert text == text_j
    assert out["device"] == "cpu" and out["total_depth"] == 9
    labels, recircs, exit_p = out["pdt"].predict(
        window_features(out["test"], 3, device="cpu"), return_trace=True)
    np.testing.assert_array_equal(out["labels"], labels)
    np.testing.assert_array_equal(out["recircs"], recircs)
    np.testing.assert_array_equal(out["exit_partition"], exit_p)


def test_observe_serving_prints_the_jax_lines(obs_state, monkeypatch):
    pytest.importorskip("jax")
    out, text = _run("observe_serving_torch", ["--smoke", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["observe_serving.py", "--smoke"])
    rc, text_j = _run("observe_serving")
    assert rc == 0 and out["audit_clean"]

    def stable(t):
        # the scrape's port and the span tree's wall-clock lines differ
        t = re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:PORT", t)
        head, _, rest = t.partition("--- span tree")
        _, _, tail = rest.partition("--- recirc-overhead audit ---")
        return head + tail

    assert stable(text) == stable(text_j)
    assert out["live"] == out["offline"]
    assert out["verdicts"] > 0 and out["packets"] > 0


def test_observe_serving_exits_nonzero_on_drift(obs_state, monkeypatch):
    """The audit reads the live gauge; a gauge that drifted from the raw
    verdicts is reported (and the script, run as a program, exits 1)."""
    from repro_torch.obs import metrics
    real = metrics.MetricRegistry.gauge

    def drifting(self, name, *a, **kw):
        g = real(self, name, *a, **kw)
        if name == "serve_recirc_overhead":
            g.set(g.value + 1.0)
        return g

    monkeypatch.setattr(metrics.MetricRegistry, "gauge", drifting)
    out, text = _run("observe_serving_torch", ["--smoke", "--device", "cpu"])
    assert not out["audit_clean"] and "MISMATCH" in text


def test_autotune_tuned_equals_fused(monkeypatch, tmp_path):
    from repro_torch.tuning.autotune import CACHE_ENV
    monkeypatch.setenv(CACHE_ENV, str(tmp_path / "unused.json"))
    out, text = _run("autotune_engine_torch", ["--smoke", "--device", "cpu"])
    assert "parity vs impl='fused': bit-identical (256 verdicts)" in text
    assert out["verdicts"] == 256 and out["warm_source"] == "cache"
    assert set(out["estimates_us"]) == {"looped", "fused"}   # no card
    assert out["tuned_plan"].backend in ("looped", "fused")


def test_serve_lm_serves_every_request():
    out, text = _run("serve_lm_torch", ["--device", "cpu"])
    assert out["completed"] == 9 and out["max_occupancy"] <= 3
    assert text.startswith("completed 9/9 requests")
    assert "ACCEPTANCE: all requests served" in text


def test_train_lm_quick_learns(tmp_path):
    out, text = _run("train_lm_torch", ["--quick", "--device", "cpu",
                                        "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 40 and np.isfinite(out["losses"]).all()
    assert out["learned"] and "ACCEPTANCE: final loss" in text
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())


def test_fault_tolerance_recovers():
    out, text = _run("fault_tolerance_torch", ["--device", "cpu"])
    assert (out["failures"], out["restores"], out["final_step"]) == (2, 2, 24)
    assert out["steps_run"] > 24
    # the replayed steps repeat the losses of the steps they redo
    seen = {}
    for step, loss in out["losses"]:
        if step in seen:
            assert loss == seen[step], step
        seen[step] = loss
    assert "recovered to exactly step 24" in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("W", [192, 191])
def test_full_flow_kernel_a_on_card(card, W):
    """Kernel A at ``full_flow_features``' shape (P = 1, windows as long
    as the longest flow, k = 41 under one shared slot row), on d1 flows
    cut to ``W`` packets, == its plain version; ``full_flow_features`` on
    the card is one launch and equals the CPU route."""
    ds = make_dataset("d1", 4099, seed=3)
    ds = dataclasses.replace(ds, lengths=np.minimum(ds.lengths, W),
                             packets=ds.packets[:, :W].copy())
    x = torch.from_numpy(window_packets(ds, 1)).to(card)
    assert x.shape[1:] == (1, W, 6)
    args = (x.view(x.shape[0], W, 6), *_all_feature_rows(1, card))
    got = fw.feature_window_kernel(*args)
    assert torch.equal(got, ref.feature_window_ref(*args))
    fw.launches = 0
    card_ff = full_flow_features(ds)
    assert fw.launches == 1
    np.testing.assert_array_equal(card_ff.view(np.int32),
                                  got.cpu().numpy().view(np.int32))
    np.testing.assert_array_equal(
        card_ff.view(np.int32),
        full_flow_features(ds, device="cpu").view(np.int32))
