"""The port's multi-device half on 4 gloo ranks against the JAX package on
fake CPU devices.

One JAX subprocess (8 fake devices, ``conftest.run_subprocess``) and one
launch of 4 port ranks (subprocesses, gloo over a ``file://`` store in
``tmp_path``) run every case on the same numpy inputs; the tests then
compare what each wrote:

* ``compressed_psum`` (with the group, and with a ``(DeviceMesh, axis)``
  pair and an error feedback) equals JAX's under ``shard_map`` on a
  4-device "pod" mesh bit for bit, ``mean`` and ``new_err``;
* ``pipeline_forward`` with S = 4 and M = 6 (the shapes of
  tests/test_distributed.py) within 1e-5 of JAX's and of the sequential
  stages, the parameters given plain and as a DTensor;
* a state sharded over a 4-rank ("data",) mesh saves JAX's arrays and
  manifest template; it restores onto 2-rank and 1-rank sub-meshes with
  each rank's local shard equal to JAX's shard on the same device index
  (the ranks outside hold empty shards); a checkpoint JAX writes from an
  8-device sharded state restores on 4 ranks; ``remesh`` from 4 ranks to
  2;
* ``run_with_recovery`` with ``shardings`` and ``fail_at={12, 23}`` on the
  toy problem of tests/test_train_infra.py gives JAX's report and final
  state (within 1e-6, AdamW's parity).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax.numpy")

from tests.conftest import run_subprocess  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
S, M, D = 4, 6, 16          # pipeline stages, microbatches, width

_JAX = """
import json, numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P, AxisType
from repro.distributed.compression import compressed_psum
from repro.distributed.pipeline import make_stage_mesh, pipeline_forward
from repro.train import checkpoint as ckpt_lib
from repro.train.elastic import run_with_recovery
from repro.train.optimizer import AdamW, TrainState

tmp = r"{tmp}"
inp = dict(np.load(tmp + "/inputs.npz"))
out = {{}}

def mesh(n, name="data"):
    return jax.make_mesh((n,), (name,), axis_types=(AxisType.Auto,))

# -- compressed_psum under shard_map on a 4-device "pod" mesh --------------
pod = mesh(4, "pod")
f0 = lambda g: tuple(x[None] for x in compressed_psum(g[0], "pod"))
f1 = lambda g, e: tuple(x[None] for x in compressed_psum(g[0], "pod", e[0]))
m0, e0 = jax.jit(shard_map(f0, mesh=pod, in_specs=P("pod"),
                           out_specs=(P("pod"), P("pod"))))(inp["g"])
m1, e1 = jax.jit(shard_map(f1, mesh=pod, in_specs=(P("pod"), P("pod")),
                           out_specs=(P("pod"), P("pod"))))(inp["g"], inp["e"])
out.update(psum_m0=m0, psum_e0=e0, psum_m1=m1, psum_e1=e1)

# -- pipeline ---------------------------------------------------------------
smesh = make_stage_mesh({S})
pipe = jax.jit(pipeline_forward(lambda W, x: jnp.tanh(x @ W), smesh))
with jax.set_mesh(smesh):
    out["pipe"] = pipe(jnp.asarray(inp["Ws"]), jnp.asarray(inp["mbs"]))

# -- checkpoints ------------------------------------------------------------
def state_of(prefix):
    tree = {{k.split("/", 1)[1]: inp[k] for k in inp
            if k.startswith(prefix + "/")}}
    return {{n: jnp.asarray(a) for n, a in tree.items()}}

state = TrainState(step=jnp.asarray(3, jnp.int32), params=state_of("p"),
                   mu=state_of("mu"), nu=state_of("nu"))

def shardings(m, n):
    spec = lambda x: P("data") if x.ndim and x.shape[0] % n == 0 else P()
    return jax.tree.map(lambda x: NamedSharding(m, spec(x)), state)

for n in (4, 8):
    placed = jax.tree.map(jax.device_put, state, shardings(mesh(n), n))
    ckpt_lib.save(tmp + f"/jax{{n}}/step_3", placed, extra={{"n": n}})
for n in (2, 1):
    m = mesh(n)
    restored, _ = ckpt_lib.restore(tmp + "/jax4/step_3", shardings(m, n))
    order = list(m.devices.flat)
    for part in ("params", "mu", "nu"):
        for name, leaf in getattr(restored, part).items():
            for s in leaf.addressable_shards:
                out[f"r{{n}}/{{part}}/{{name}}/{{order.index(s.device)}}"] = (
                    np.asarray(s.data))

# -- recovery with shardings --------------------------------------------------
opt = AdamW(lr=0.05)
params = state_of("toy")
rstate = opt.init(params)
m4 = mesh(4)
rsh = jax.tree.map(lambda x: NamedSharding(
    m4, P("data") if x.ndim and x.shape[0] % 4 == 0 else P()), rstate)
rstate = jax.tree.map(jax.device_put, rstate, rsh)

def step_fn(st, batch):
    g = jax.grad(lambda q: sum(jnp.sum((a - 1.0) ** 2)
                               for a in jax.tree.leaves(q)))(st.params)
    return opt.update(st, g)

final, rep = run_with_recovery(step_fn, rstate, range(30),
                               ckpt_root=tmp + "/jrec", ckpt_every=5,
                               fail_at={{12, 23}}, shardings=rsh)
for part in ("params", "mu", "nu"):
    for name, a in getattr(final, part).items():
        out[f"rec/{{part}}/{{name}}"] = np.asarray(a)
out["rec/step"] = np.asarray(final.step)
with open(tmp + "/jax_report.json", "w") as f:
    json.dump([rep.failures, rep.restores, rep.steps_run, rep.final_step], f)
np.savez(tmp + "/jax_out.npz", **{{k: np.asarray(v) for k, v in out.items()}})
print("ok")
"""

_RANKS = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.distributed import group
from repro_torch.distributed.compression import compressed_psum
from repro_torch.distributed.pipeline import make_stage_mesh, pipeline_forward
from repro_torch.distributed.pspec import (
    tree_from_items, tree_items, tree_map)
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic
from repro_torch.train.optimizer import AdamW, TrainState

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
group.init(rank, world, os.path.join(tmp, "store"), device="cpu")
inp = dict(np.load(tmp + "/inputs.npz"))
out = {}

# -- compressed_psum ----------------------------------------------------------
pod = make_device_mesh((4,), ("pod",), device="cpu")
g, e = torch.from_numpy(inp["g"][rank]), torch.from_numpy(inp["e"][rank])
out["psum_m0"], out["psum_e0"] = compressed_psum(g, dist.group.WORLD)
out["psum_m1"], out["psum_e1"] = compressed_psum(g, (pod, "pod"), e)

# -- pipeline -------------------------------------------------------------------
smesh = make_stage_mesh(4, device="cpu")
Ws, mbs = torch.from_numpy(inp["Ws"]), torch.from_numpy(inp["mbs"])
pipe = pipeline_forward(lambda W, x: torch.tanh(x @ W), smesh)
out["pipe_plain"] = pipe(Ws, mbs)
out["pipe_dt"] = pipe(distribute_tensor(Ws, smesh, [Shard(0), Replicate()]),
                      mbs)

# -- checkpoints ----------------------------------------------------------------
def tree_of(prefix):
    return {k.split("/", 1)[1]: torch.from_numpy(inp[k]) for k in inp
            if k.startswith(prefix + "/")}

state = TrainState(step=torch.tensor(3, dtype=torch.int32),
                   params=tree_of("p"), mu=tree_of("mu"), nu=tree_of("nu"))
meshes = {n: make_device_mesh((n,), ("data",), device="cpu")
          for n in (4, 2, 1)}

def shardings(n, st=state):
    ns = lambda t: NamedSharding(meshes[n], ("data",) if t.dim()
                                 and t.shape[0] % n == 0 else ())
    return TrainState(step=ns(st.step), params=tree_map(ns, st.params),
                      mu=tree_map(ns, st.mu), nu=tree_map(ns, st.nu))

def locals_of(st, tag):
    for part in ("params", "mu", "nu"):
        for name, t in tree_items(getattr(st, part)):
            out[f"{tag}/{part}/{name}"] = t.to_local()
    out[f"{tag}/step"] = st.step.to_local()

state4 = elastic.remesh(state, shardings(4))
ckpt.save(tmp + "/port/step_3", state4, extra={"n": 4})
for n in (2, 1):
    restored, extra = ckpt.restore(tmp + "/port/step_3", shardings(n))
    assert extra == {"n": 4}
    locals_of(restored, f"r{n}")
restored8, _ = ckpt.restore(tmp + "/jax8/step_3", shardings(4))
locals_of(restored8, "j8")
locals_of(elastic.remesh(state4, shardings(2)), "m2")
zeroed = elastic.remesh(TrainState(
    step=torch.tensor(0, dtype=torch.int32), params=tree_map(
        torch.zeros_like, state.params), mu=tree_map(torch.zeros_like,
                                                     state.mu),
    nu=tree_map(torch.zeros_like, state.nu)), shardings(4))
into, _ = ckpt.restore_into(tmp + "/jax8/step_3", zeroed)
locals_of(into, "into")

# -- recovery with shardings ------------------------------------------------------
opt = AdamW(lr=0.05)
rstate = opt.init(tree_of("toy"))
rsh = shardings(4, rstate)

def step_fn(st, batch):
    # AdamW runs on whole tensors: gather, step, place back
    full = lambda tree: tree_map(lambda t: t.full_tensor(), tree)
    st = TrainState(step=st.step.full_tensor(), params=full(st.params),
                    mu=full(st.mu), nu=full(st.nu))
    leaves = [t.detach().requires_grad_(True)
              for _, t in tree_items(st.params)]
    loss = sum(torch.sum((a - 1.0) ** 2) for a in leaves)
    grads = tree_from_items([n for n, _ in tree_items(st.params)],
                            torch.autograd.grad(loss, leaves))
    st, m = opt.update(st, grads)
    return elastic.remesh(st, rsh), m

final, rep = elastic.run_with_recovery(
    step_fn, elastic.remesh(rstate, rsh), range(30),
    ckpt_root=tmp + "/trec", ckpt_every=5, fail_at={12, 23}, shardings=rsh)
for part in ("params", "mu", "nu"):
    for name, t in tree_items(getattr(final, part)):
        out[f"rec/{part}/{name}"] = t.full_tensor()
out["rec/step"] = final.step.full_tensor()
np.savez(f"{tmp}/rank{rank}.npz",
         **{k: v.detach().numpy() for k, v in out.items()})
with open(f"{tmp}/rank{rank}_report.json", "w") as f:
    json.dump([rep.failures, rep.restores, rep.steps_run, rep.final_step], f)
group.destroy()
print("ok", rank)
"""


def _inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    out = {"g": f32(4, 257), "e": (f32(4, 257) * 1e-2),
           "Ws": (f32(S, D, D) / np.sqrt(D)).astype(np.float32),
           "mbs": f32(M, 8, D)}
    # a state whose leaves shard over 4 and 8 ranks, and one replicated
    for part in ("p", "mu", "nu"):
        out[f"{part}/w"] = f32(8, 8)
        out[f"{part}/b"] = f32(8)
        out[f"{part}/s"] = f32(3, 8)
    trng = np.random.default_rng(4)           # the toy of test_train_infra
    out["toy/w"] = trng.normal(size=(8, 8)).astype(np.float32)
    out["toy/b"] = trng.normal(size=(8,)).astype(np.float32)
    return out


def _run_ranks(code: str, tmp, world: int = WORLD,
               timeout: int = 240) -> list[str]:
    """``code`` in ``world`` processes, ``script rank world tmp`` each."""
    script = os.path.join(tmp, "ranks.py")
    with open(script, "w") as f:
        f.write(code)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, o, e) for r, (p, (o, e)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, "rank failed:\n" + "\n".join(
        f"rank {r}:\n{o}\n{e[-3000:]}" for r, o, e in bad)
    return [o for o, _ in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    inp = _inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    assert "ok" in run_subprocess(_JAX.format(tmp=tmp, S=S), devices=8)
    _run_ranks(_RANKS, tmp)
    jax_out = dict(np.load(os.path.join(tmp, "jax_out.npz")))
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(WORLD)]
    with open(os.path.join(tmp, "jax_report.json")) as f:
        jrep = json.load(f)
    reps = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}_report.json")) as f:
            reps.append(json.load(f))
    return {"tmp": tmp, "inp": inp, "jax": jax_out, "ranks": ranks,
            "jax_report": jrep, "reports": reps}


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max())


@pytest.mark.parametrize("fb", ["0", "1"])
def test_compressed_psum_mean_equals_jax_shard_map_bit_for_bit(runs, fb):
    """fb 0: no error feedback, over the process group; fb 1: with
    ``err``, over a ``(DeviceMesh, "pod")`` pair.  Every rank's mean
    equals JAX's on that device, bit for bit."""
    want = runs["jax"][f"psum_m{fb}"]
    for r, got in enumerate(runs["ranks"]):
        assert got[f"psum_m{fb}"].dtype == np.float32
        assert _ulps(got[f"psum_m{fb}"], want[r]) == 0, (fb, r)


@pytest.mark.parametrize("fb", ["0", "1"])
def test_compressed_psum_residual_against_jax_ulp_gap_stated(runs, fb):
    """The residual ``gf - q * scale`` is not bit-equal to JAX's: XLA:CPU
    contracts the product and the difference into one fused multiply-add
    (one rounding), while the port rounds ``q * scale`` first, as
    ``compress_grads`` does in both packages.  The gap is at most half an
    ulp of ``q * scale`` (printed: the largest gap in those ulps); the
    residual is small against the product, so in the residual's own ulps
    it is large, and a residual near zero may even change sign.  Both
    sides are pinned exactly: the port's equals the unfused f32
    arithmetic in numpy, JAX's the single-rounded one."""
    inp = runs["inp"]
    gall = inp["g"] + (inp["e"] if fb == "1" else 0)
    amax = np.float32(np.abs(gall).max())
    scale = np.float32(max(amax / np.float32(127), np.float32(1e-30)))
    gap = 0.0
    for r, got in enumerate(runs["ranks"]):
        gf = gall[r].astype(np.float32)
        q = np.clip(np.round(gf / scale), -127, 127).astype(np.float32)
        prod = (q * scale).astype(np.float32)
        unfused = gf - prod
        fused = (gf.astype(np.float64)
                 - q.astype(np.float64) * np.float64(scale)).astype(
                     np.float32)
        port, jax_e = got[f"psum_e{fb}"], runs["jax"][f"psum_e{fb}"][r]
        assert _ulps(port, unfused) == 0, (fb, r)
        assert _ulps(jax_e, fused) == 0, (fb, r)
        in_ulps = (np.abs(port.astype(np.float64) - jax_e)
                   / np.spacing(np.abs(prod)).astype(np.float64))
        assert in_ulps.max() <= 0.5, (fb, r)
        gap = max(gap, float(in_ulps.max()))
    print(f"feedback {fb}: largest gap to JAX's residual {gap} ulp of "
          "q * scale")
    assert gap > 0


def test_compressed_psum_is_the_mean_within_the_int8_step(runs):
    g = runs["inp"]["g"]
    got = runs["ranks"][0]["psum_m0"]
    rel = np.abs(got - g.mean(0)).max() / np.abs(g.mean(0)).max()
    assert rel < 0.05, rel


@pytest.mark.parametrize("form", ["pipe_plain", "pipe_dt"])
def test_pipeline_matches_jax_and_sequential(runs, form):
    inp = runs["inp"]
    ref = inp["mbs"].astype(np.float64)
    for s in range(S):
        ref = np.tanh(ref @ inp["Ws"][s])
    for got in runs["ranks"]:
        np.testing.assert_allclose(got[form], runs["jax"]["pipe"], atol=1e-5)
        np.testing.assert_allclose(got[form], ref, atol=1e-5)
        assert np.array_equal(got[form], got["pipe_plain"])


def test_sharded_save_writes_jax_arrays_and_template(runs):
    tmp = runs["tmp"]
    with np.load(os.path.join(tmp, "port", "step_3", "arrays.npz")) as z:
        got = {k: z[k] for k in z.files}
    with np.load(os.path.join(tmp, "jax4", "step_3", "arrays.npz")) as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    mans = []
    for d in ("port", "jax4"):
        with open(os.path.join(tmp, d, "step_3", "manifest.json")) as f:
            mans.append(json.load(f))
    assert mans[0]["template"] == mans[1]["template"]
    assert mans[0]["step"] == mans[1]["step"] == 3
    assert os.path.exists(os.path.join(tmp, "port", "step_3", "COMMITTED"))


@pytest.mark.parametrize("n", [2, 1])
def test_restore_onto_sub_mesh_gives_jax_shards(runs, n):
    jax_out = runs["jax"]
    n_checked = 0
    for r, got in enumerate(runs["ranks"]):
        for part in ("params", "mu", "nu"):
            for name in ("w", "b", "s"):
                local = got[f"r{n}/{part}/{name}"]
                if r >= n:                  # outside the target mesh
                    assert local.size == 0, (n, r, part, name)
                    continue
                want = jax_out[f"r{n}/{part}/{name}/{r}"]
                assert np.array_equal(local, want), (n, r, part, name)
                n_checked += 1
        if r < n:
            assert int(got[f"r{n}/step"]) == 3
    assert n_checked == 9 * n


def test_jax_8_device_checkpoint_restores_on_4_ranks(runs):
    inp = runs["inp"]
    for r, got in enumerate(runs["ranks"]):
        for tag in ("j8", "into"):
            for part, src in (("params", "p"), ("mu", "mu"), ("nu", "nu")):
                for name in ("w", "b"):
                    want = np.split(inp[f"{src}/{name}"], WORLD)[r]
                    assert np.array_equal(got[f"{tag}/{part}/{name}"],
                                          want), (tag, r, part, name)
                assert np.array_equal(got[f"{tag}/{part}/s"],
                                      inp[f"{src}/s"])   # replicated
            assert int(got[f"{tag}/step"]) == 3


def test_remesh_from_4_ranks_to_2(runs):
    inp = runs["inp"]
    for r, got in enumerate(runs["ranks"]):
        for part, src in (("params", "p"), ("mu", "mu"), ("nu", "nu")):
            local = got[f"m2/{part}/w"]
            if r >= 2:
                assert local.size == 0
            else:
                assert np.array_equal(local, np.split(inp[f"{src}/w"],
                                                      2)[r])


def test_run_with_recovery_with_shardings_matches_jax(runs):
    for rep in runs["reports"]:
        assert rep == runs["jax_report"]
    failures, restores, steps_run, final_step = runs["jax_report"]
    assert (failures, restores, final_step) == (2, 2, 30) and steps_run > 30
    jax_out = runs["jax"]
    for got in runs["ranks"]:
        for k in jax_out:
            if not k.startswith("rec/"):
                continue
            w, g = jax_out[k], got[k]
            rel = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert rel <= 1e-6, (k, rel)


def test_group_refuses_what_it_cannot_run(tmp_path):
    from repro_torch.distributed import group
    from repro_torch.launch.mesh import make_device_mesh
    with pytest.raises(ValueError):
        group.init(0, 1, str(tmp_path / "store"), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            group.init(0, 1, str(tmp_path / "store"))
    with pytest.raises(RuntimeError):
        make_device_mesh((1,), ("data",), device="cpu")   # no group formed
    group.destroy()                                      # a no-op
