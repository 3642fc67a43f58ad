"""Fault tolerance and elasticity (port of ``repro.train.elastic``): the
step watchdog, the elastic remesh and checkpoint-based recovery.

  * ``StepWatchdog`` -- EMA of step wall-time; a step exceeding
    ``threshold x EMA`` fires the mitigation callback (counted and
    tested here).
  * ``remesh`` -- a state placed onto another mesh's shardings (scale up
    or down without retraining); with ``checkpoint.restore`` this is the
    elastic-recovery path (N ranks -> N - k and back).
  * ``run_with_recovery`` -- the training loop: train, checkpoint every k
    steps (async), on a simulated or real failure restore the last
    committed step and continue; exactly-once step semantics come from
    the step counter in the checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from torch import nn

from repro_torch.distributed.pspec import map_structure
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import TrainState, param_tree


@dataclasses.dataclass
class StepWatchdog:
    threshold: float = 3.0      # x EMA -> straggler
    ema_decay: float = 0.9
    warmup_steps: int = 2       # ignore the first (warm-up) steps
    ema: float = 0.0
    seen: int = 0
    stragglers: int = 0
    on_straggler: Callable[[int, float, float], None] | None = None

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step was flagged as a straggler."""
        self.seen += 1
        if self.seen <= self.warmup_steps:
            return False
        if self.ema == 0.0:
            self.ema = dt
            return False
        flagged = dt > self.threshold * self.ema
        if flagged:
            self.stragglers += 1
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
        else:
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        return flagged


def _remesh_leaf(x, sharding):
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh = sharding.mesh
    full = x.full_tensor() if isinstance(x, DTensor) else x
    # rank 0 (on every mesh the port builds) sends its copy, so a rank that
    # held an empty shard of a smaller source mesh still gets its shard
    return distribute_tensor(full.detach().to(mesh.device_type), mesh,
                             sharding.placements(), src_data_rank=0)


def remesh(state: TrainState, shardings: TrainState) -> TrainState:
    """``state`` placed onto ``shardings``' mesh (a ``TrainState``-shaped
    tree of ``NamedSharding`` on a runtime mesh): every leaf becomes a
    DTensor with the target's placements, read from a plain tensor or
    gathered from a DTensor on another mesh.  The target may be a
    sub-mesh of the group with fewer ranks; the ranks outside it then hold
    empty local shards (DTensor's rule).  Collective: every rank of the
    group calls it.  A module's parameters come back as a tree."""
    fix = lambda tree, sh: map_structure(_remesh_leaf, tree, sh)
    return TrainState(step=_remesh_leaf(state.step, shardings.step),
                      params=fix(param_tree(state.params), shardings.params),
                      mu=fix(state.mu, shardings.mu),
                      nu=fix(state.nu, shardings.nu))


@dataclasses.dataclass
class RecoveryReport:
    steps_run: int
    failures: int
    restores: int
    final_step: int
    straggler_flags: int


def run_with_recovery(
    step_fn: Callable[[TrainState, Any], tuple[TrainState, dict]],
    state: TrainState,
    batches,                       # iterable of batches
    *,
    ckpt_root: str,
    ckpt_every: int = 10,
    fail_at: set[int] | None = None,   # simulated failures (step numbers)
    shardings: TrainState | None = None,
    watchdog: StepWatchdog | None = None,
) -> tuple[TrainState, RecoveryReport]:
    """Training loop with checkpoint/restart semantics.

    ``fail_at`` simulates hard failures AFTER the given step numbers:
    the in-memory state is discarded and the last committed checkpoint
    is restored (possibly replaying steps -- the exactly-once guarantee
    is on the checkpoint step counter, matching real preemption).  A
    module state is restored in place (``checkpoint.restore_into``; each
    rank its local shards where the leaves are DTensors), so the module
    stays the one that ``make_train_step`` steps.  A tree state is
    restored onto ``shardings`` (a ``TrainState`` of ``NamedSharding`` on
    the target mesh) when given, else in place.  With DTensor leaves
    every rank of the group runs the loop.
    """
    writer = ckpt_lib.AsyncCheckpointer(ckpt_root)
    fail_at = set(fail_at or ())
    failures = restores = steps = 0
    wd = watchdog or StepWatchdog()
    batches = list(batches)
    i = 0
    while i < len(batches):
        t0 = time.perf_counter()
        state, _ = step_fn(state, batches[i])
        step = int(state.step)
        wd.observe(step, time.perf_counter() - t0)
        steps += 1
        if step % ckpt_every == 0:
            writer.save(state)
        if step in fail_at:
            fail_at.discard(step)
            failures += 1
            writer.wait()
            last = ckpt_lib.latest_committed(ckpt_root)
            if last is not None:
                if shardings is None or isinstance(state.params, nn.Module):
                    state, _ = ckpt_lib.restore_into(last, state)
                else:
                    state, _ = ckpt_lib.restore(last, shardings)
                restores += 1
                i = int(state.step)   # replay from ckpt
                continue
        i += 1
    writer.wait()
    return state, RecoveryReport(
        steps_run=steps, failures=failures, restores=restores,
        final_step=int(state.step),
        straggler_flags=wd.stragglers)
