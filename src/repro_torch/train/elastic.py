"""Fault tolerance on one device (port of ``repro.train.elastic``): the step
watchdog and checkpoint-based recovery.

  * ``StepWatchdog`` -- EMA of step wall-time; a step exceeding
    ``threshold x EMA`` fires the mitigation callback (counted and
    tested here).
  * ``run_with_recovery`` -- the training loop: train, checkpoint every k
    steps (async), on a simulated or real failure restore the last
    committed step and continue; exactly-once step semantics come from
    the step counter in the checkpoint.

``remesh`` (a state moved onto another mesh's shardings, the elastic
rescale) is part of the multi-device half (ROADMAP A.11(f)).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import TrainState


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
    watchdog: StepWatchdog | None = None,
) -> tuple[TrainState, RecoveryReport]:
    """Training loop with checkpoint/restart semantics.

    ``fail_at`` simulates hard failures AFTER the given step numbers:
    the in-memory state is discarded and the last committed checkpoint
    is restored (possibly replaying steps -- the exactly-once guarantee
    is on the checkpoint step counter, matching real preemption).  The
    checkpoint is copied into the live state's tensors in place
    (``checkpoint.restore_into``), so a model module stays the module
    that ``make_train_step`` steps.
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
                state, _ = ckpt_lib.restore_into(last, state)
                restores += 1
                i = int(state.step)   # replay from ckpt
                continue
        i += 1
    writer.wait()
    return state, RecoveryReport(
        steps_run=steps, failures=failures, restores=restores,
        final_step=int(state.step),
        straggler_flags=wd.stragglers)
