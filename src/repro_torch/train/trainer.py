"""Fault-tolerant training loop.

Counterpart of ``repro/train/trainer.py``:
  * a checkpoint every ``checkpoint_every`` steps through the
    CheckpointManager (atomic, keep-k, optional SZx compression, async);
  * automatic restart: on a step failure the loop restores the latest
    committed checkpoint and replays the data stream from that step (the
    pipeline is deterministic), at most ``max_restarts`` times;
  * stragglers: steps slower than ``straggler_factor`` x the trailing
    median are recorded;
  * elastic restore: checkpoints hold whole leaves, so a run can resume
    on another mesh or card count -- ``CheckpointManager.restore(...,
    shardings=)`` gives each rank its shard of every leaf;
  * the loss / grad-norm history.
A step ends when its loss is on the host (a synchronize of the loss's
device, made with telemetry on or off); with telemetry on, the
``train.step`` span covers the step and that synchronize, and each step
adds to ``train.steps`` and ``train.step_seconds``.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    checkpoint_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 32
    log_every: int = 10               # configuration only, as in the reference


class Trainer:
    def __init__(
        self,
        cfg: TrainerConfig,
        step_fn: Callable,                    # (state, batch) -> (state, metrics)
        batch_fn: Callable[[int], Any],       # step -> batch (deterministic)
        ckpt: CheckpointManager,
        *,
        fault_hook: Optional[Callable[[int], None]] = None,  # test injection
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.fault_hook = fault_hook
        self.history: list[dict] = []
        self.step_times: list[float] = []
        self.straggler_steps: list[int] = []
        self.restarts = 0

    def _maybe_flag_straggler(self, step: int, dt: float) -> None:
        w = self.step_times[-self.cfg.straggler_window:]
        if len(w) >= 8:
            med = statistics.median(w)
            if dt > self.cfg.straggler_factor * med:
                self.straggler_steps.append(step)

    def run(self, state) -> Any:
        cfg = self.cfg
        start = self.ckpt.latest_step()
        step = 0
        if start is not None:
            state, step = self.ckpt.restore(state, start)
            step += 1

        while step < cfg.total_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.batch_fn(step)
                t0 = time.perf_counter()
                with obs.span("train.step", step=step):
                    state, metrics = self.step_fn(state, batch)
                    loss = metrics["loss"]
                    if isinstance(loss, torch.Tensor) and loss.device.type == "cuda":
                        torch.cuda.synchronize(loss.device)
                dt = time.perf_counter() - t0
                if obs.enabled():
                    obs.counter("train.steps").inc()
                    obs.histogram("train.step_seconds").observe(dt)
                self._maybe_flag_straggler(step, dt)
                self.step_times.append(dt)
                rec = {
                    "step": step,
                    "loss": float(loss),
                    "grad_norm": float(metrics.get("grad_norm", 0.0)),
                    "dt": dt,
                }
                self.history.append(rec)
                if not math.isfinite(rec["loss"]):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                if step % cfg.checkpoint_every == 0 and step > 0:
                    self.ckpt.save(step, state)
                step += 1
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                self.restarts += 1
                if self.restarts > cfg.max_restarts:
                    raise RuntimeError(f"exceeded max_restarts={cfg.max_restarts}") from e
                latest = self.ckpt.latest_step()
                if latest is None:
                    # nothing committed yet: restarting from the initial state
                    # is the caller's job
                    raise
                state, restored = self.ckpt.restore(state, latest)
                step = restored + 1
        if self.ckpt.async_save:
            self.ckpt.wait()
        self.ckpt.save(cfg.total_steps - 1, state)
        return state
