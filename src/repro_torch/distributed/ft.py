"""Fault tolerance: NaN sentinel + rollback, straggler monitor, resume.

  * `FaultTolerantRunner` wraps any step function.  Every step's loss is
    checked by a NaN/inf sentinel; a poisoned step triggers rollback to the
    last good checkpoint, skipping the poisoned data batch (the batch index
    advances past it, which the deterministic pipeline makes exact).
  * `StragglerMonitor` keeps a per-step wall-time EWMA and flags steps
    slower than mean + k * std.

The runner and the monitor accept an `obs.MetricsRegistry`: resume,
rollback and straggler events and step times land in its counters and
histogram.  The runner trains on one card: a checkpoint restores onto the
device of the state it replaces.  `elastic_restore` places a checkpoint on
another mesh's shards instead (the session pools' `load_pool` re-mesh).

The port's step functions update their state in place (the optimizer,
`launch.steps.make_train_step`); a rollback restores every leaf from the
checkpoint, so the poisoned state in place is never read again.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten, load_checkpoint
from repro_torch.obs import MetricsRegistry


def loss_is_bad(loss) -> bool:
    """Host-side NaN/inf sentinel: True if ANY element is non-finite.

    Accepts scalars, arrays or tensors (per-shard or per-session loss
    vectors report one value per slot): one poisoned element poisons the
    step like one poisoned scalar."""
    if isinstance(loss, torch.Tensor):
        loss = loss.detach().float().cpu().numpy()
    return not bool(np.isfinite(np.asarray(loss, dtype=np.float64)).all())


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags outliers that exceed BOTH
    mean + k*std and (1 + rel_min)*mean — the relative floor stops noise
    flags when the variance is tiny (lock-step SPMD steps)."""

    alpha: float = 0.1
    k: float = 3.0
    rel_min: float = 0.2
    warmup: int = 5

    mean: float = 0.0
    var: float = 0.0          # VARIANCE estimate (not a Welford M2 sum)
    n: int = 0
    flagged: int = 0
    _m2: float = 0.0          # Welford sum of squared deviations (warmup)

    def observe(self, dt: float) -> bool:
        """Record one step time; returns True if it is a straggler event."""
        self.n += 1
        # var must be a sample variance by the time the flag branch reads
        # it, which takes at least two observations — clamp the warmup so a
        # warmup=0/1 monitor can't flag off a zero (1e-9) std.
        warmup = max(self.warmup, 2)
        if self.n <= warmup:
            # Welford priming: _m2 accumulates the sum of squared
            # deviations; var is its unbiased sample-variance view.  (The
            # historical code kept the M2 SUM in `var` and divided by the
            # ever-growing n-1 after warmup, while the EWMA below mixed
            # squared deviations into the same field — biasing std low and
            # shrinking it further every step.)
            d = dt - self.mean
            self.mean += d / self.n
            self._m2 += d * (dt - self.mean)
            self.var = self._m2 / max(self.n - 1, 1)
            return False
        std = max(self.var ** 0.5, 1e-9)
        is_straggler = (dt > self.mean + self.k * std
                        and dt > (1.0 + self.rel_min) * self.mean)
        if is_straggler:
            self.flagged += 1
        # EWMA update (outliers damped so one straggler doesn't poison stats)
        w = self.alpha if not is_straggler else self.alpha * 0.1
        self.mean = (1 - w) * self.mean + w * dt
        self.var = (1 - w) * self.var + w * (dt - self.mean) ** 2
        return is_straggler


class FaultTolerantRunner:
    """Checkpoint/restart + NaN rollback + straggler accounting around a step.

    step_fn(state, batch) -> (state, metrics).  ``state`` is any tree that
    fully determines training (params, optimizer state).  Batches come
    from a step-indexed pipeline so replay after rollback is
    deterministic.
    """

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 save_every: int = 100, max_rollbacks: int = 3,
                 registry: Optional[MetricsRegistry] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_rollbacks = max_rollbacks
        self.monitor = StragglerMonitor()
        self.rollbacks = 0
        self.skipped_steps: list[int] = []
        self.events: list[dict] = []
        self.metrics = registry
        if registry is not None:
            self._m_rollbacks = registry.counter("ft_rollbacks_total")
            self._m_stragglers = registry.counter("ft_stragglers_total")
            self._m_resumes = registry.counter("ft_resumes_total")
            self._m_step_s = registry.histogram("ft_step_seconds")
        else:
            self._m_rollbacks = self._m_stragglers = None
            self._m_resumes = self._m_step_s = None

    @staticmethod
    def _device(state):
        leaves = [t for t in flatten(state)[1] if isinstance(t, torch.Tensor)]
        return leaves[0].device if leaves else None

    def _restore(self, state):
        return self.ckpt.restore(state, device=self._device(state))

    def restore_or_init(self, state):
        """Resume from the latest checkpoint if one exists."""
        if self.ckpt.latest_step() is not None:
            state, step, _ = self._restore(state)
            self.events.append({"kind": "resume", "step": step})
            if self._m_resumes is not None:
                self._m_resumes.inc()
            return state, step
        return state, 0

    def run(self, state, batches: Callable[[int], Any], num_steps: int,
            start_step: int = 0, log_every: int = 0):
        """Drive `num_steps` steps with checkpointing and rollback.

        batches(step) -> batch (deterministic, step-indexed).
        Returns (state, history list of metric dicts).
        """
        history = []
        step = start_step
        if self.ckpt.latest_step() is None:
            self.ckpt.save(step, state, blocking=True)

        while step < num_steps:
            if step in self.skipped_steps:
                step += 1            # poisoned batch — do not replay it
                continue
            t0 = time.perf_counter()
            new_state, metrics = self.step_fn(state, batches(step))
            loss = metrics["loss"]
            loss = (float(loss) if isinstance(loss, torch.Tensor)
                    and loss.numel() == 1 else loss)          # sync point
            dt = time.perf_counter() - t0

            if loss_is_bad(loss):
                # Rollback: reload the last good checkpoint, replay the
                # deterministic batches after it, and SKIP the poisoned one
                # (the skip set is consulted at the top of the loop).
                self.rollbacks += 1
                self.events.append({"kind": "rollback", "step": step,
                                    "loss": float(np.asarray(
                                        loss, dtype=np.float64).ravel()[0])})
                if self._m_rollbacks is not None:
                    self._m_rollbacks.inc()
                if self.rollbacks > self.max_rollbacks:
                    raise RuntimeError(
                        f"{self.rollbacks} rollbacks exceed budget; aborting")
                state, good_step, _ = self._restore(state)
                self.skipped_steps.append(step)
                step = min(good_step, step)
                continue

            if self._m_step_s is not None:
                self._m_step_s.observe(dt)
            if self.monitor.observe(dt):
                self.events.append({"kind": "straggler", "step": step,
                                    "dt": dt, "mean": self.monitor.mean})
                if self._m_stragglers is not None:
                    self._m_stragglers.inc()

            state = new_state
            step += 1
            history.append({"step": step, "loss": float(loss), "dt": dt})
            if log_every and step % log_every == 0:
                print(f"step {step}: loss={float(loss):.4f} dt={dt*1e3:.1f}ms")
            if step % self.save_every == 0:
                self.ckpt.save(step, state, blocking=False)

        self.ckpt.save(num_steps, state, blocking=True)
        return state, history


def elastic_restore(ckpt_dir: str, tree_like, new_mesh, sharding_fn,
                    step: Optional[int] = None):
    """Restore a checkpoint onto a DIFFERENT mesh (elastic scaling).

    ``sharding_fn(mesh)`` -> a tree of placements matching ``tree_like``
    (`distributed.sharding.pool_shardings`).  Checkpoint leaves are stored
    whole, so this is a pure re-layout: any mesh whose shards divide the
    slot axes works.  Returns ``(tree, step, extra)``."""
    return load_checkpoint(ckpt_dir, tree_like, step=step,
                           shardings=sharding_fn(new_mesh))
