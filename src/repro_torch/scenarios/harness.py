"""Closed-loop fleet adaptation harness.

`make_closed_loop` prepares a `ClosedLoop` that drives B vectorized env
instances (`VectorEnv`) against B plastic SNN controllers through the
engine's fleet path (``snn.controller_step`` -> ``engine.rollout`` with
``w (B, N, M)``): each env step's ``cfg.timesteps``-long SNN window is ONE
launch of the rollout kernel on the card.  Everything episode-varying —
tasks, actuator masks, dynamics parameters, perturbation schedules, the
plasticity freeze step — is data, so:

  * the same loop runs float32 and fixed point (`SNNConfig.quant`);
  * the plasticity-on vs frozen-weights ablation is the same loop with a
    different ``freeze_at``: theta is multiplied by zero from that step on
    (dw is linear in theta, and the stochastic round maps an exactly-zero
    dw to zero grid steps), which freezes the weights bit-exactly while the
    forward dynamics keep running.

The rewards feed `scenarios.metrics.adaptation_metrics`.  The anomaly
presets at the end corrupt a session's drive on the host, for the
session-health detectors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import manager as _ckpt
from repro_torch.core import snn
from repro_torch.envs.base import Env
from repro_torch.obs import MetricsRegistry, phase
from repro_torch.scenarios import perturb as P
from repro_torch.scenarios.vector_env import VectorEnv, VecEnvState


class RolloutResult(NamedTuple):
    rewards: torch.Tensor        # (steps, B) per-step env rewards
    actions: torch.Tensor        # (steps, B, act_dim)
    net: snn.NetworkState        # final fleet controller state
    env_state: VecEnvState       # final vectorized env state


@dataclasses.dataclass
class ClosedLoop:
    """A prepared closed-loop rollout of (env, controller, B, steps)."""

    env: Env
    scfg: snn.SNNConfig
    batch: int
    steps: int
    venv: VectorEnv
    metrics: MetricsRegistry = dataclasses.field(
        default_factory=MetricsRegistry)
    _signatures: set = dataclasses.field(default_factory=set)

    def compile_count(self) -> int:
        """Distinct static signatures (operand shapes, dtypes, devices) the
        loop has run: the recompile gate of the JAX reference, where each
        signature is one compiled program."""
        return len(self._signatures)

    def metrics_snapshot(self) -> dict:
        """JSON-able rollup of this harness's recorded runs (see `run`
        ``record=True``) plus the live compile count."""
        self.metrics.gauge(
            "closed_loop_compile_count",
            "executables compiled by the rollout program"
        ).set(self.compile_count())
        return self.metrics.snapshot()

    def init_tasks(self, tasks, device) -> torch.Tensor:
        """Resolve a task spec: None -> train task 0; int -> that train
        task; "train"/"eval" -> cycle the task set across slots; or an
        explicit (B, T) / (T,) tensor."""
        env = self.env
        if tasks is None:
            tasks = 0
        if isinstance(tasks, int):
            tasks = env.train_tasks()[tasks]
        elif isinstance(tasks, str):
            pool = env.train_tasks() if tasks == "train" else env.eval_tasks()
            tasks = pool[torch.arange(self.batch) % pool.shape[0]]
        tasks = torch.as_tensor(tasks, dtype=torch.float32).to(device)
        if tasks.ndim == 1:
            tasks = tasks[None]
        return tasks.expand(self.batch, tasks.shape[1]).contiguous()

    def init_net(self, w0: Optional[Sequence[torch.Tensor]] = None,
                 device=None) -> snn.NetworkState:
        """Fleet controller state: zero weights, one set per slot (the rule
        builds the connectivity); ``w0`` optionally seeds per-layer weights
        (the weight-trained baseline), broadcast across slots."""
        net = snn.init_state(self.scfg, batch=self.batch, fleet=True,
                             device=device)
        if w0 is None:
            return net
        if self.scfg.quant is not None:
            raise ValueError("w0 seeding is a float-mode feature; quantize "
                             "the state via snn.quantize_state instead")
        w = tuple(torch.as_tensor(wi).to(net.w[i]).expand(
            self.batch, *net.w[i].shape[1:]).contiguous()
            for i, wi in enumerate(w0))
        return dataclasses.replace(net, w=w)

    def rollout(self, net: snn.NetworkState, vstate: VecEnvState, theta,
                schedule: P.Schedule, freeze: int,
                generator: Optional[torch.Generator] = None
                ) -> RolloutResult:
        """The loop itself, from given controller and env states: `steps`
        env steps, one fused controller window each.  ``generator`` draws
        the sensor noise of the schedule (unused without `SensorNoise`)."""
        theta = list(theta)
        self._signatures.add(_ckpt.signature(net, vstate, theta, schedule))
        vs, st = vstate, net
        rewards, actions = [], []
        for t in range(self.steps):
            eff = P.effective_state(schedule, vs, t)
            obs = self.venv.observe(eff)
            obs = P.transform_obs(schedule, obs, t, generator)
            gate = 1.0 if t < freeze else 0.0
            st, action = snn.controller_step(
                self.scfg, st, [th * gate for th in theta], obs)
            stepped, r = self.venv.step(eff, action)
            # carry the BASE state forward (perturbations are re-derived
            # from the schedule each step, so they never compound)
            vs = vs._replace(phys=stepped.phys, t=stepped.t)
            rewards.append(r)
            actions.append(action)
        return RolloutResult(rewards=torch.stack(rewards),
                             actions=torch.stack(actions), net=st,
                             env_state=vs)

    def run(self, theta, seed: int, *, tasks=None,
            schedule: Optional[P.Schedule] = None,
            freeze_at: Optional[int] = None,
            w0: Optional[Sequence[torch.Tensor]] = None,
            actuator_mask: Optional[torch.Tensor] = None,
            record: bool = False, device=None) -> RolloutResult:
        """One closed-loop rollout of `steps` env steps for all B slots.

        theta: per-layer rule list, or the flat vector `snn.flatten_theta`
        produces.  ``seed`` draws the env reset (and any sensor noise).
        ``freeze_at``: env step from which plasticity is gated off (None =
        never; 0 = fully frozen).  ``schedule``: compiled perturbations
        (None = clean episode).  ``w0``: initial weights for every slot
        (`init_net`).  ``record=True`` also rolls the run up into
        ``self.metrics`` (rollout latency histogram, mean-reward gauge, run
        counter — the `metrics_snapshot` schema); recording waits for the
        result, so leave it off inside latency-sensitive loops.
        ``device=None`` is the card.
        """
        device = snn.resolve_device(device)
        if isinstance(theta, torch.Tensor) and theta.ndim == 1:
            theta = snn.unflatten_theta(self.scfg, theta)
        theta = [th.to(device) for th in theta]
        generator = torch.Generator(device).manual_seed(seed)
        vstate = self.venv.reset(generator,
                                 tasks=self.init_tasks(tasks, device),
                                 actuator_mask=actuator_mask)
        net = self.init_net(w0, device=device)
        if schedule is None:
            schedule = P.empty_schedule(self.env, self.batch, device)
        freeze = self.steps + 1 if freeze_at is None else freeze_at
        if not record:
            return self.rollout(net, vstate, theta, schedule, freeze,
                                generator)
        with self.metrics.histogram(
                "closed_loop_rollout_seconds",
                "wall-clock per recorded closed-loop rollout").time(), \
                phase("scenario.rollout"):
            res = self.rollout(net, vstate, theta, schedule, freeze,
                               generator)
            mean = float(res.rewards.mean())       # waits for the result
        self.metrics.counter(
            "closed_loop_rollouts_total", "recorded rollouts").inc()
        self.metrics.gauge(
            "closed_loop_mean_reward",
            "mean per-step reward over slots, last recorded rollout"
        ).set(mean)
        return res


def make_closed_loop(env: Env, scfg: snn.SNNConfig, *, batch: int,
                     steps: int) -> ClosedLoop:
    """Prepare the closed loop for (env, controller, B, steps)."""
    return ClosedLoop(env=env, scfg=scfg, batch=batch, steps=steps,
                      venv=VectorEnv(env, batch))


def run_closed_loop(env: Env, scfg: snn.SNNConfig, theta, seed: int, *,
                    batch: int, steps: int, **kwargs) -> RolloutResult:
    """One-shot convenience wrapper over `make_closed_loop(...).run(...)`."""
    return make_closed_loop(env, scfg, batch=batch, steps=steps).run(
        theta, seed, **kwargs)


# ---- session-health anomaly presets -----------------------------------------
#
# Deterministic host-side input corruptions for exercising the session-health
# detectors: each preset maps to the detector that should catch it.  They
# corrupt the drive a scheduler feeds a session, the way a faulty sensor or
# client would, outside the device-side loop.


@dataclasses.dataclass(frozen=True)
class AnomalyPreset:
    """One injectable input fault.

    kind: "drive_blowout" (drive scaled by `gain` — trips ewma_z / bound),
    "dead_input" (drive zeroed — activity collapses, trips dead), or
    "stuck_input" (drive frozen at a constant pattern — recorded channels
    stop moving, trips stuck).  `noise_std` adds deterministic per-step
    Gaussian noise on top (seeded, so runs are reproducible)."""

    kind: str
    gain: float = 1.0
    noise_std: float = 0.0

    def __post_init__(self):
        if self.kind not in ANOMALIES:
            raise ValueError(f"unknown anomaly kind {self.kind!r}; "
                             f"expected one of {sorted(ANOMALIES)}")


ANOMALIES = frozenset({"drive_blowout", "dead_input", "stuck_input"})


def inject_anomaly(preset: AnomalyPreset, drive, t: int, seed: int = 0):
    """Corrupt one session's drive vector at control step `t` (host-side).

    Returns a numpy float32 array of drive's shape.  Deterministic in
    (preset, drive, t, seed): the same fault stream replays exactly."""
    x = np.asarray(drive, np.float32)
    if preset.kind == "drive_blowout":
        out = x * np.float32(preset.gain)
    elif preset.kind == "dead_input":
        out = np.zeros_like(x)
    elif preset.kind == "stuck_input":
        # frozen pattern: derived from the seed only, NOT from (drive, t),
        # so every step presents the identical stuck value
        out = np.random.RandomState(seed).rand(*x.shape).astype(np.float32)
    else:  # pragma: no cover - __post_init__ rejects unknown kinds
        raise ValueError(preset.kind)
    if preset.noise_std > 0.0 and preset.kind != "stuck_input":
        rng = np.random.RandomState((seed * 1000003 + t) & 0x7FFFFFFF)
        out = out + rng.normal(0.0, preset.noise_std,
                               x.shape).astype(np.float32)
    return out
