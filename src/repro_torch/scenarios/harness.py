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

The rewards feed `scenarios.metrics.adaptation_metrics`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import snn
from repro_torch.envs.base import Env
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

    def init_net(self, device=None) -> snn.NetworkState:
        """Fleet controller state: zero weights, one set per slot (the rule
        builds the connectivity)."""
        return snn.init_state(self.scfg, batch=self.batch, fleet=True,
                              device=device)

    def rollout(self, net: snn.NetworkState, vstate: VecEnvState, theta,
                schedule: P.Schedule, freeze: int,
                generator: Optional[torch.Generator] = None
                ) -> RolloutResult:
        """The loop itself, from given controller and env states: `steps`
        env steps, one fused controller window each.  ``generator`` draws
        the sensor noise of the schedule (unused without `SensorNoise`)."""
        theta = list(theta)
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
            actuator_mask: Optional[torch.Tensor] = None,
            device=None) -> RolloutResult:
        """One closed-loop rollout of `steps` env steps for all B slots.

        theta: per-layer rule list, or the flat vector `snn.flatten_theta`
        produces.  ``seed`` draws the env reset (and any sensor noise).
        ``freeze_at``: env step from which plasticity is gated off (None =
        never; 0 = fully frozen).  ``schedule``: compiled perturbations
        (None = clean episode).  ``device=None`` is the card.
        """
        device = snn.resolve_device(device)
        if isinstance(theta, torch.Tensor) and theta.ndim == 1:
            theta = snn.unflatten_theta(self.scfg, theta)
        theta = [th.to(device) for th in theta]
        generator = torch.Generator(device).manual_seed(seed)
        vstate = self.venv.reset(generator,
                                 tasks=self.init_tasks(tasks, device),
                                 actuator_mask=actuator_mask)
        net = self.init_net(device=device)
        if schedule is None:
            schedule = P.empty_schedule(self.env, self.batch, device)
        freeze = self.steps + 1 if freeze_at is None else freeze_at
        return self.rollout(net, vstate, theta, schedule, freeze, generator)


def make_closed_loop(env: Env, scfg: snn.SNNConfig, *, batch: int,
                     steps: int) -> ClosedLoop:
    """Prepare the closed loop for (env, controller, B, steps)."""
    return ClosedLoop(env=env, scfg=scfg, batch=batch, steps=steps,
                      venv=VectorEnv(env, batch))

