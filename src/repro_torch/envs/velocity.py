"""Velocity-generalization task (Brax `halfcheetah` stand-in).

A 1-D runner driven by 4 actuators coupled through a gait phase oscillator;
drive saturates (tanh), so matching a target velocity needs a policy.  Train
on 8 target velocities in [0.5, 4.0], evaluate on 72 unseen ones.

Perturbable dynamics params (`PARAM_NAMES`): drag, gain, phase_rate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.envs.base import Env, EnvState


@dataclasses.dataclass(frozen=True)
class VelocityEnv(Env):
    episode_len: int = 150
    dt: float = 0.05
    obs_dim: int = 7      # v, v_target, v_err, sin/cos phase, |v_err|, 1
    act_dim: int = 4
    drag: float = 0.8
    gain: float = 3.0
    phase_rate: float = 4.0

    PARAM_NAMES: tuple = ("drag", "gain", "phase_rate")

    def init_phys(self, batch: int,
                  generator: torch.Generator) -> torch.Tensor:
        # phys = [x, v, phase]
        v0 = 0.05 * torch.randn(batch, generator=generator,
                                device=generator.device)
        z = torch.zeros_like(v0)
        return torch.stack([z, v0, z], dim=1)

    def dynamics(self, phys: torch.Tensor, force: torch.Tensor,
                 params: Optional[torch.Tensor] = None) -> torch.Tensor:
        drag, gain, phase_rate = self._params(phys, params).unbind(1)
        x, v, phase = phys.unbind(1)
        # gait coupling: alternating actuators are effective in alternating
        # phase halves
        s, c = torch.sin(phase), torch.cos(phase)
        gate = torch.stack([s, c, -s, -c], dim=1)
        drive = gain * torch.tanh((force * torch.relu(gate)).sum(dim=1))
        v = v + self.dt * (drive - drag * v)
        x = x + self.dt * v
        phase = phase + self.dt * phase_rate
        return torch.stack([x, v, phase], dim=1)

    def observe(self, state: EnvState) -> torch.Tensor:
        v, phase = state.phys[:, 1], state.phys[:, 2]
        vt = state.task[:, 0]
        err = vt - v
        return torch.stack([v, vt, err, torch.sin(phase), torch.cos(phase),
                            err.abs(), torch.ones_like(v)], dim=1)

    def reward(self, state: EnvState, action: torch.Tensor,
               new_phys: torch.Tensor) -> torch.Tensor:
        ctrl = 0.01 * (action ** 2).sum(dim=1)
        return -(new_phys[:, 1] - state.task[:, 0]).abs() - ctrl

    def train_tasks(self) -> torch.Tensor:
        return torch.linspace(0.5, 4.0, 8)[:, None]

    def eval_tasks(self) -> torch.Tensor:
        return torch.linspace(0.45, 4.15, 72)[:, None]
