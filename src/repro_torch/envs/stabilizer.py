"""Setpoint-stabilizer task (cartpole-style regulation with redundancy).

A 1-D cart holding a setpoint against drag and a wind force, driven by TWO
redundant bidirectional thrusters (net drive = their mean).  Under constant
wind a proportional controller holds a steady-state offset, so only a
controller that keeps adapting regains the setpoint — the scenario that
separates plastic from frozen control.

Perturbable dynamics params (`PARAM_NAMES`): mass, gain, drag, spring, wind.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.envs.base import Env, EnvState


@dataclasses.dataclass(frozen=True)
class StabilizerEnv(Env):
    episode_len: int = 150
    dt: float = 0.05
    obs_dim: int = 6      # err, v, err - v, |err|, setpoint, 1
    act_dim: int = 2      # redundant thrusters; net drive = mean
    mass: float = 1.0
    gain: float = 4.0
    drag: float = 1.5
    spring: float = 1.0   # restoring pull toward x = 0
    wind: float = 0.0     # constant force on the cart (dynamics shift)

    PARAM_NAMES: tuple = ("mass", "gain", "drag", "spring", "wind")

    def init_phys(self, batch: int,
                  generator: torch.Generator) -> torch.Tensor:
        # phys = [x, v]
        x0 = 0.2 * torch.randn(batch, generator=generator,
                               device=generator.device)
        return torch.stack([x0, torch.zeros_like(x0)], dim=1)

    def dynamics(self, phys: torch.Tensor, force: torch.Tensor,
                 params: Optional[torch.Tensor] = None) -> torch.Tensor:
        mass, gain, drag, spring, wind = self._params(phys, params).unbind(1)
        x, v = phys[:, 0], phys[:, 1]
        drive = gain * force.mean(dim=1)
        a = (drive + wind - spring * x - drag * v) / mass
        v = v + self.dt * a
        x = x + self.dt * v
        return torch.stack([x, v], dim=1)

    def observe(self, state: EnvState) -> torch.Tensor:
        x, v = state.phys[:, 0], state.phys[:, 1]
        sp = state.task[:, 0]
        err = sp - x
        return torch.stack([err, v, err - v, err.abs(), sp,
                            torch.ones_like(err)], dim=1)

    def reward(self, state: EnvState, action: torch.Tensor,
               new_phys: torch.Tensor) -> torch.Tensor:
        err = state.task[:, 0] - new_phys[:, 0]
        ctrl = 0.01 * (action ** 2).sum(dim=1)
        return -err.abs() - 0.02 * new_phys[:, 1] ** 2 - ctrl

    def train_tasks(self) -> torch.Tensor:
        return torch.linspace(-1.0, 1.0, 8)[:, None]

    def eval_tasks(self) -> torch.Tensor:
        return torch.linspace(-1.02, 1.02, 72)[:, None]
