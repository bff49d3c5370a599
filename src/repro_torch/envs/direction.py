"""Direction-generalization task (Brax `ant` stand-in).

A planar body with 8 radial thrusters ("legs") at 45-degree spacing; each
pushes along its own fixed axis, dynamics are a damped point mass.  Reward
is velocity projected onto the target direction.  Train on 8 directions,
evaluate on 72 unseen headings.  Observation and action are both 8-wide:
the env of the paper's full-width 8-128-8 controller.

Perturbable dynamics params (`PARAM_NAMES`): mass, damping, gain.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.envs.base import Env, EnvState


def _unit_circle(angles: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(angles), torch.sin(angles)], dim=1)


@dataclasses.dataclass(frozen=True)
class DirectionEnv(Env):
    episode_len: int = 150
    dt: float = 0.05
    obs_dim: int = 8      # vel(2) + target_dir(2) + vel_err(2) + speed + 1
    act_dim: int = 8
    mass: float = 1.0
    damping: float = 1.5
    gain: float = 4.0

    PARAM_NAMES: tuple = ("mass", "damping", "gain")

    def _thruster_axes(self) -> torch.Tensor:
        return _unit_circle(torch.arange(8, dtype=torch.float32)
                            * (2 * math.pi / 8))            # (8, 2)

    def init_phys(self, batch: int,
                  generator: torch.Generator) -> torch.Tensor:
        # phys = [x, y, vx, vy]
        v0 = 0.05 * torch.randn(batch, 2, generator=generator,
                                device=generator.device)
        return torch.cat([torch.zeros_like(v0), v0], dim=1)

    def dynamics(self, phys: torch.Tensor, force: torch.Tensor,
                 params: Optional[torch.Tensor] = None) -> torch.Tensor:
        p = self._params(phys, params)
        mass, damping, gain = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        pos, vel = phys[:, :2], phys[:, 2:]
        # thrusters only push (rectified), like legs
        axes = self._thruster_axes().to(phys.device)
        f = gain * (torch.relu(force) @ axes)
        acc = f / mass - damping * vel
        vel = vel + self.dt * acc
        pos = pos + self.dt * vel
        return torch.cat([pos, vel], dim=1)

    def observe(self, state: EnvState) -> torch.Tensor:
        vel = state.phys[:, 2:]
        tdir = state.task                     # unit direction (B, 2)
        speed = torch.sqrt((vel ** 2).sum(dim=1, keepdim=True))
        return torch.cat([vel, tdir, tdir - vel, speed,
                          torch.ones_like(speed)], dim=1)

    def reward(self, state: EnvState, action: torch.Tensor,
               new_phys: torch.Tensor) -> torch.Tensor:
        vel, task = new_phys[:, 2:], state.task
        fwd = (vel * task).sum(dim=1)
        lateral = (vel[:, 0] * task[:, 1] - vel[:, 1] * task[:, 0]).abs()
        ctrl = 0.01 * (action ** 2).sum(dim=1)
        return fwd - 0.1 * lateral - ctrl

    def train_tasks(self) -> torch.Tensor:
        return _unit_circle(torch.arange(8, dtype=torch.float32)
                            * (2 * math.pi / 8))

    def eval_tasks(self) -> torch.Tensor:
        # 72 headings offset from every training heading
        return _unit_circle((torch.arange(72, dtype=torch.float32) + 0.5)
                            * (2 * math.pi / 72))
