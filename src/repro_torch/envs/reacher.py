"""Position-generalization task (Brax `ur5e` stand-in).

A torque-controlled 2-link planar arm reaching toward goal positions sampled
in the workspace annulus.  Train goals: 8 fixed positions; eval: 72 unseen.

Perturbable dynamics params (`PARAM_NAMES`): damping, gain.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.envs.base import Env, EnvState


def tip(link: float, q: torch.Tensor) -> torch.Tensor:
    """(B, 2) tip position of a 2-link arm of equal ``link`` lengths at
    joint angles ``q`` (B, 2)."""
    q1, q12 = q[:, 0], q[:, 0] + q[:, 1]
    return torch.stack([link * (torch.cos(q1) + torch.cos(q12)),
                        link * (torch.sin(q1) + torch.sin(q12))], dim=1)


def arm_observe(link: float, state: EnvState) -> torch.Tensor:
    """[sin q(2), cos q(2), dq(2), goal(2), goal - tip(2), 1]."""
    q, dq = state.phys[:, :2], state.phys[:, 2:]
    goal = state.task
    return torch.cat([torch.sin(q), torch.cos(q), dq, goal,
                      goal - tip(link, q), torch.ones_like(q[:, :1])], dim=1)


def arm_reward(link: float, state: EnvState, action: torch.Tensor,
               new_phys: torch.Tensor) -> torch.Tensor:
    """-|tip - goal| - 0.01 |action|^2 (the norm as the square root of the
    sum of squares, in float32)."""
    d = tip(link, new_phys[:, :2]) - state.task
    dist = torch.sqrt((d * d).sum(dim=1))
    return -dist - 0.01 * (action ** 2).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class ReacherEnv(Env):
    episode_len: int = 150
    dt: float = 0.05
    obs_dim: int = 11     # sin/cos q(4), dq(2), goal(2), tip-goal(2), 1
    act_dim: int = 2
    link: float = 0.5
    damping: float = 1.0
    gain: float = 2.0

    PARAM_NAMES: tuple = ("damping", "gain")

    def init_phys(self, batch: int,
                  generator: torch.Generator) -> torch.Tensor:
        # phys = [q1, q2, dq1, dq2]
        q0 = 0.1 * torch.randn(batch, 2, generator=generator,
                               device=generator.device)
        return torch.cat([q0, torch.zeros_like(q0)], dim=1)

    def dynamics(self, phys: torch.Tensor, force: torch.Tensor,
                 params: Optional[torch.Tensor] = None) -> torch.Tensor:
        p = self._params(phys, params)
        damping, gain = p[:, 0:1], p[:, 1:2]
        q, dq = phys[:, :2], phys[:, 2:]
        ddq = gain * force - damping * dq
        dq = dq + self.dt * ddq
        q = q + self.dt * dq
        return torch.cat([q, dq], dim=1)

    def observe(self, state: EnvState) -> torch.Tensor:
        return arm_observe(self.link, state)

    def reward(self, state: EnvState, action: torch.Tensor,
               new_phys: torch.Tensor) -> torch.Tensor:
        return arm_reward(self.link, state, action, new_phys)

    def _goals(self, n: int, phase: float) -> torch.Tensor:
        ang = (torch.arange(n, dtype=torch.float32) + phase) * (
            2 * math.pi / n)
        r = 0.7 * self.link * 2 * 0.5 + 0.35  # mid-workspace ring
        return torch.stack([r * torch.cos(ang), r * torch.sin(ang)], dim=1)

    def train_tasks(self) -> torch.Tensor:
        return self._goals(8, 0.0)

    def eval_tasks(self) -> torch.Tensor:
        return self._goals(72, 0.5)
