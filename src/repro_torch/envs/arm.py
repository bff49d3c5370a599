"""Payload-arm task: a 2-DOF gravity-loaded arm with a variable tip payload.

A torque-controlled 2-link planar arm (like `ReacherEnv`) with in-plane
gravity and a payload mass at the tip.  The payload adds inertia and a
configuration-dependent gravity torque, so a payload change mid-episode is
a persistent disturbance: a frozen controller sags to a steady-state error
while a plastic one keeps integrating the error away (pick-and-place with
an unknown load).

8 training goals and 72 unseen eval goals on a frontal arc.

Perturbable dynamics params (`PARAM_NAMES`): payload, gain, damping.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.envs.base import Env, EnvState
from repro_torch.envs.reacher import arm_observe, arm_reward


@dataclasses.dataclass(frozen=True)
class ArmEnv(Env):
    episode_len: int = 150
    dt: float = 0.05
    obs_dim: int = 11     # sin/cos q(4), dq(2), goal(2), goal-tip(2), 1
    act_dim: int = 2
    link: float = 0.5
    damping: float = 1.2
    gain: float = 3.0
    payload: float = 0.0  # tip mass (adds inertia + gravity torque)
    gravity: float = 2.0  # in-plane gravity (toy scale), pulls along -y

    PARAM_NAMES: tuple = ("payload", "gain", "damping")

    def init_phys(self, batch: int,
                  generator: torch.Generator) -> torch.Tensor:
        # phys = [q1, q2, dq1, dq2]; start mid-workspace, elbow down
        noise = 0.1 * torch.randn(batch, 2, generator=generator,
                                  device=generator.device)
        q0 = torch.tensor([0.4, -0.8], device=noise.device) + noise
        return torch.cat([q0, torch.zeros_like(q0)], dim=1)

    def dynamics(self, phys: torch.Tensor, force: torch.Tensor,
                 params: Optional[torch.Tensor] = None) -> torch.Tensor:
        p = self._params(phys, params)
        payload, gain, damping = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        q, dq = phys[:, :2], phys[:, 2:]
        # gravity torque of the tip payload about each joint (moment arm =
        # horizontal distance from the joint to the tip)
        r1 = self.link * (torch.cos(q[:, 0]) + torch.cos(q[:, 0] + q[:, 1]))
        r2 = self.link * torch.cos(q[:, 0] + q[:, 1])
        tau_g = -self.gravity * payload * torch.stack([r1, r2], dim=1)
        inertia = 1.0 + payload
        ddq = (gain * force + tau_g - damping * dq) / inertia
        dq = dq + self.dt * ddq
        q = q + self.dt * dq
        return torch.cat([q, dq], dim=1)

    def observe(self, state: EnvState) -> torch.Tensor:
        return arm_observe(self.link, state)

    def reward(self, state: EnvState, action: torch.Tensor,
               new_phys: torch.Tensor) -> torch.Tensor:
        return arm_reward(self.link, state, action, new_phys)

    def _goals(self, n: int, phase: float) -> torch.Tensor:
        # frontal arc (+-60 deg): the fixed error->torque wiring of a
        # linear controller is only sign-consistent in the front workspace
        ang = (torch.arange(n, dtype=torch.float32) + phase) * (
            (2 * math.pi / 3) / n) - math.pi / 3
        r = 1.4 * self.link
        return torch.stack([r * torch.cos(ang), r * torch.sin(ang)], dim=1)

    def train_tasks(self) -> torch.Tensor:
        return self._goals(8, 0.0)

    def eval_tasks(self) -> torch.Tensor:
        return self._goals(72, 0.5)
