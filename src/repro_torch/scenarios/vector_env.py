"""Struct-of-arrays vectorized environments.

`VectorEnv` resets and steps B independent instances of a batched `envs.Env`
— per-slot tasks, actuator masks AND dynamics parameters — with the batch in
the leading axis of every `VecEnvState` leaf, the same layout the fleet
engine uses for its ``(B, N, M)`` weight pool.  The per-slot ``params`` leaf
is what lets `scenarios.perturb` shift dynamics mid-episode as data.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.snn import resolve_device
from repro_torch.envs.base import Env, EnvState


class VecEnvState(NamedTuple):
    """B independent env states as a struct of arrays (+ per-slot params)."""

    phys: torch.Tensor           # (B, phys_dim) float32
    task: torch.Tensor           # (B, task_dim) float32
    actuator_mask: torch.Tensor  # (B, act_dim) float32
    t: torch.Tensor              # (B,) int32
    params: torch.Tensor         # (B, P) float32 — Env.PARAM_NAMES values

    def env_state(self) -> EnvState:
        return EnvState(self.phys, self.task, self.actuator_mask, self.t)


@dataclasses.dataclass(frozen=True)
class VectorEnv:
    """B instances of ``env`` stepped as one batch.  ``tasks`` / ``masks`` /
    ``params`` default to train task 0 / all-healthy / `default_params`,
    broadcast to every slot."""

    env: Env
    batch: int

    def reset(self, generator: torch.Generator,
              tasks: Optional[torch.Tensor] = None,
              actuator_mask: Optional[torch.Tensor] = None,
              params: Optional[torch.Tensor] = None,
              device=None) -> VecEnvState:
        """Reset all B slots, drawing the initial physics from
        ``generator`` (an int seeds a new generator on ``device``;
        ``device=None`` is the card)."""
        if isinstance(generator, int):
            generator = torch.Generator(resolve_device(device)) \
                .manual_seed(generator)
        device = generator.device
        b = self.batch
        phys = self.env.init_phys(b, generator).float()
        if tasks is None:
            tasks = self.env.train_tasks()[0]
        tasks = torch.as_tensor(tasks, dtype=torch.float32).to(device)
        if tasks.ndim == 1:
            tasks = tasks[None]
        tasks = tasks.expand(b, tasks.shape[1]).contiguous()
        if actuator_mask is None:
            actuator_mask = torch.ones(self.env.act_dim)
        actuator_mask = torch.as_tensor(actuator_mask, dtype=torch.float32)
        # a (act_dim,) mask means this mask in EVERY slot (not per-slot
        # scalars, whatever B is)
        actuator_mask = actuator_mask.to(device).expand(
            b, self.env.act_dim).contiguous()
        if params is None:
            params = self.env.default_params()
        params = torch.as_tensor(params, dtype=torch.float32).to(device)
        params = params.expand(b, len(self.env.PARAM_NAMES)).contiguous()
        return VecEnvState(phys=phys, task=tasks, actuator_mask=actuator_mask,
                           t=torch.zeros(b, dtype=torch.int32, device=device),
                           params=params)

    def observe(self, state: VecEnvState) -> torch.Tensor:
        """(B, obs_dim) observations."""
        return self.env.observe(state.env_state())

    def step(self, state: VecEnvState, actions: torch.Tensor
             ) -> tuple[VecEnvState, torch.Tensor]:
        """Step all B slots with (B, act_dim) actions; returns (state, (B,) r)."""
        st, r = self.env.step(state.env_state(), actions, params=state.params)
        return state._replace(phys=st.phys, t=st.t), r
