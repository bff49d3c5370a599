"""Environment interface: batched reset/step functions over tensor state.

Every env of the port steps B independent instances at once: each
`EnvState` field carries the batch in its leading axis (the JAX reference
writes one instance and vmaps it).  Leaves are float32 (phys, task,
actuator_mask) or int32 (t).

Dynamics parameters are data: each env names its perturbable constants in
``PARAM_NAMES`` and `dynamics` takes them as a ``(B, P)`` tensor, so a
scenario shifts dynamics per slot and per step without a new env object.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class EnvState(NamedTuple):
    phys: torch.Tensor           # (B, phys_dim) float32
    task: torch.Tensor           # (B, task_dim) direction / velocity / goal
    actuator_mask: torch.Tensor  # (B, act_dim) 1 = healthy, 0 = failed
    t: torch.Tensor              # (B,) int32 step counter


@dataclasses.dataclass(frozen=True)
class Env:
    """Subclasses define obs_dim/act_dim and the batched methods below."""

    episode_len: int = 200
    dt: float = 0.05

    obs_dim: int = 0
    act_dim: int = 0

    # Perturbable dynamics parameters, in the order `default_params` packs
    # them.
    PARAM_NAMES: tuple = ()

    def init_phys(self, batch: int,
                  generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def dynamics(self, phys: torch.Tensor, force: torch.Tensor,
                 params: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def observe(self, state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    def reward(self, state: EnvState, action: torch.Tensor,
               new_phys: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def train_tasks(self) -> torch.Tensor:
        raise NotImplementedError

    def eval_tasks(self) -> torch.Tensor:
        raise NotImplementedError

    # --- common ------------------------------------------------------------
    def default_params(self) -> torch.Tensor:
        """The ``PARAM_NAMES`` fields packed as a float32 ``(P,)`` vector."""
        return torch.tensor([getattr(self, n) for n in self.PARAM_NAMES],
                            dtype=torch.float32)

    def param_index(self, name: str) -> int:
        try:
            return self.PARAM_NAMES.index(name)
        except ValueError:
            raise ValueError(
                f"{type(self).__name__} has no dynamics parameter {name!r}; "
                f"perturbable params are {self.PARAM_NAMES}") from None

    def _params(self, phys: torch.Tensor,
                params: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, P) parameters: the given ones or the static defaults."""
        if params is None:
            params = self.default_params().to(phys.device)
        return params.expand(phys.shape[0], len(self.PARAM_NAMES))

    def step(self, state: EnvState, action: torch.Tensor,
             params: Optional[torch.Tensor] = None
             ) -> tuple[EnvState, torch.Tensor]:
        """Returns (new_state, (B,) reward).  Actions in [-1, 1]."""
        act = torch.clamp(action, -1.0, 1.0) * state.actuator_mask
        new_phys = self.dynamics(state.phys, act, params)
        new_state = EnvState(phys=new_phys, task=state.task,
                             actuator_mask=state.actuator_mask,
                             t=state.t + 1)
        return new_state, self.reward(state, act, new_phys)
