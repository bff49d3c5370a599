"""Perturbation schedules: domain randomization as data.

A `Perturbation` is a small frozen spec (what happens, when, to which
fraction of the fleet).  `compile_schedule` turns a tuple of specs into a
`Schedule` of ``(K, B, ...)`` tensors with each slot's randomization already
drawn from a `torch.Generator`; applying it at step ``t`` is a few selects,
so the same closed-loop code serves every schedule.

Spec kinds: `ActuatorDropout`, `SensorNoise`, `ParamShift`, `GoalSwitch`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.envs.base import Env
from repro_torch.scenarios.vector_env import VecEnvState

NEVER = 2 ** 31 - 1   # onset for slots a spec does not hit (int32 max)


@dataclasses.dataclass(frozen=True)
class Perturbation:
    """Base spec: onset step, affected fleet fraction, per-slot onset jitter."""

    step: int = 0
    frac: float = 1.0   # fraction of slots hit (per-slot Bernoulli)
    jitter: int = 0     # per-slot onset delay drawn uniform in [0, jitter]


@dataclasses.dataclass(frozen=True)
class ActuatorDropout(Perturbation):
    k: int = 1                                   # actuators killed per slot
    mask: Optional[tuple] = None                 # explicit mask overrides k


@dataclasses.dataclass(frozen=True)
class SensorNoise(Perturbation):
    std: float = 0.1    # white-noise std added to every obs channel
    bias: float = 0.0   # per-slot fixed bias drawn uniform in [-bias, bias]


@dataclasses.dataclass(frozen=True)
class ParamShift(Perturbation):
    param: str = "gain"
    scale: float = 1.0  # multiplier on the named parameter
    add: float = 0.0    # additive shift (applied after the multiplier)
    spread: float = 0.0  # per-slot relative jitter on scale/add (uniform +-)


@dataclasses.dataclass(frozen=True)
class GoalSwitch(Perturbation):
    source: str = "eval"                         # "eval" | "train"
    tasks: Optional[tuple] = None                # explicit (task_dim,) task


class Schedule(NamedTuple):
    """Compiled perturbation rows: K specs x B slots, neutral-padded."""

    onset: torch.Tensor      # (K, B) int32; NEVER where the spec misses
    act_mask: torch.Tensor   # (K, B, A) multiplicative mask (neutral 1)
    obs_std: torch.Tensor    # (K, B) additive obs noise std (neutral 0)
    obs_bias: torch.Tensor   # (K, B, O) additive obs bias (neutral 0)
    p_mul: torch.Tensor      # (K, B, P) param multiplier (neutral 1)
    p_add: torch.Tensor      # (K, B, P) param additive shift (neutral 0)
    task: torch.Tensor       # (K, B, T) replacement task
    task_on: torch.Tensor    # (K, B) 1 where the row switches the task

    @property
    def num_events(self) -> int:
        return self.onset.shape[0]


def empty_schedule(env: Env, batch: int, device=None) -> Schedule:
    """A K=0 schedule: the no-perturbation episode."""
    return _neutral(env, 0, batch, device)


def _neutral(env: Env, k: int, batch: int, device) -> Schedule:
    a, o, p = env.act_dim, env.obs_dim, len(env.PARAM_NAMES)
    t_dim = env.train_tasks().shape[1]
    f32 = dict(dtype=torch.float32, device=device)
    return Schedule(
        onset=torch.full((k, batch), NEVER, dtype=torch.int32, device=device),
        act_mask=torch.ones((k, batch, a), **f32),
        obs_std=torch.zeros((k, batch), **f32),
        obs_bias=torch.zeros((k, batch, o), **f32),
        p_mul=torch.ones((k, batch, p), **f32),
        p_add=torch.zeros((k, batch, p), **f32),
        task=torch.zeros((k, batch, t_dim), **f32),
        task_on=torch.zeros((k, batch), **f32))


def compile_schedule(env: Env, perts, generator: torch.Generator,
                     batch: int) -> Schedule:
    """Draw every spec's per-slot randomization on the generator's device.
    Deterministic in (perts, generator state, batch)."""
    perts = tuple(perts)
    dev = generator.device
    sched = _neutral(env, len(perts), batch, dev)
    rows = {f: list(getattr(sched, f).unbind(0)) for f in Schedule._fields}

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    for i, pert in enumerate(perts):
        hit = torch.rand(batch, generator=generator, device=dev) < pert.frac
        onset = torch.full((batch,), pert.step, dtype=torch.int32, device=dev)
        if pert.jitter:
            onset = onset + torch.randint(0, pert.jitter + 1, (batch,),
                                          generator=generator, device=dev,
                                          dtype=torch.int32)
        rows["onset"][i] = torch.where(hit, onset, NEVER).to(torch.int32)

        if isinstance(pert, ActuatorDropout):
            if pert.mask is not None:
                m = torch.tensor(pert.mask, dtype=torch.float32,
                                 device=dev).expand(batch, env.act_dim)
            else:
                # k distinct victims per slot: the first k entries of a
                # per-slot random permutation of the actuator indices
                perm = torch.rand(batch, env.act_dim, generator=generator,
                                  device=dev).argsort(dim=1)
                m = torch.ones(batch, env.act_dim, device=dev).scatter(
                    1, perm[:, :pert.k], 0.0)
            rows["act_mask"][i] = m.float()
        elif isinstance(pert, SensorNoise):
            rows["obs_std"][i] = torch.full((batch,), pert.std,
                                            dtype=torch.float32, device=dev)
            if pert.bias:
                rows["obs_bias"][i] = uniform((batch, env.obs_dim),
                                              -pert.bias, pert.bias)
        elif isinstance(pert, ParamShift):
            idx = env.param_index(pert.param)
            u = (uniform((batch,), 1.0 - pert.spread, 1.0 + pert.spread)
                 if pert.spread else torch.ones(batch, device=dev))
            rows["p_mul"][i] = rows["p_mul"][i].clone()
            rows["p_mul"][i][:, idx] = pert.scale * u
            rows["p_add"][i] = rows["p_add"][i].clone()
            rows["p_add"][i][:, idx] = pert.add * u
        elif isinstance(pert, GoalSwitch):
            if pert.tasks is not None:
                task = torch.tensor(pert.tasks, dtype=torch.float32,
                                    device=dev).expand(
                    batch, rows["task"][i].shape[-1])
            else:
                pool = (env.eval_tasks() if pert.source == "eval"
                        else env.train_tasks()).to(dev)
                pick = torch.randint(0, pool.shape[0], (batch,),
                                     generator=generator, device=dev)
                task = pool[pick].float()
            rows["task"][i] = task
            rows["task_on"][i] = torch.ones(batch, device=dev)
        else:
            raise TypeError(f"unknown perturbation spec {pert!r}")
    if not perts:
        return sched
    return Schedule(**{f: torch.stack(rows[f]) for f in Schedule._fields})


# ---- application (called once per env step) --------------------------------

def _active(schedule: Schedule, t) -> torch.Tensor:
    """(K, B) float gate: 1 where row k has fired for slot b by step t."""
    return (t >= schedule.onset).float()


def effective_state(schedule: Schedule, state: VecEnvState,
                    t) -> VecEnvState:
    """The env state with every fired perturbation row folded in: masks
    compose multiplicatively, param shifts as (mul, add), the LAST fired goal
    switch wins.  Applied to the un-perturbed base state each step."""
    if schedule.num_events == 0:
        return state
    g = _active(schedule, t)[:, :, None] > 0                  # (K, B, 1)
    mask = state.actuator_mask * torch.where(
        g, schedule.act_mask, 1.0).prod(dim=0)
    params = state.params * torch.where(g, schedule.p_mul, 1.0).prod(dim=0)
    params = params + (g.float() * schedule.p_add).sum(dim=0)
    task = state.task
    for k in range(schedule.num_events):
        on = (g[k, :, 0].float() * schedule.task_on[k])[:, None] > 0
        task = torch.where(on, schedule.task[k], task)
    return state._replace(actuator_mask=mask, params=params, task=task)


def transform_obs(schedule: Schedule, obs: torch.Tensor, t,
                  generator: torch.Generator) -> torch.Tensor:
    """Sensor-fault model: obs + per-slot bias + white noise, where fired."""
    if schedule.num_events == 0:
        return obs
    g = _active(schedule, t)
    bias = (g[:, :, None] * schedule.obs_bias).sum(dim=0)
    std = (g * schedule.obs_std).sum(dim=0)                   # (B,)
    noise = torch.randn(obs.shape, generator=generator, device=obs.device)
    return obs + bias + std[:, None] * noise
