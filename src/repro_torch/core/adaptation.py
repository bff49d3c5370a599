"""Two-phase learning framework (FireFly-P Sec. II-B).

Phase 1 (offline): PEPG searches plasticity-coefficient space; each candidate
theta is scored by rolling out a plastic SNN — weights start at ZERO and are
rewritten online by the rule — across the training tasks.  The learned object
is the *rule*, never the weights.

Phase 2 (online): theta* frozen; the controller adapts its synapses on the
fly, including under perturbations (actuator failure) and on unseen tasks.

A weight-trained baseline (ES directly over synaptic weights, plasticity off)
reproduces the paper's Fig. 3 comparison.

Every rollout runs on the scenario engine's closed-loop fleet harness, one
fleet window (one rollout-kernel launch on the card) per control step.  The
kernel takes one theta per launch, so a plastic generation is one closed
loop per candidate with a slot per training task (each slot's weights its
own, from zero: the same function as one single-sample episode per task);
the weight-trained baseline, whose slots differ only in their weights, is
ONE loop over candidates x tasks.  `AdaptationConfig` has no backend
switch: the device of the tensors picks the kernel or its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import es, snn
from repro_torch.core.plasticity import NUM_TERMS
from repro_torch.envs.base import Env
from repro_torch.scenarios import harness as H
from repro_torch.scenarios import perturb as P
from repro_torch.scenarios.vector_env import VecEnvState, VectorEnv


@dataclasses.dataclass(frozen=True)
class AdaptationConfig:
    hidden: int = 128                  # paper: 128 hidden neurons for control
    timesteps: int = 4
    trace_decay: float = 0.8
    pop_pairs: int = 24
    generations: int = 60
    episodes_per_task: int = 1
    theta_scale: float = 0.05          # PEPG sigma_init over theta space
    seed: int = 0


def make_snn_config(env: Env, cfg: AdaptationConfig,
                    plastic: bool = True) -> snn.SNNConfig:
    return snn.SNNConfig(
        layer_sizes=(env.obs_dim, cfg.hidden, env.act_dim),
        timesteps=cfg.timesteps, trace_decay=cfg.trace_decay,
        plastic=plastic)


def unflatten_weights(scfg: snn.SNNConfig, flat: torch.Tensor):
    """Per-layer (..., N_i, M_i) weights of a flat (..., weight_size)
    vector (leading axes kept: a population unflattens at once)."""
    out, off = [], 0
    lead = flat.shape[:-1]
    for i in range(scfg.num_layers):
        shape = (scfg.layer_sizes[i], scfg.layer_sizes[i + 1])
        n = shape[0] * shape[1]
        out.append(flat[..., off:off + n].reshape(*lead, *shape)
                   .to(scfg.dtype))
        off += n
    return out


def weight_size(scfg: snn.SNNConfig) -> int:
    return sum(scfg.layer_sizes[i] * scfg.layer_sizes[i + 1]
               for i in range(scfg.num_layers))


def _no_rule(scfg: snn.SNNConfig, device) -> list:
    """The all-zero rule a non-plastic controller carries (never read)."""
    return [torch.zeros((NUM_TERMS, scfg.layer_sizes[i],
                         scfg.layer_sizes[i + 1]), dtype=scfg.dtype,
                        device=device) for i in range(scfg.num_layers)]


def _failure_schedule(env: Env, actuator_mask, mask_after: Optional[int],
                      seed: int, batch: int, device) -> P.Schedule:
    """The actuator-failure stress as an `ActuatorDropout` schedule:
    ``actuator_mask`` from env step ``mask_after`` (0 when None) on."""
    pert = P.ActuatorDropout(
        step=0 if mask_after is None else int(mask_after),
        mask=tuple(float(m) for m in torch.as_tensor(actuator_mask)))
    return P.compile_schedule(
        env, (pert,), torch.Generator(device).manual_seed(seed), batch)


def episode_return(env: Env, scfg: snn.SNNConfig, theta_or_w: torch.Tensor,
                   task: torch.Tensor, seed: int,
                   actuator_mask: Optional[torch.Tensor] = None,
                   mask_after: Optional[int] = None,
                   device=None) -> torch.Tensor:
    """Roll one episode; returns the cumulative reward (0-d).

    For plastic nets `theta_or_w` is the flat plasticity-coefficient vector
    and synaptic weights start at zero (Phase-2 semantics).  For the
    weight-trained baseline it is the flat weight vector, frozen.

    `mask_after`: env step from which `actuator_mask` applies (simulated
    mid-episode leg failure); None applies the mask from t=0.  ``seed``
    draws the reset; ``device=None`` is the card.
    """
    device = snn.resolve_device(device)
    prog = H.make_closed_loop(env, scfg, batch=1, steps=env.episode_len)
    if scfg.plastic:
        theta, w0 = theta_or_w, None
    else:
        theta, w0 = _no_rule(scfg, device), unflatten_weights(scfg,
                                                              theta_or_w)
    schedule = None
    if actuator_mask is not None:
        schedule = _failure_schedule(env, actuator_mask, mask_after, seed, 1,
                                     device)
    res = prog.run(theta, seed, tasks=task, schedule=schedule, w0=w0,
                   device=device)
    return res.rewards.sum()


def candidate_seeds(seed: int, n: int, crn: bool = False) -> list:
    """Each candidate's reset seed: its own, folded from ``seed`` and its
    index, or with ``crn`` (common random numbers) ``seed`` for all."""
    return [seed if crn else es.fold_seed(seed, c) for c in range(n)]


def population_rewards(env: Env, scfg: snn.SNNConfig, pop: torch.Tensor,
                       tasks: torch.Tensor, seeds: Sequence[int]
                       ) -> torch.Tensor:
    """Per-step rewards ``(steps, P, T)`` of every candidate (row of
    ``pop``) on every task, on ``pop``'s device.  Candidate c's T slots
    reset from a generator seeded ``seeds[c]``.

    Plastic: one closed loop per candidate, B = T, weights from zero, the
    candidate's theta on every launch.  Weight-trained: ONE closed loop of
    B = P x T slots (candidate-major), slot (c, t) holding candidate c's
    frozen weights.
    """
    dev = pop.device
    n, t_n = pop.shape[0], tasks.shape[0]
    tasks = torch.as_tensor(tasks, dtype=torch.float32).to(dev)
    steps = env.episode_len
    if scfg.plastic:
        prog = H.make_closed_loop(env, scfg, batch=t_n, steps=steps)
        sched = P.empty_schedule(env, t_n, dev)
        out = []
        for c in range(n):
            gen = torch.Generator(dev).manual_seed(seeds[c])
            vstate = prog.venv.reset(gen, tasks=tasks)
            res = prog.rollout(prog.init_net(device=dev), vstate,
                               snn.unflatten_theta(scfg, pop[c]), sched,
                               steps + 1, gen)
            out.append(res.rewards)
        return torch.stack(out, dim=1)
    b = n * t_n
    prog = H.make_closed_loop(env, scfg, batch=b, steps=steps)
    venv = VectorEnv(env, t_n)
    parts = [venv.reset(torch.Generator(dev).manual_seed(s), tasks=tasks)
             for s in seeds]
    vstate = VecEnvState(*(torch.cat(f) for f in zip(*parts)))
    w = tuple(wi.repeat_interleave(t_n, dim=0).contiguous()
              for wi in unflatten_weights(scfg, pop))
    net = dataclasses.replace(prog.init_net(device=dev), w=w)
    res = prog.rollout(net, vstate, _no_rule(scfg, dev),
                       P.empty_schedule(env, b, dev), steps + 1)
    return res.rewards.reshape(steps, n, t_n)


def make_fitness_fn(env: Env, scfg: snn.SNNConfig, tasks: torch.Tensor,
                    crn: bool = False):
    """Mean return across training tasks, for a whole ES population:
    ``fitness(pop, seed) -> (P,)`` on ``pop``'s device.

    Each candidate resets from its OWN generator (`candidate_seeds`);
    ``crn=True`` gives every candidate the same one (common random
    numbers, a variance-reduction choice that couples every candidate's
    evaluation noise).
    """

    def fitness(pop: torch.Tensor, seed: int) -> torch.Tensor:
        seeds = candidate_seeds(seed, pop.shape[0], crn)
        rewards = population_rewards(env, scfg, pop, tasks, seeds)
        return rewards.sum(dim=0).mean(dim=-1)

    return fitness


def optimize_rule(env: Env, cfg: AdaptationConfig, plastic: bool = True,
                  device=None
                  ) -> tuple[torch.Tensor, torch.Tensor, snn.SNNConfig]:
    """Phase 1.  Returns (theta*_flat or w*_flat, fitness history, snn cfg).
    ``device=None`` is the card."""
    device = snn.resolve_device(device)
    scfg = make_snn_config(env, cfg, plastic=plastic)
    n = snn.theta_size(scfg) if plastic else weight_size(scfg)
    pcfg = es.PEPGConfig(num_params=n, pop_pairs=cfg.pop_pairs,
                         sigma_init=cfg.theta_scale)
    fitness = make_fitness_fn(env, scfg, env.train_tasks())
    generator = torch.Generator(device).manual_seed(cfg.seed)
    state, history = es.run(pcfg, fitness, generator, cfg.generations)
    return state.mu, history, scfg


def evaluate_generalization(env: Env, scfg: snn.SNNConfig,
                            params: torch.Tensor, seed: int = 1,
                            actuator_mask: Optional[torch.Tensor] = None,
                            mask_after: Optional[int] = None,
                            device=None) -> torch.Tensor:
    """Phase 2 on the 72 unseen tasks.  Returns per-task returns (72,).

    All 72 eval tasks run as ONE B = 72 closed loop on the fleet harness
    (per-slot weights), the actuator-failure stress expressed as an
    `ActuatorDropout` schedule.  ``device=None`` is the card.
    """
    device = snn.resolve_device(device)
    tasks = env.eval_tasks()
    b = tasks.shape[0]
    prog = H.make_closed_loop(env, scfg, batch=b, steps=env.episode_len)
    if scfg.plastic:
        theta, w0 = params, None
    else:
        theta, w0 = _no_rule(scfg, device), unflatten_weights(scfg, params)
    schedule = None
    if actuator_mask is not None:
        schedule = _failure_schedule(env, actuator_mask, mask_after, seed, b,
                                     device)
    res = prog.run(theta, seed, tasks=tasks, schedule=schedule, w0=w0,
                   device=device)
    return res.rewards.sum(dim=0)
