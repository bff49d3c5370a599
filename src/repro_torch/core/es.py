"""Parameter-Exploring Policy Gradients (PEPG) — Sehnke et al. 2010.

The paper's Phase-1 offline optimizer: searches the plasticity-coefficient
space theta with symmetric (antithetic) sampling.  The fitness function
scores a whole population (a plastic-SNN episode rollout per candidate).

    eps ~ N(0, sigma^2)            (one per population pair)
    theta+/- = mu +/- eps
    d_mu    = alpha_mu    * T^T r_diff      T_ij = eps_ij
    d_sigma = alpha_sigma * S^T r_avg       S_ij = (eps_ij^2 - sigma_j^2)/sigma_j

with r_diff = (r+ - r-)/2 and r_avg = (r+ + r-)/2 - b (running baseline).
Optional rank-based fitness shaping stabilizes heavy-tailed RL returns.

Randomness comes from an explicit `torch.Generator`; the search's tensors
live on the generator's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class PEPGConfig:
    num_params: int
    pop_pairs: int = 32              # population = 2 * pop_pairs (antithetic)
    lr_mu: float = 0.1
    lr_sigma: float = 0.05
    sigma_init: float = 0.05
    sigma_min: float = 1e-3
    sigma_max: float = 1.0
    baseline_decay: float = 0.9
    rank_shaping: bool = True
    mu_init_scale: float = 0.0


class PEPGState(NamedTuple):
    mu: torch.Tensor           # (num_params,)
    sigma: torch.Tensor        # (num_params,)
    baseline: torch.Tensor     # ()
    step: torch.Tensor         # () int32
    best_fitness: torch.Tensor
    best_theta: torch.Tensor


def init(cfg: PEPGConfig, generator: torch.Generator) -> PEPGState:
    dev = generator.device
    mu = cfg.mu_init_scale * torch.randn(cfg.num_params, generator=generator,
                                         device=dev)
    return PEPGState(
        mu=mu,
        sigma=torch.full((cfg.num_params,), cfg.sigma_init, device=dev),
        baseline=torch.zeros((), device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        best_fitness=torch.full((), -torch.inf, device=dev),
        best_theta=mu)


def ask(cfg: PEPGConfig, state: PEPGState, generator: torch.Generator
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample the antithetic population.

    Returns (population, eps): population is (2*pop_pairs, num_params) laid
    out as [mu+eps_0..mu+eps_{P-1}, mu-eps_0..mu-eps_{P-1}].
    """
    eps = torch.randn(cfg.pop_pairs, cfg.num_params, generator=generator,
                      device=generator.device) * state.sigma[None, :]
    pop = torch.cat([state.mu[None, :] + eps, state.mu[None, :] - eps])
    return pop, eps


def _rank_shape(f: torch.Tensor) -> torch.Tensor:
    """Centered rank transform in [-0.5, 0.5]; tied fitnesses rank in
    population order (a stable sort, as the reference's)."""
    n = f.shape[0]
    ranks = torch.argsort(torch.argsort(f, stable=True), stable=True)
    return ranks.float() / (n - 1) - 0.5


def tell(cfg: PEPGConfig, state: PEPGState, eps: torch.Tensor,
         fitness: torch.Tensor) -> PEPGState:
    """PEPG update from population fitness (ordered as `ask` returned it)."""
    p = cfg.pop_pairs
    f_raw = fitness
    f = _rank_shape(fitness) if cfg.rank_shaping else fitness
    f_pos, f_neg = f[:p], f[p:]

    r_diff = 0.5 * (f_pos - f_neg)                       # (P,)
    r_avg = 0.5 * (f_pos + f_neg)                        # (P,)
    baseline = torch.where(
        state.step == 0, r_avg.mean(),
        cfg.baseline_decay * state.baseline
        + (1 - cfg.baseline_decay) * r_avg.mean())

    # mu gradient:  T^T r_diff / P
    d_mu = eps.T @ r_diff / p                            # (num_params,)
    # sigma gradient: S^T (r_avg - b) / P
    s_mat = (eps ** 2 - state.sigma[None, :] ** 2) / state.sigma[None, :]
    d_sigma = s_mat.T @ (r_avg - baseline) / p

    mu = state.mu + cfg.lr_mu * d_mu
    sigma = torch.clamp(state.sigma + cfg.lr_sigma * d_sigma,
                        cfg.sigma_min, cfg.sigma_max)

    # elitism bookkeeping over raw (unshaped) fitness
    pop = torch.cat([state.mu[None, :] + eps, state.mu[None, :] - eps])
    best_idx = torch.argmax(f_raw)
    gen_best_f = f_raw[best_idx]
    gen_best_theta = pop[best_idx]
    improved = gen_best_f > state.best_fitness
    return PEPGState(
        mu=mu, sigma=sigma, baseline=baseline, step=state.step + 1,
        best_fitness=torch.where(improved, gen_best_f, state.best_fitness),
        best_theta=torch.where(improved, gen_best_theta, state.best_theta))


def fold_seed(seed: int, i: int) -> int:
    """A seed derived from ``seed`` and an index (a generation, a
    candidate): deterministic, distinct for distinct indices."""
    return (seed * 1000003 + i) & 0x7FFFFFFF


def run(cfg: PEPGConfig,
        fitness_fn: Callable[[torch.Tensor, int], torch.Tensor],
        generator: torch.Generator,
        generations: int,
        log_every: int = 0) -> tuple[PEPGState, torch.Tensor]:
    """Full ES loop.  fitness_fn(population, seed) -> (pop_size,) fitness;
    generation g scores with ``fold_seed(generator.initial_seed(), g)``.
    Returns (final_state, per-generation mean-fitness history).

    ``log_every`` > 0 prints the generation and its mean fitness after
    every ``log_every``-th generation (one host read each); 0, the
    default, prints nothing.  The JAX package takes the same argument."""
    state = init(cfg, generator)
    seed = generator.initial_seed()
    history = []
    for g in range(generations):
        pop, eps = ask(cfg, state, generator)
        fit = fitness_fn(pop, fold_seed(seed, g))
        state = tell(cfg, state, eps, fit)
        history.append(fit.mean())
        if log_every > 0 and (g + 1) % log_every == 0:
            print(f"es generation {g + 1}/{generations}: mean fitness "
                  f"{float(history[-1]):.6g}", flush=True)
    return state, torch.stack(history) if history else torch.zeros(0)
