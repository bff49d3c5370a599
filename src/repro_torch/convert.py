"""Carry state and parameters from the JAX package into the port.

Randomness cannot match across the two frameworks (env resets, perturbation
draws and `init_theta` all draw from it), so a comparison builds those on
the JAX side and carries them across with the functions below.  Each takes
an object with the JAX package's field names whose leaves convert with
`numpy.asarray` — the JAX objects themselves, or the same fields as numpy
arrays — and never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import NetworkState
from repro_torch.core.snn import resolve_device
from repro_torch.scenarios.perturb import Schedule
from repro_torch.scenarios.vector_env import VecEnvState


def tensor(x, device=None) -> torch.Tensor:
    """One array leaf -> a tensor of the same dtype on ``device``."""
    return torch.from_numpy(np.array(x)).to(resolve_device(device))


def network_state(state, device=None) -> NetworkState:
    """``repro.core.engine.NetworkState`` -> the port's `NetworkState`."""
    def tup(xs):
        return tuple(tensor(x, device) for x in xs)
    return NetworkState(w=tup(state.w), v=tup(state.v),
                        trace=tup(state.trace), t=tensor(state.t, device),
                        w_scale=tup(state.w_scale))


def theta(th, device=None) -> list:
    """Per-layer rule list (None entries stay None)."""
    return [None if t is None else tensor(t, device) for t in th]


def vec_env_state(vs, device=None) -> VecEnvState:
    """``repro.scenarios.VecEnvState`` -> the port's `VecEnvState`."""
    return VecEnvState(*(tensor(getattr(vs, f), device)
                         for f in VecEnvState._fields))


def schedule(sched, device=None) -> Schedule:
    """``repro.scenarios.Schedule`` -> the port's `Schedule`."""
    return Schedule(*(tensor(getattr(sched, f), device)
                      for f in Schedule._fields))
