"""Carry state and parameters from the JAX package into the port.

Randomness cannot match across the two frameworks (env resets, perturbation
draws and `init_theta` all draw from it), so a comparison builds those on
the JAX side and carries them across with the functions below.  Each takes
an object with the JAX package's field names whose leaves convert with
`numpy.asarray` — the JAX objects themselves, or the same fields as numpy
arrays — and never imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import NetworkState
from repro_torch.core.snn import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import torch_dtype
from repro_torch.models.layers import ParamDesc
from repro_torch.obs.telemetry import FleetTelemetry
from repro_torch.scenarios.perturb import Schedule
from repro_torch.scenarios.vector_env import VecEnvState


def tensor(x, device=None) -> torch.Tensor:
    """One array leaf -> a tensor of the same dtype on ``device``.
    bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16) travel as their bits."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def lm_params(params, cfg, device=None):
    """The JAX LM parameter tree (``repro.models.factory.Model.init``; dicts
    and lists whose leaves convert with `numpy.asarray`) -> the port's tree
    for the same `ModelConfig`.  Every leaf is checked against the port's
    plan: same shape and dtype, or ValueError."""
    def walk(desc, x, path):
        if isinstance(desc, ParamDesc):
            t = tensor(x, device)
            want = torch_dtype(desc.dtype)
            if tuple(t.shape) != tuple(desc.shape) or t.dtype != want:
                raise ValueError(
                    f"{path}: the port's plan has {tuple(desc.shape)} "
                    f"{want}; got {tuple(t.shape)} {t.dtype}")
            return t
        if isinstance(desc, dict):
            if set(desc) != set(x):
                raise ValueError(f"{path}: keys {sorted(x)} differ from the "
                                 f"port's plan {sorted(desc)}")
            return {k: walk(desc[k], x[k], f"{path}/{k}")
                    for k in sorted(desc)}
        if len(desc) != len(x):
            raise ValueError(f"{path}: {len(x)} entries, the port's plan "
                             f"has {len(desc)}")
        return [walk(d, e, f"{path}[{i}]")
                for i, (d, e) in enumerate(zip(desc, x))]

    return walk(transformer.plan(cfg), params, "params")


def network_state(state, device=None) -> NetworkState:
    """``repro.core.engine.NetworkState`` -> the port's `NetworkState`."""
    def tup(xs):
        return tuple(tensor(x, device) for x in xs)
    return NetworkState(w=tup(state.w), v=tup(state.v),
                        trace=tup(state.trace), t=tensor(state.t, device),
                        w_scale=tup(state.w_scale))


def fleet_telemetry(tel, device=None) -> FleetTelemetry:
    """``repro.obs.FleetTelemetry`` -> the port's `FleetTelemetry`."""
    return FleetTelemetry(*(tensor(getattr(tel, f.name), device)
                            for f in dataclasses.fields(FleetTelemetry)))


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
