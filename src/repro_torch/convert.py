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
from repro_torch.core.es import PEPGState
from repro_torch.core.snn import resolve_device
from repro_torch.models import factory, plastic, transformer
from repro_torch.models.config import torch_dtype
from repro_torch.models.layers import ParamDesc
from repro_torch.obs.health import HealthConfig, HealthState
from repro_torch.obs.recorder import RecorderState
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


def _walk(like, x, path: str, leaf):
    """``like``'s tree (dicts and lists) with each leaf ``leaf(desc, x,
    path)`` of the matching entry of ``x``; keys and lengths checked."""
    if isinstance(like, dict):
        if set(like) != set(x):
            raise ValueError(f"{path}: keys {sorted(x)} differ from the "
                             f"port's {sorted(like)}")
        return {k: _walk(like[k], x[k], f"{path}/{k}", leaf)
                for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        if len(like) != len(x):
            raise ValueError(f"{path}: {len(x)} entries, the port's tree "
                             f"has {len(like)}")
        return [_walk(d, e, f"{path}[{i}]", leaf)
                for i, (d, e) in enumerate(zip(like, x))]
    return leaf(like, x, path)


def _checked(shape, dtype, x, path, device):
    t = tensor(x, device)
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{path}: the port has {tuple(shape)} {dtype}; got "
                         f"{tuple(t.shape)} {t.dtype}")
    return t


def lm_params(params, cfg, device=None):
    """The JAX LM parameter tree (``repro.models.factory.Model.init``; dicts
    and lists whose leaves convert with `numpy.asarray`) -> the port's tree
    for the same `ModelConfig`.  Every leaf is checked against the port's
    plan: same shape and dtype, or ValueError."""
    return _walk(transformer.plan(cfg), params, "params",
                 lambda d, x, path: _checked(d.shape, torch_dtype(d.dtype),
                                             x, path, device))


def opt_state(state, cfg, device=None, moment_dtype: str = "float32"):
    """The JAX ``repro.optim.OptState`` of an LM's parameters (its fields
    converting with `numpy.asarray`) -> the port's `optim.OptState`: step
    a 0-d int32, mu and nu each leaf checked against the parameter plan's
    shape in ``moment_dtype``, and master (float32) or None.  An SGD state
    (nu a tree of 0-d zeros) converts with ``moment_dtype="float32"`` as
    its momentum does, its nu leaves taken as they are."""
    from repro_torch.optim import OptState

    plan = transformer.plan(cfg)

    def tree(x, dtype):
        if x is None:
            return None
        return _walk(plan, x, "opt", lambda d, a, path: _checked(
            d.shape if np.ndim(a) else (), torch_dtype(dtype), a, path,
            device))

    return OptState(step=_checked((), torch.int32, state.step, "opt/step",
                                  device),
                    mu=tree(state.mu, moment_dtype),
                    nu=tree(state.nu, moment_dtype),
                    master=tree(state.master, "float32"))


def lm_session(session, cfg, max_len: int, device=None) -> dict:
    """One session of JAX's ``repro.serving.LMScheduler`` (its
    ``session_view`` or a `SessionStore` payload: ``{"cache", "tok"}``)
    -> the port's session of the same `ModelConfig` and ``max_len``, each
    leaf checked against `factory.Model.session_template`, so that both
    pools can start from one state."""
    like = {"cache": factory.build(cfg).session_template(max_len),
            "tok": torch.empty((), dtype=torch.int32, device="meta")}
    return _walk(like, session, "session",
                 lambda t, x, path: _checked(t.shape, t.dtype, x, path,
                                             device))


def adapter_row(row, cfg, device=None) -> dict:
    """One adapter session of JAX's ``repro.serving.AdapterPool`` (a dict
    of the adapter cache's leaves, unbatched) -> the port's, checked
    against `models.plastic.plan_cache`."""
    return _walk(plastic.plan_cache(cfg, 1), row, "adapter",
                 lambda d, x, path: _checked(d.shape[1:],
                                             torch_dtype(d.dtype), x, path,
                                             device))


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


def health_config(cfg) -> HealthConfig:
    """``repro.obs.HealthConfig`` -> the port's `HealthConfig` (the same
    fields, validated again)."""
    return HealthConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(HealthConfig)})


def recorder_state(rec, device=None) -> RecorderState:
    """``repro.obs.RecorderState`` -> the port's `RecorderState`, so that
    both packages can step one recorder state."""
    h = rec.health
    return RecorderState(
        ring=tensor(rec.ring, device), wnorm0=tensor(rec.wnorm0, device),
        health=HealthState(*(tensor(getattr(h, f.name), device)
                             for f in dataclasses.fields(HealthState))))


def theta(th, device=None) -> list:
    """Per-layer rule list (None entries stay None)."""
    return [None if t is None else tensor(t, device) for t in th]


def pepg_state(state, device=None) -> PEPGState:
    """``repro.core.es.PEPGState`` -> the port's `PEPGState`, so that both
    searches can continue from one state."""
    return PEPGState(*(tensor(getattr(state, f), device)
                       for f in PEPGState._fields))


def vec_env_state(vs, device=None) -> VecEnvState:
    """``repro.scenarios.VecEnvState`` -> the port's `VecEnvState`."""
    return VecEnvState(*(tensor(getattr(vs, f), device)
                         for f in VecEnvState._fields))


def schedule(sched, device=None) -> Schedule:
    """``repro.scenarios.Schedule`` -> the port's `Schedule`."""
    return Schedule(*(tensor(getattr(sched, f), device)
                      for f in Schedule._fields))
