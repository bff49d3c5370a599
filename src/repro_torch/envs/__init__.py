"""Batched continuous-control environments (Brax stand-ins).

The port carries the envs of the closed-loop slice: the two recovery-gate
envs (stabilizer, velocity) and direction, whose 8-wide observation and
action fit the paper's full-width 8-128-8 controller.  Each takes an
actuator mask (morphology damage) and a ``PARAM_NAMES`` vector of
perturbable dynamics constants.
"""
from repro_torch.envs.base import Env, EnvState
from repro_torch.envs.direction import DirectionEnv
from repro_torch.envs.stabilizer import StabilizerEnv
from repro_torch.envs.velocity import VelocityEnv

ENVS = {
    "direction": DirectionEnv,
    "velocity": VelocityEnv,
    "stabilizer": StabilizerEnv,
}


def make(name: str, **kwargs) -> Env:
    return ENVS[name](**kwargs)
