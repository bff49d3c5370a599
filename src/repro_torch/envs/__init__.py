"""Batched continuous-control environments (Brax stand-ins).

Five tasks; the first three mirror the paper's evaluation protocol
(Sec. IV-A), the last two grow the scenario engine's diversity axis:

  * direction:  planar 8-thruster locomotor trained on 8 target directions,
                evaluated on 72 unseen directions           (Brax `ant`)
  * velocity:   1-D runner trained on 8 target velocities,
                evaluated on 72 unseen velocities           (Brax `halfcheetah`)
  * position:   2-link torque-controlled reacher with 8 train and 72
                unseen goal positions                       (Brax `ur5e`)
  * arm:        2-link arm with in-plane gravity and a variable tip
                payload (persistent-load adaptation scenario)
  * stabilizer: 1-D setpoint regulation with redundant thrusters and a
                wind-force dynamics shift

Direction's 8-wide observation and action fit the paper's full-width 8-128-8
controller.  Each takes an actuator mask (morphology damage) and a ``PARAM_NAMES``
vector of perturbable dynamics constants.
"""
from repro_torch.envs.arm import ArmEnv
from repro_torch.envs.base import Env, EnvState
from repro_torch.envs.direction import DirectionEnv
from repro_torch.envs.reacher import ReacherEnv
from repro_torch.envs.stabilizer import StabilizerEnv
from repro_torch.envs.velocity import VelocityEnv

ENVS = {
    "direction": DirectionEnv,
    "velocity": VelocityEnv,
    "position": ReacherEnv,
    "arm": ArmEnv,
    "stabilizer": StabilizerEnv,
}


def make(name: str, **kwargs) -> Env:
    return ENVS[name](**kwargs)
