"""Scenario registry + the reference adaptive rule.

A `ScenarioSpec` names an env, a perturbation schedule and the episode
geometry (onset, metric window, fleet batch) — one row of the robustness
sweep.

`reference_rule` builds a hand-designed plasticity rule for the paper's
single-layer error-feedback controller, so the adaptation claim is
deterministic and cheap to evaluate (Phase-1 PEPG search,
`core.adaptation.optimize_rule`, remains the path for *learned* rules).  In
the four-term rule's language
(``dw = alpha*pre*post + beta*pre + gamma*post + delta``):

  * ``delta`` rows on the env's error channels bootstrap the wiring from
    zero weights toward the signed pattern ``G`` (error channels to
    actuators): a proportional controller built by the rule;
  * ``alpha`` (Hebbian) on the same rows is the adaptive part: while an
    error persists, pre and post traces stay correlated and the loop gain
    keeps growing — integral action that cancels persistent disturbances.
    A frozen controller keeps its pre-perturbation gain and holds a
    steady-state error: the plastic-vs-frozen separation the paper claims.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import envs
from repro_torch.core import snn
from repro_torch.core.plasticity import ALPHA, DELTA
from repro_torch.scenarios.perturb import (ActuatorDropout, GoalSwitch,
                                           ParamShift, SensorNoise)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named robustness scenario (env + schedule + episode geometry)."""

    name: str
    env_name: str
    perturbations: tuple = ()
    env_kwargs: tuple = ()     # (("wind", 1.2),) — kwargs for envs.make
    steps: int = 160
    onset: int = 60            # nominal perturbation step (metrics anchor)
    window: int = 30           # metric averaging window
    tasks: object = "train"    # ClosedLoop.init_tasks spec
    batch: int = 8

    def make_env(self) -> envs.Env:
        return envs.make(self.env_name, episode_len=self.steps,
                         **dict(self.env_kwargs))


SCENARIOS = {
    s.name: s for s in (
        # -- gate scenarios: the paper's core claim is asserted on these ----
        ScenarioSpec(
            name="stabilizer-wind", env_name="stabilizer",
            env_kwargs=(("spring", 2.5),),
            perturbations=(ParamShift(param="wind", add=3.0, step=80),),
            steps=260, onset=80, window=40, tasks="train"),
        ScenarioSpec(
            name="velocity-drag", env_name="velocity",
            perturbations=(ParamShift(param="drag", scale=3.0, step=80),),
            steps=260, onset=80, window=40, tasks=1),
        # -- sweep scenarios ------------------------------------------------
        ScenarioSpec(
            name="arm-payload", env_name="arm",
            perturbations=(ParamShift(param="payload", add=1.5, step=80),),
            steps=260, onset=80, window=40, tasks="train"),
        ScenarioSpec(
            name="stabilizer-dropout", env_name="stabilizer",
            env_kwargs=(("spring", 2.5), ("wind", 2.0)),
            perturbations=(ActuatorDropout(k=1, step=80),),
            steps=260, onset=80, window=40, tasks="train"),
        ScenarioSpec(
            name="direction-dropout", env_name="direction",
            perturbations=(ActuatorDropout(k=3, step=80),),
            steps=260, onset=80, window=40, tasks="train"),
        ScenarioSpec(
            name="direction-goalswitch", env_name="direction",
            perturbations=(GoalSwitch(step=80, source="eval"),),
            steps=260, onset=80, window=40, tasks="train"),
        ScenarioSpec(
            name="position-noise", env_name="position",
            perturbations=(SensorNoise(std=0.4, bias=0.2, step=80),),
            steps=260, onset=80, window=40, tasks="train"),
    )
}

# The two scenarios on which the paper's claim is ASSERTED (plastic
# recovery_frac >= 0.5, frozen <= 0.25).
GATE_SCENARIOS = ("stabilizer-wind", "velocity-drag")


def controller_config(env: envs.Env, quant: bool = False, timesteps: int = 2,
                      w_clip: float = 3.0) -> snn.SNNConfig:
    """The reference single-layer error-feedback controller for ``env``.
    ``w_clip`` doubles as the adaptive-gain ceiling, low enough that the
    loop stays stable with every weight pegged."""
    cfg = snn.SNNConfig(layer_sizes=(env.obs_dim, env.act_dim),
                        timesteps=timesteps, plastic=True, w_clip=w_clip)
    return snn.quant_config(cfg) if quant else cfg


def _wiring(env_name: str, env: envs.Env) -> tuple:
    """Signed error-channel -> actuator patterns ``(g_boot, g_adapt)``, both
    (obs_dim, act_dim): the proportional wiring the delta term ramps from
    zero, and the ERROR rows the Hebbian term may grow (never the damping
    rows, where it would amplify a destabilizing lagged correlation)."""
    g = np.zeros((env.obs_dim, env.act_dim), np.float32)
    a = np.zeros((env.obs_dim, env.act_dim), np.float32)
    if env_name == "stabilizer":
        g[0, :] = 1.0          # err -> both thrusters
        g[1, :] = -0.4         # velocity damping (bootstrap only)
        a[0, :] = 1.0
    elif env_name == "velocity":
        g[2, :] = 1.0          # v_err -> all gait actuators
        a[2, :] = 1.0
    elif env_name == "direction":
        axes = env._thruster_axes().numpy()                   # (8, 2)
        g[4, :] = axes[:, 0]   # vel-err x -> thruster axis x
        g[5, :] = axes[:, 1]   # vel-err y -> thruster axis y
        a[4, :] = np.abs(axes[:, 0])
        a[5, :] = np.abs(axes[:, 1])
    elif env_name in ("arm", "position"):
        # obs layout [sin q(2), cos q(2), dq(2), goal(2), goal-tip(2), 1]:
        # tip error rows 8, 9; joint-rate damping rows 4, 5.  Signs follow
        # the Jacobian transpose averaged over the frontal, elbow-down
        # workspace (x_tip > 0; sin(q1+q2) < 0): e_y drives both joints
        # CCW, e_x mostly extends the elbow.
        g[9, 0] = 1.0          # e_y -> shoulder torque
        g[9, 1] = 1.0          # e_y -> elbow torque
        g[8, 1] = 0.7          # e_x -> elbow extension
        g[4, 0] = -0.4         # dq damping (bootstrap only)
        g[5, 1] = -0.4
        a[9, 0] = a[9, 1] = 1.0
        a[8, 1] = 0.7
    else:
        raise ValueError(f"no reference wiring for env {env_name!r}")
    return g, a


def reference_rule(env_name: str, scfg: snn.SNNConfig,
                   boot: float = 3e-3, hebb: float = 1e-3):
    """Hand-designed theta for the single-layer reference controller
    (CPU tensors; `ClosedLoop.run` moves them to its device).  ``boot``
    scales the delta (bootstrap) term, ``hebb`` the Hebbian term."""
    if scfg.num_layers != 1:
        raise ValueError("reference_rule wires the single-layer controller; "
                         f"got layer_sizes={scfg.layer_sizes}")
    env = envs.make(env_name)
    g, a = _wiring(env_name, env)
    if g.shape != (scfg.layer_sizes[0], scfg.layer_sizes[1]):
        raise ValueError(f"wiring {g.shape} does not match controller "
                         f"{tuple(scfg.layer_sizes)}")
    theta = np.zeros((4, *g.shape), np.float32)
    theta[DELTA] = boot * g
    # Hebbian growth is sign-blind, so alpha takes the error-row magnitudes
    theta[ALPHA] = hebb * a
    return [torch.from_numpy(theta).to(scfg.dtype)]
