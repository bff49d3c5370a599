"""Scenario engine: vectorized envs, perturbation schedules, closed-loop
fleet adaptation.

  * `vector_env.VectorEnv` — B env instances as one struct of arrays;
  * `perturb` — `Perturbation` specs compiled to tensor `Schedule`s;
  * `harness.make_closed_loop` — B envs against B plastic controllers
    through the engine's fleet path, float32 or fixed point, with a
    freeze-step for the plasticity-vs-frozen ablation;
  * `metrics.adaptation_metrics` — the paper's adaptation numbers;
  * `harness.inject_anomaly` — host-side drive faults for the
    session-health detectors.
"""
from repro_torch.scenarios.vector_env import VectorEnv, VecEnvState
from repro_torch.scenarios.perturb import (ActuatorDropout, GoalSwitch,
                                           ParamShift, Perturbation, Schedule,
                                           SensorNoise, compile_schedule,
                                           empty_schedule)
from repro_torch.scenarios.harness import (ANOMALIES, AnomalyPreset,
                                           ClosedLoop, RolloutResult,
                                           inject_anomaly, make_closed_loop,
                                           run_closed_loop)
from repro_torch.scenarios.metrics import adaptation_metrics, ablation_summary
from repro_torch.scenarios.presets import (GATE_SCENARIOS, SCENARIOS,
                                           ScenarioSpec, controller_config,
                                           reference_rule)
