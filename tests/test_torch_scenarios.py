"""The closed-loop slice of the PyTorch port against the JAX reference, and
the paper's recovery gate in the port (CPU tensors: the plain versions of
the kernels).

Randomness differs between the frameworks, so env states, schedules and
rules are built on the JAX side and carried across (`repro_torch.convert`).
Rewards agree within atol = 1e-4, the tolerance of
tests/test_scenarios.py:217: XLA contracts the env dynamics into fused
multiply-adds, so the float env trajectories differ in the last bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as JEnvs
from repro import scenarios as JS
from repro.scenarios import perturb as JP
from repro_torch import convert
from repro_torch import envs as TEnvs
from repro_torch import scenarios as TS
from repro_torch.scenarios import perturb as TP

MODES = ("float32", "int8")


@pytest.mark.parametrize("freeze", (31, 15))
@pytest.mark.parametrize("mode", MODES)
def test_closed_loop_matches_jax(mode, freeze):
    """B = 4, 30 steps of stabilizer-wind with a jittered wind onset inside
    the episode; env state, schedule and rule carried from JAX."""
    quant = mode == "int8"
    spec = JS.SCENARIOS["stabilizer-wind"]
    env = spec.make_env()
    scfg = JS.controller_config(env, impl="xla", quant=quant)
    theta = JS.reference_rule(spec.env_name, scfg)
    prog = JS.make_closed_loop(env, scfg, batch=4, steps=30)
    vst = prog.venv.reset(jax.random.PRNGKey(3),
                          tasks=prog.init_tasks("train"))
    sched = JP.compile_schedule(
        env, (JP.ParamShift(param="wind", add=3.0, step=10, jitter=6),),
        jax.random.PRNGKey(1), 4)
    want = prog._rollout(prog.init_net(), vst, theta, sched,
                         jnp.int32(freeze), jax.random.PRNGKey(0))

    tspec = TS.SCENARIOS["stabilizer-wind"]
    tenv = tspec.make_env()
    tcfg = TS.controller_config(tenv, quant=quant)
    tprog = TS.make_closed_loop(tenv, tcfg, batch=4, steps=30)
    got = tprog.rollout(tprog.init_net(device="cpu"),
                        convert.vec_env_state(vst, device="cpu"),
                        convert.theta(theta, device="cpu"),
                        convert.schedule(sched, device="cpu"), freeze)
    np.testing.assert_allclose(got.rewards.numpy(), np.asarray(want.rewards),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.actions.numpy(), np.asarray(want.actions),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.env_state.phys.numpy(),
                               np.asarray(want.env_state.phys), rtol=0,
                               atol=1e-4)


# the sweep scenarios of the position and arm envs, their perturbation moved
# inside a 30-step episode and jittered per slot
NEW_SCENARIOS = {
    "arm-payload": lambda M: M.ParamShift(param="payload", add=1.5, step=10,
                                          jitter=6),
    "position-noise": lambda M: M.SensorNoise(std=0.4, bias=0.2, step=10,
                                              jitter=6),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(NEW_SCENARIOS))
def test_new_scenarios_closed_loop_match_jax(name, mode):
    """B = 4, 30 steps of arm-payload and position-noise with the reference
    rule; env state, schedule and rule carried from JAX, and the sensor
    noise JAX draws at each step fed to the port's draw.  Rewards, actions
    and physics within 1e-4; the int8 controller state (weights, membranes,
    traces) bit for bit."""
    from unittest import mock
    quant = mode == "int8"
    spec = JS.SCENARIOS[name]
    env = spec.make_env()
    scfg = JS.controller_config(env, impl="xla", quant=quant)
    theta = JS.reference_rule(spec.env_name, scfg)
    prog = JS.make_closed_loop(env, scfg, batch=4, steps=30)
    vst = prog.venv.reset(jax.random.PRNGKey(3),
                          tasks=prog.init_tasks("train"))
    sched = JP.compile_schedule(env, (NEW_SCENARIOS[name](JP),),
                                jax.random.PRNGKey(1), 4)
    key = jax.random.PRNGKey(0)
    want = prog._rollout(prog.init_net(), vst, theta, sched,
                         jnp.int32(31), key)
    # the rollout's observation noise: normal(fold_in(k_obs, t)) a step
    k_obs = jax.random.split(key)[0]
    noise = iter([torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(k_obs, t), (4, env.obs_dim), jnp.float32)))
        for t in range(30)])

    tspec = TS.SCENARIOS[name]
    tenv = tspec.make_env()
    tcfg = TS.controller_config(tenv, quant=quant)
    tprog = TS.make_closed_loop(tenv, tcfg, batch=4, steps=30)
    with mock.patch.object(TP.torch, "randn",
                           lambda *a, **k: next(noise)):
        got = tprog.rollout(tprog.init_net(device="cpu"),
                            convert.vec_env_state(vst, device="cpu"),
                            convert.theta(theta, device="cpu"),
                            convert.schedule(sched, device="cpu"), 31,
                            torch.Generator())
    assert next(noise, None) is None               # one draw a step, all fed
    for f in ("rewards", "actions"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-4, err_msg=f)
    np.testing.assert_allclose(got.env_state.phys.numpy(),
                               np.asarray(want.env_state.phys), rtol=0,
                               atol=1e-4)
    if quant:
        for a, b in zip(got.net.w + got.net.v + got.net.trace,
                        want.net.w + want.net.v + want.net.trace):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert any(w.any() for w in got.net.w)              # the rule acts


@pytest.mark.parametrize("name", TS.GATE_SCENARIOS)
@pytest.mark.parametrize("mode", MODES)
def test_recovery_gate_in_port(name, mode):
    """The paper's claim in the port: plastic recovers >= 1/2 of the return
    drop, frozen <= 1/4 (thresholds of tests/test_scenarios.py:318-321)."""
    spec = TS.SCENARIOS[name]
    env = spec.make_env()
    scfg = TS.controller_config(env, quant=(mode == "int8"))
    theta = TS.reference_rule(spec.env_name, scfg)
    prog = TS.make_closed_loop(env, scfg, batch=spec.batch, steps=spec.steps)
    sched = TS.compile_schedule(env, spec.perturbations,
                                torch.Generator().manual_seed(123),
                                spec.batch)
    res_p = prog.run(theta, 7, tasks=spec.tasks, schedule=sched,
                     device="cpu")
    res_f = prog.run(theta, 7, tasks=spec.tasks, schedule=sched,
                     freeze_at=spec.onset, device="cpu")
    mp = TS.adaptation_metrics(res_p.rewards, spec.onset, spec.window)
    mf = TS.adaptation_metrics(res_f.rewards, spec.onset, spec.window)
    assert mp["drop"] >= 0.02, mp
    assert mp["recovery_frac"] >= 0.5, mp
    assert mf["recovery_frac"] <= 0.25, mf
    assert mp["time_to_recover"] > 0, mp


@pytest.mark.parametrize("mode", MODES)
def test_freeze_at_zero_keeps_weights_exactly_zero(mode):
    spec = TS.SCENARIOS["stabilizer-wind"]
    env = spec.make_env()
    scfg = TS.controller_config(env, quant=(mode == "int8"))
    theta = TS.reference_rule(spec.env_name, scfg)
    prog = TS.make_closed_loop(env, scfg, batch=2, steps=20)
    res = prog.run(theta, 0, tasks=spec.tasks, freeze_at=0, device="cpu")
    for w in res.net.w:
        assert not w.any()
    res = prog.run(theta, 0, tasks=spec.tasks, device="cpu")
    assert any(w.any() for w in res.net.w)          # the rule does act


@pytest.mark.parametrize("name", sorted(TEnvs.ENVS))
def test_vector_env_matches_jax(name):
    """Observations, physics and rewards of B envs over 25 steps, from a
    reset carried from JAX, under per-slot dynamics parameters."""
    jenv, tenv = JEnvs.make(name), TEnvs.make(name)
    jv, tv = JS.VectorEnv(jenv, 3), TS.VectorEnv(tenv, 3)
    vst = jv.reset(jax.random.PRNGKey(5), tasks=jenv.train_tasks()[:3])
    vst = vst._replace(params=vst.params.at[1].multiply(1.3))
    tst = convert.vec_env_state(vst, device="cpu")
    jstep = jax.jit(jv.step)
    for t in range(25):
        a = np.sin(0.3 * t + np.arange(3 * jenv.act_dim, dtype=np.float32)
                   ).reshape(3, jenv.act_dim).astype(np.float32)
        np.testing.assert_allclose(tv.observe(tst).numpy(),
                                   np.asarray(jv.observe(vst)), atol=1e-5)
        vst, r = jstep(vst, a)
        tst, tr = tv.step(tst, torch.from_numpy(a))
        np.testing.assert_allclose(tst.phys.numpy(), np.asarray(vst.phys),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(r), atol=1e-5)
        np.testing.assert_array_equal(tst.t.numpy(), np.asarray(vst.t))


def test_schedule_application_matches_jax():
    """effective_state / transform_obs of a carried four-kind schedule."""
    jenv, tenv = JEnvs.make("direction"), TEnvs.make("direction")
    perts = (JP.ActuatorDropout(k=2, step=5, jitter=3),
             JP.ParamShift(param="gain", scale=0.5, add=0.2, spread=0.3,
                           step=8),
             JP.GoalSwitch(step=12, frac=0.5),
             JP.SensorNoise(std=0.0, bias=0.2, step=3))
    sched = JP.compile_schedule(jenv, perts, jax.random.PRNGKey(4), 6)
    vst = JS.VectorEnv(jenv, 6).reset(jax.random.PRNGKey(1))
    tsched = convert.schedule(sched, device="cpu")
    tst = convert.vec_env_state(vst, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in (0, 4, 9, 13, 40):
        je = JP.effective_state(sched, vst, t)
        te = TP.effective_state(tsched, tst, t)
        for f in ("actuator_mask", "params", "task"):
            np.testing.assert_allclose(getattr(te, f).numpy(),
                                       np.asarray(getattr(je, f)), atol=1e-6)
        obs = jnp.ones((6, jenv.obs_dim))
        np.testing.assert_allclose(
            TP.transform_obs(tsched, torch.ones(6, tenv.obs_dim), t,
                             gen).numpy(),
            np.asarray(JP.transform_obs(sched, obs, t,
                                        jax.random.PRNGKey(2))), atol=1e-6)


@pytest.mark.parametrize("kind", ("dropout", "noise", "shift", "goal"))
def test_compile_schedule_draws(kind):
    """The port draws its own per-slot randomization (torch.Generator):
    same shapes as JAX, deterministic in the seed, hits what it says."""
    env = TEnvs.make("direction")
    pert = {"dropout": TP.ActuatorDropout(k=3, step=4, jitter=2),
            "noise": TP.SensorNoise(std=0.3, bias=0.1, step=2),
            "shift": TP.ParamShift(param="damping", scale=2.0, spread=0.1),
            "goal": TP.GoalSwitch(step=7, frac=0.5)}[kind]
    draw = lambda s: TS.compile_schedule(
        env, (pert,), torch.Generator().manual_seed(s), 16)
    a, b = draw(0), draw(0)
    jsched = JP.compile_schedule(JEnvs.make("direction"),
                                 (getattr(JP, type(pert).__name__)(),),
                                 jax.random.PRNGKey(0), 16)
    for f in TP.Schedule._fields:
        assert tuple(getattr(a, f).shape) == tuple(getattr(jsched, f).shape)
        assert torch.equal(getattr(a, f), getattr(b, f))
    if kind == "dropout":
        assert (a.act_mask[0].sum(1) == env.act_dim - 3).all()
        assert ((a.onset[0] >= 4) & (a.onset[0] <= 6)).all()
    elif kind == "goal":
        assert ((a.onset[0] == 7) | (a.onset[0] == TP.NEVER)).all()


def test_adaptation_metrics_copy_agrees():
    rng = np.random.default_rng(0)
    r = rng.standard_normal((120, 4))
    r[60:] -= 1.0
    r[100:] += 0.8
    assert TS.adaptation_metrics(torch.from_numpy(r), 60, 20) == \
        JS.adaptation_metrics(r, 60, 20)


def test_bf16_closed_loop_within_jax_spread():
    """The reference controller of stabilizer-wind in bfloat16, B = 8, 40
    steps with a jittered wind onset; env state, schedule and rule carried
    from JAX.  JAX's two paths differ here (``xla`` rounds every step,
    ``pallas-interpret`` carries float32 across each window); the port's
    windows follow the kernel, so its episode mean reward lies within
    JAX's xla-vs-interpreter spread of the interpreter's, and its rewards
    within atol = 1e-4 of the interpreter's (the env tolerance above)."""
    import dataclasses
    spec = JS.SCENARIOS["stabilizer-wind"]
    env = spec.make_env()
    sched = vst = theta = None
    want = {}
    for impl in ("xla", "pallas-interpret"):
        scfg = dataclasses.replace(JS.controller_config(env, impl=impl),
                                   dtype=jnp.bfloat16)
        theta = JS.reference_rule(spec.env_name, scfg)
        prog = JS.make_closed_loop(env, scfg, batch=8, steps=40)
        vst = prog.venv.reset(jax.random.PRNGKey(3),
                              tasks=prog.init_tasks("train"))
        sched = JP.compile_schedule(
            env, (JP.ParamShift(param="wind", add=3.0, step=10, jitter=6),),
            jax.random.PRNGKey(1), 8)
        want[impl] = np.asarray(prog._rollout(
            prog.init_net(), vst, theta, sched, jnp.int32(41),
            jax.random.PRNGKey(0)).rewards)
    tspec = TS.SCENARIOS["stabilizer-wind"]
    tenv = tspec.make_env()
    tcfg = dataclasses.replace(TS.controller_config(tenv),
                               dtype=torch.bfloat16)
    tprog = TS.make_closed_loop(tenv, tcfg, batch=8, steps=40)
    got = tprog.rollout(tprog.init_net(device="cpu"),
                        convert.vec_env_state(vst, device="cpu"),
                        convert.theta(theta, device="cpu"),
                        convert.schedule(sched, device="cpu"), 41)
    assert got.actions.dtype == torch.bfloat16
    assert got.net.w[0].dtype == torch.bfloat16
    pal, xla = want["pallas-interpret"], want["xla"]
    spread = abs(float(xla.mean()) - float(pal.mean()))
    assert abs(float(got.rewards.mean()) - float(pal.mean())) <= spread
    np.testing.assert_allclose(got.rewards.numpy(), pal, rtol=0, atol=1e-4)
