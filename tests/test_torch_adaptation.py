"""The paper's Phase 1 rule search (PEPG) and Phase 2 evaluation in the
PyTorch port against the JAX reference under `jax.jit` (CPU tensors: the
plain versions of the kernels), and the harness remainder (`record=`,
`inject_anomaly`).

Randomness differs between the frameworks, so ES draws and env resets are
made on the JAX side and carried across: `tell` is fed JAX's own `ask` eps,
and the port's envs replay JAX's reset physics (`_replaying`).  The PEPG
update agrees within 1e-6 (its products sum in another order than XLA's),
its elitism fields exactly; rewards within atol = 1e-4 a step, the
closed-loop tolerance of tests/test_torch_scenarios.py (XLA contracts the
env dynamics into fused multiply-adds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as JEnvs
from repro import scenarios as JS
from repro.core import adaptation as JA
from repro.core import es as JES
from repro.core import snn as JSNN
from repro.scenarios import harness as JH
from repro_torch import convert
from repro_torch import envs as TEnvs
from repro_torch import scenarios as TS
from repro_torch.core import adaptation as TA
from repro_torch.core import es as TES
from repro_torch.core import snn as TSNN
from repro_torch.scenarios import harness as TH

STEPS = 30
CFG = dict(hidden=16, timesteps=2)          # 11-16-2, T = 2


def _replaying(env, resets):
    """``env`` whose successive `init_phys` calls return ``resets`` (each a
    (B, phys_dim) array) in order: JAX's reset physics, carried."""
    it = iter(resets)

    class Replaying(type(env)):
        def init_phys(self, batch, generator):
            phys = torch.from_numpy(np.array(next(it), np.float32))
            assert phys.shape[0] == batch
            return phys.to(generator.device)

    return Replaying(**{f.name: getattr(env, f.name)
                        for f in dataclasses.fields(env)})


# ---- PEPG -------------------------------------------------------------------

@pytest.mark.parametrize("ties", (False, True), ids=("distinct", "ties"))
@pytest.mark.parametrize("rank_shaping", (True, False),
                         ids=("ranked", "raw"))
def test_tell_matches_jax(rank_shaping, ties):
    """20 generations on a quadratic, JAX's `ask` eps fed to both `tell`s:
    each generation's update from the same (carried) state within 1e-6 and
    its elitism fields exactly; the port's own chain of 20 updates within
    1e-6 of JAX's chain."""
    cfg = JES.PEPGConfig(num_params=6, pop_pairs=8, lr_mu=0.3,
                         sigma_init=0.3, rank_shaping=rank_shaping)
    tcfg = TES.PEPGConfig(**dataclasses.asdict(cfg))
    target = jnp.asarray([1.0, -2.0, 0.5, 3.0, 0.0, -1.0])
    jtell, jask = jax.jit(JES.tell, static_argnums=0), \
        jax.jit(JES.ask, static_argnums=0)
    state = JES.init(cfg, jax.random.PRNGKey(0))
    own = convert.pepg_state(state, device="cpu")
    for g in range(20):
        pop, eps = jask(cfg, state, jax.random.PRNGKey(100 + g))
        fit = -np.sum((np.asarray(pop) - np.asarray(target)) ** 2, axis=-1)
        if ties:
            # coarse fitness: several candidates tie, the best among them
            fit = np.round(fit, 0).astype(np.float32)
            fit[3] = fit[11] = fit.max()
        fit = fit.astype(np.float32)
        t_eps, t_fit = torch.from_numpy(np.array(eps)), torch.from_numpy(fit)
        got = TES.tell(tcfg, convert.pepg_state(state, device="cpu"), t_eps,
                       t_fit)
        own = TES.tell(tcfg, own, t_eps, t_fit)
        state = jtell(cfg, state, eps, jnp.asarray(fit))
        for f in ("mu", "sigma", "baseline"):
            want = np.asarray(getattr(state, f))
            np.testing.assert_allclose(getattr(got, f).numpy(), want,
                                       rtol=0, atol=1e-6, err_msg=f)
            np.testing.assert_allclose(getattr(own, f).numpy(), want,
                                       rtol=0, atol=1e-6, err_msg=f)
        for f in ("best_fitness", "best_theta", "step"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(state, f)), f)
        np.testing.assert_array_equal(own.best_fitness.numpy(),
                                      np.asarray(state.best_fitness))
        np.testing.assert_allclose(own.best_theta.numpy(),
                                   np.asarray(state.best_theta), rtol=0,
                                   atol=1e-6)


def test_rank_shape_ties_rank_in_population_order():
    f = torch.tensor([0.5, -1.0, 0.5, 2.0, 0.5])
    np.testing.assert_array_equal(
        TES._rank_shape(f).numpy(),
        np.asarray(JES._rank_shape(jnp.asarray(f.numpy()))))


def test_pepg_optimizes_quadratic():
    """The mirror of tests/test_envs_adaptation.py TestPEPG."""
    cfg = TES.PEPGConfig(num_params=4, pop_pairs=16, lr_mu=0.3,
                         sigma_init=0.3, rank_shaping=True)
    target = torch.tensor([1.0, -2.0, 0.5, 3.0])

    def fitness(pop, seed):
        return -((pop - target) ** 2).sum(dim=-1)

    state, hist = TES.run(cfg, fitness, torch.Generator().manual_seed(0),
                          150)
    assert float(((state.mu - target) ** 2).sum()) < 0.5
    assert float(hist[-1]) > float(hist[0])
    assert hist.shape == (150,) and int(state.step) == 150


def test_pepg_antithetic_layout_and_elitism():
    cfg = TES.PEPGConfig(num_params=3, pop_pairs=5)
    gen = torch.Generator().manual_seed(0)
    state = TES.init(cfg, gen)
    pop, eps = TES.ask(cfg, state, gen)
    assert pop.shape == (10, 3)
    np.testing.assert_allclose((pop[:5] + pop[5:]).numpy(),
                               (2 * state.mu[None]).expand(5, 3).numpy(),
                               atol=1e-6)
    state = TES.tell(cfg, state, eps, torch.arange(10.0))
    assert float(state.best_fitness) == 9.0
    assert torch.equal(state.best_theta, pop[9])
    # a worse generation keeps the elite
    state = TES.tell(cfg, state, eps, -torch.arange(10.0))
    assert float(state.best_fitness) == 9.0
    assert torch.equal(state.best_theta, pop[9])


def test_run_is_deterministic_in_the_generator_seed():
    cfg = TES.PEPGConfig(num_params=5, pop_pairs=4)
    seeds = []

    def fitness(pop, seed):
        seeds.append(seed)
        return -(pop ** 2).sum(dim=-1)

    a = TES.run(cfg, fitness, torch.Generator().manual_seed(3), 4)
    b = TES.run(cfg, fitness, torch.Generator().manual_seed(3), 4)
    assert torch.equal(a[0].mu, b[0].mu) and torch.equal(a[1], b[1])
    assert seeds[:4] == seeds[4:] and len(set(seeds[:4])) == 4


def test_run_takes_the_jax_call_form_with_log_every(capsys):
    """``es.run(cfg, fit, gen, n, log_every=k)``, as the JAX package's
    callers write it, runs the same search and logs every k-th
    generation; 0 logs nothing."""
    cfg = TES.PEPGConfig(num_params=5, pop_pairs=4)

    def fitness(pop, seed):
        return -(pop ** 2).sum(dim=-1)

    jstate, jhist = JES.run(JES.PEPGConfig(num_params=5, pop_pairs=4),
                            lambda p, k: -(p ** 2).sum(-1),
                            jax.random.PRNGKey(0), 4, log_every=2)
    assert jhist.shape == (4,)
    quiet = TES.run(cfg, fitness, torch.Generator().manual_seed(3), 4)
    assert capsys.readouterr().out == ""
    state, hist = TES.run(cfg, fitness, torch.Generator().manual_seed(3), 4,
                          log_every=2)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "es generation 2/4", "es generation 4/4"]
    assert f"{float(hist[3]):.6g}" in lines[1]
    assert torch.equal(state.mu, quiet[0].mu) and torch.equal(hist, quiet[1])


# ---- Phase 1 fitness and Phase 2 against JAX ---------------------------------

def _jax_episode_rewards(env, scfg, vec, task, key):
    """`repro.core.adaptation.episode_return`'s loop, returning the per-step
    rewards instead of their sum (the reference for a per-step check)."""
    k_env, k_enc = jax.random.split(key)
    state = JSNN.init_state(scfg)
    if scfg.plastic:
        theta = JSNN.unflatten_theta(scfg, vec)
    else:
        theta = JSNN.init_theta(scfg, jax.random.PRNGKey(0), scale=0.0)
        state = dataclasses.replace(
            state, w=tuple(JA.unflatten_weights(scfg, vec)))
    est = env.reset(k_env, task)

    def step(carry, t):
        est, st = carry
        st, action = JSNN.controller_step(scfg, st, theta, env.observe(est),
                                          k_enc)
        est, r = env.step(est, action)
        return (est, st), r

    return jax.lax.scan(step, (est, state), jnp.arange(env.episode_len))[1]


def _population(rng, n, plastic, scfg):
    size = (JSNN.theta_size(scfg) if plastic else JA.weight_size(scfg))
    return (rng.standard_normal((n, size))
            * (0.05 if plastic else 0.5)).astype(np.float32)


@pytest.mark.parametrize("plastic", (True, False),
                         ids=("plastic", "weight-trained"))
def test_fitness_matches_jax(plastic):
    """A 4-candidate population at 11-16-2, T = 2, 30 steps on position's 8
    train goals: every candidate's per-step rewards on every task within
    1e-4 of JAX's B = 1 episodes, from JAX's resets; the fitness within
    1e-4 of JAX's `make_fitness_fn` under `jax.jit`."""
    jenv = JEnvs.make("position", episode_len=STEPS)
    cfg = JA.AdaptationConfig(**CFG)
    scfg = JA.make_snn_config(jenv, cfg, plastic=plastic)
    pop = _population(np.random.default_rng(5), 4, plastic, scfg)
    tasks = jenv.train_tasks()
    key = jax.random.PRNGKey(9)
    want_fit = np.asarray(jax.jit(JA.make_fitness_fn(jenv, scfg, tasks))(
        jnp.asarray(pop), key))

    # JAX's key tree: a key per candidate, split per task, then env/enc
    cand_keys = jax.random.split(key, 4)
    task_keys = [jax.random.split(k, tasks.shape[0]) for k in cand_keys]
    per_step = jax.jit(jax.vmap(jax.vmap(
        lambda v, task, k: _jax_episode_rewards(jenv, scfg, v, task, k),
        (None, 0, 0)), (0, None, 0)))(jnp.asarray(pop), tasks,
                                      jnp.stack(task_keys))
    want = np.asarray(per_step)                        # (P, T, steps)
    # the same episodes: the sums differ only in summation order
    np.testing.assert_allclose(want.sum(-1).mean(-1), want_fit, rtol=1e-6)
    resets = [np.stack([np.asarray(jenv.init_phys(jax.random.split(k)[0]))
                        for k in keys]) for keys in task_keys]

    tenv = TEnvs.make("position", episode_len=STEPS)
    tcfg = TA.make_snn_config(tenv, TA.AdaptationConfig(**CFG),
                              plastic=plastic)
    t_pop = torch.from_numpy(pop)
    got = TA.population_rewards(_replaying(tenv, resets), tcfg, t_pop,
                                tenv.train_tasks(), [0] * 4)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, rtol=0,
                               atol=1e-4)
    fit = TA.make_fitness_fn(_replaying(tenv, resets), tcfg,
                             tenv.train_tasks())(t_pop, 0)
    assert fit.shape == (4,)
    np.testing.assert_allclose(fit.numpy(), want_fit, rtol=0, atol=1e-4)


@pytest.mark.parametrize("failure", (False, True), ids=("clean", "masked"))
@pytest.mark.parametrize("plastic", (True, False),
                         ids=("plastic", "weight-trained"))
def test_evaluate_generalization_matches_jax(plastic, failure):
    """Phase 2 on the 72 unseen goals at 11-16-2, T = 2, 30 steps, clean
    and with actuator 0 dead from step 10: the per-step rewards of the
    port's B = 72 loop within 1e-4 of the loop JAX's
    `evaluate_generalization` runs, from its resets, and the returns
    within 1e-4 of that function's."""
    jenv = JEnvs.make("position", episode_len=STEPS)
    scfg = JA.make_snn_config(jenv, JA.AdaptationConfig(**CFG),
                              plastic=plastic)
    params = _population(np.random.default_rng(8), 1, plastic, scfg)[0]
    mask = np.array([0.0, 1.0], np.float32) if failure else None
    kw = dict(actuator_mask=None if mask is None else jnp.asarray(mask),
              mask_after=10 if failure else None)
    want_ret = np.asarray(JA.evaluate_generalization(
        jenv, scfg, jnp.asarray(params), seed=1, **kw))
    # the loop evaluate_generalization runs, for its per-step rewards
    prog = JH.make_closed_loop(jenv, scfg, batch=72, steps=STEPS)
    sched = None
    if failure:
        sched = JS.compile_schedule(
            jenv, (JS.ActuatorDropout(step=10, mask=(0.0, 1.0)),),
            jax.random.PRNGKey(1), 72)
    if plastic:
        theta, w0 = jnp.asarray(params), None
    else:
        theta = JSNN.flatten_theta(JSNN.init_theta(
            scfg, jax.random.PRNGKey(0), scale=0.0))
        w0 = JA.unflatten_weights(scfg, jnp.asarray(params))
    want = np.asarray(prog.run(theta, jax.random.PRNGKey(1),
                               tasks=jenv.eval_tasks(), schedule=sched,
                               w0=w0).rewards)
    np.testing.assert_allclose(want.sum(0), want_ret, rtol=1e-6)
    k_env = jax.random.split(jax.random.PRNGKey(1))[0]
    resets = [np.asarray(prog.venv.reset(k_env).phys)]

    tenv = TEnvs.make("position", episode_len=STEPS)
    tcfg = TA.make_snn_config(tenv, TA.AdaptationConfig(**CFG),
                              plastic=plastic)
    seen = []
    real = TH.ClosedLoop.rollout

    def recording(self, *a, **k):
        seen.append(real(self, *a, **k).rewards)
        return real(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TH.ClosedLoop, "rollout", recording)
        got_ret = TA.evaluate_generalization(
            _replaying(tenv, resets), tcfg, torch.from_numpy(params),
            seed=1, actuator_mask=None if mask is None
            else torch.from_numpy(mask),
            mask_after=10 if failure else None, device="cpu")
    assert got_ret.shape == (72,)
    np.testing.assert_allclose(seen[0].numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_ret.numpy(), want_ret, rtol=0,
                               atol=1e-4)


def test_episode_return_matches_jax():
    """One B = 1 episode with actuator 0 dead from step 10, the plastic
    rule, from JAX's reset: within 1e-4 of JAX's `episode_return`."""
    jenv = JEnvs.make("position", episode_len=STEPS)
    scfg = JA.make_snn_config(jenv, JA.AdaptationConfig(**CFG))
    vec = _population(np.random.default_rng(2), 1, True, scfg)[0]
    key, task = jax.random.PRNGKey(4), jenv.train_tasks()[3]
    mask = np.array([0.0, 1.0], np.float32)
    want = float(jax.jit(lambda v: JA.episode_return(
        jenv, scfg, v, task, key, actuator_mask=jnp.asarray(mask),
        mask_after=10))(jnp.asarray(vec)))
    resets = [np.asarray(jenv.init_phys(jax.random.split(key)[0]))[None]]
    tenv = TEnvs.make("position", episode_len=STEPS)
    tcfg = TA.make_snn_config(tenv, TA.AdaptationConfig(**CFG))
    got = TA.episode_return(_replaying(tenv, resets), tcfg,
                            torch.from_numpy(vec), tenv.train_tasks()[3], 4,
                            actuator_mask=torch.from_numpy(mask),
                            mask_after=10, device="cpu")
    assert got.shape == ()
    assert abs(float(got) - want) <= 1e-4 * STEPS, (float(got), want)


def test_candidates_reset_from_their_own_seeds():
    """Candidate c resets from ``fold_seed(seed, c)``; with ``crn`` every
    candidate from ``seed``."""
    assert TA.candidate_seeds(7, 3) == [TES.fold_seed(7, c)
                                        for c in range(3)]
    assert TA.candidate_seeds(7, 3, crn=True) == [7, 7, 7]
    env = TEnvs.make("position", episode_len=5)
    scfg = TA.make_snn_config(env, TA.AdaptationConfig(**CFG))
    pop = torch.zeros(2, TSNN.theta_size(scfg)) + 0.01
    fit = TA.make_fitness_fn(env, scfg, env.train_tasks())
    crn = TA.make_fitness_fn(env, scfg, env.train_tasks(), crn=True)
    assert float(fit(pop, 1)[0]) != float(fit(pop, 1)[1])
    assert float(crn(pop, 1)[0]) == float(crn(pop, 1)[1])


# ---- the two phases end to end -------------------------------------------------

def test_phase1_improves_fitness_and_phase2_runs():
    """The mirror of tests/test_envs_adaptation.py TestTwoPhase: a short
    search on direction (episode 40, 11 -> 16 hidden, 8 generations of 16
    candidates) finds better rules than it started with; the rule and the
    weight-trained baseline then run on the 72 unseen tasks."""
    env = TEnvs.make("direction", episode_len=40)
    cfg = TA.AdaptationConfig(hidden=16, timesteps=2, pop_pairs=8,
                              generations=8)
    theta, hist, scfg = TA.optimize_rule(env, cfg, device="cpu")
    assert hist.shape == (8,) and theta.shape == (TSNN.theta_size(scfg),)
    assert float(hist.max()) > float(hist[0])
    rets = TA.evaluate_generalization(env, scfg, theta, device="cpu")
    assert rets.shape == (72,) and bool(torch.isfinite(rets).all())
    w, _, wcfg = TA.optimize_rule(
        env, dataclasses.replace(cfg, generations=1), plastic=False,
        device="cpu")
    assert not wcfg.plastic and w.shape == (TA.weight_size(wcfg),)
    mask = torch.ones(env.act_dim)
    mask[0] = 0.0
    rets = TA.evaluate_generalization(env, wcfg, w, actuator_mask=mask,
                                      mask_after=20, device="cpu")
    assert rets.shape == (72,) and bool(torch.isfinite(rets).all())


def test_entry_points_default_to_the_card():
    """``device=None`` is the card: without one they raise instead of
    running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = TEnvs.make("position", episode_len=5)
    cfg = TA.AdaptationConfig(**CFG, generations=1, pop_pairs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.optimize_rule(env, cfg)
    scfg = TA.make_snn_config(env, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.evaluate_generalization(env, scfg,
                                   torch.zeros(TSNN.theta_size(scfg)))


def test_theta_and_weight_sizes_match_jax():
    for hidden in (16, 128):
        jenv, tenv = JEnvs.make("position"), TEnvs.make("position")
        j = JA.make_snn_config(jenv, JA.AdaptationConfig(hidden=hidden))
        t = TA.make_snn_config(tenv, TA.AdaptationConfig(hidden=hidden))
        assert TSNN.theta_size(t) == JSNN.theta_size(j)
        assert TA.weight_size(t) == JA.weight_size(j)
    # the paper's width: 4 x (11 x 128 + 128 x 2) coefficients
    assert TSNN.theta_size(t) == 6656


# ---- the harness remainder -----------------------------------------------------

def test_run_record_metrics_snapshot_has_jax_keys():
    """`run(record=True)` rolls up into the same metrics as JAX's; the
    compile count stays at one static signature across schedules of one
    shape and grows with a new one."""
    spec = JS.SCENARIOS["stabilizer-wind"]
    env = spec.make_env()
    jprog = JS.make_closed_loop(env, JS.controller_config(env), batch=2,
                                steps=10)
    jprog.run(JS.reference_rule(spec.env_name, jprog.scfg),
              jax.random.PRNGKey(0), record=True)
    want = jprog.metrics_snapshot()

    tspec = TS.SCENARIOS["stabilizer-wind"]
    tenv = tspec.make_env()
    tprog = TS.make_closed_loop(tenv, TS.controller_config(tenv), batch=2,
                                steps=10)
    theta = TS.reference_rule(tspec.env_name, tprog.scfg)
    res = tprog.run(theta, 0, record=True, device="cpu")
    got = tprog.metrics_snapshot()
    assert set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k]), k
        assert got[k]["type"] == want[k]["type"]
    assert got["closed_loop_rollouts_total"]["value"] == 1
    assert got["closed_loop_compile_count"]["value"] == 1
    assert got["closed_loop_mean_reward"]["value"] == pytest.approx(
        float(res.rewards.mean()))
    sched = TS.compile_schedule(tenv, tspec.perturbations,
                                torch.Generator().manual_seed(1), 2)
    tprog.run(theta, 1, schedule=sched, device="cpu")
    tprog.run(theta, 2, schedule=sched, freeze_at=3, device="cpu")
    assert tprog.compile_count() == 2           # K = 0 and K = 1 schedules


def test_init_net_w0_broadcasts_and_refuses_fixed_point():
    env = TEnvs.make("position")
    scfg = TA.make_snn_config(env, TA.AdaptationConfig(hidden=16),
                              plastic=False)
    prog = TS.make_closed_loop(env, scfg, batch=3, steps=4)
    w0 = TA.unflatten_weights(scfg, torch.arange(
        TA.weight_size(scfg), dtype=torch.float32))
    net = prog.init_net(w0, device="cpu")
    for w, want in zip(net.w, w0):
        assert w.shape == (3, *want.shape)
        assert all(torch.equal(w[b], want) for b in range(3))
    qprog = TS.make_closed_loop(env, TSNN.quant_config(scfg), batch=3,
                                steps=4)
    with pytest.raises(ValueError, match="float-mode"):
        qprog.init_net(w0, device="cpu")


def test_run_closed_loop_is_make_then_run():
    spec = TS.SCENARIOS["position-noise"]
    env = spec.make_env()
    scfg = TS.controller_config(env)
    theta = TS.reference_rule(spec.env_name, scfg)
    a = TS.run_closed_loop(env, scfg, theta, 3, batch=2, steps=12,
                           device="cpu")
    b = TS.make_closed_loop(env, scfg, batch=2, steps=12).run(
        theta, 3, device="cpu")
    assert torch.equal(a.rewards, b.rewards)


@pytest.mark.parametrize("kind", sorted(JS.ANOMALIES))
def test_inject_anomaly_matches_jax(kind):
    drive = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    for noise in (0.0, 0.3):
        jp = JS.AnomalyPreset(kind, gain=4.0, noise_std=noise)
        tp = TS.AnomalyPreset(kind, gain=4.0, noise_std=noise)
        for t, seed in ((0, 0), (5, 3)):
            want = JS.inject_anomaly(jp, drive, t, seed)
            got = TS.inject_anomaly(tp, drive, t, seed)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert TS.ANOMALIES == JS.ANOMALIES
    with pytest.raises(ValueError, match="unknown anomaly"):
        TS.AnomalyPreset("bogus")
