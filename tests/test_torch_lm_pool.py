"""The LM decode pool's model layer in the PyTorch port, against the JAX
package under `jax.jit` on the same inputs, on the smoke configs of
qwen3-4b (``dense``), mamba2-1.3b (``ssm``) and zamba2-7b (``hybrid``) in
float32 with an 8-neuron adapter (as tests/test_serving_lm.py sizes it):

  * `factory.Model.cache_axes` and `session_template` leaf for leaf against
    JAX's, at smoke and at full width (plans only, nothing allocated);
  * `decode_step(active=)` with a vacant slot and `decode_rollout` on a
    pool built by JAX's `LMScheduler`: logits and every cache leaf (the
    backbone within rtol = atol = 1e-4, the int8 adapter bit for bit, the
    float32 adapter within 1e-5), vacant rows bit-frozen;
  * `plastic.decode_rollout` against JAX's and against K port
    `decode_step` calls (equal bit for bit: on the CPU both run the plain
    fleet step);
  * `obs.adapter_telemetry` per step and per window, `adapter_weight_norm`
    and `AdapterFlightRecorder` (ring, flags, summary file) against JAX's;
  * the window kernel's plan at the adapter's 128 x 128 (`fused.fleet_plan`
    through `fused.fleet_fit`, the tile `engine.rollout` takes by default),
    and its refusal where no stream fits.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import factory as j_factory
from repro.models import plastic as j_plastic
from repro.models.layers import init_from_plan as j_init_from_plan
from repro.obs import HealthConfig as JHealthConfig
from repro.obs import recorder as JR
from repro.obs import telemetry as JT
from repro.serving import LMScheduler as JLMScheduler
from repro_torch import convert
from repro_torch.checkpoint import manager as TM
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.plasticity import fused
from repro_torch.models import factory, plastic
from repro_torch.obs import (AdapterFlightRecorder, HealthConfig,
                             adapter_telemetry, adapter_weight_norm)

ARCHS = ("qwen3-4b", "mamba2-1.3b", "zamba2-7b")
MAX_LEN = 24
H100_SMEM = 232448           # shared_memory_per_block_optin of the H100


def _cfgs(arch, quant, neurons=8, smoke=True):
    over = dict(dtype="float32", plastic_adapter=True,
                adapter_neurons=neurons, adapter_quant=quant)
    jget, tget = (j_get_smoke, get_smoke) if smoke else (j_get_config,
                                                          get_config)
    return (jget(arch).with_(adapter_impl="xla", **over),
            tget(arch).with_(**over))


def _prompt(uid, n, vocab):
    """A deterministic prompt per uid (no string hashing)."""
    rng = np.random.RandomState(sum(map(ord, uid)) * 7 + n)
    return rng.randint(0, vocab, size=n).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """Per (arch, quant): both configs, both models and the parameters
    (JAX's, carried into the port), made at first use."""
    made = {}

    def get(arch, quant):
        if (arch, quant) not in made:
            jcfg, tcfg = _cfgs(arch, quant)
            jmodel = j_factory.build(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            jparams["adapter"]["scale"] = jnp.float32(0.5)
            made[arch, quant] = (jmodel, jparams, factory.build(tcfg),
                                 convert.lm_params(jparams, tcfg, "cpu"))
        return made[arch, quant]
    return get


def _paths_and_leaves(jtree):
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    return ([jax.tree_util.keystr(p) for p, _ in flat],
            [np.asarray(x) for _, x in flat])


def _port_paths(tree):
    paths, leaves = TM.flatten(tree)
    return [p.replace("/", "") for p in paths], leaves


def _assert_tree_close(got, want, what, adapter_exact):
    """The port's tree against JAX's leaf for leaf: dtypes equal; integer
    leaves (int8 weights, int32 state, indices) bit for bit; the adapter's
    float leaves within 1e-5, the backbone's within 1e-4."""
    gp, gl = _port_paths(got)
    wp, wl = _paths_and_leaves(want)
    assert gp == wp, what
    for path, g, w in zip(gp, gl, wl):
        g = g.numpy()
        assert g.dtype == w.dtype, (what, path)
        if not np.issubdtype(w.dtype, np.floating) or (
                adapter_exact and "adapter" in path and "v1" not in path):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")
        else:
            tol = 1e-5 if "adapter" in path else 1e-4
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{what} {path}")


def _port_tree(like, jtree):
    """JAX's tree as tensors in the structure of the port's ``like``."""
    leaves = jax.tree.leaves(jtree)
    assert len(leaves) == len(TM.flatten(like)[1])
    return TM.unflatten(like, [convert.tensor(x, "cpu") for x in leaves])


# ---- the pool plumbing: slot axes and the session template ------------------

@pytest.mark.parametrize("smoke", (True, False), ids=("smoke", "full"))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_and_session_template_equal_jax(arch, smoke):
    jcfg, tcfg = _cfgs(arch, True, neurons=128, smoke=smoke)
    jm, tm = j_factory.build(jcfg), factory.build(tcfg)
    max_len = 64
    jpaths, jaxes = _paths_and_leaves(jm.cache_axes(max_len))
    tpaths, taxes = _port_paths(tm.cache_axes(max_len))
    assert tpaths == jpaths and [int(a) for a in taxes] == jaxes
    if arch == "zamba2-7b":            # a zsuper's stacked inner caches
        assert tm.cache_axes(max_len)["segments"][0]["ssm"] == {
            "conv": 2, "ssm": 2}
    jt = jax.tree_util.tree_flatten_with_path(
        jm.session_template(max_len))[0]
    tpaths, tleaves = _port_paths(tm.session_template(max_len))
    assert tpaths == [jax.tree_util.keystr(p) for p, _ in jt]
    for t, (path, s) in zip(tleaves, jt):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape), path
        assert str(t.dtype).replace("torch.", "") == str(s.dtype), path


def test_session_from_prefill_squeezes_the_slot_axis(models):
    jm, jp, tm, tp = models("zamba2-7b", True)
    prompt = _prompt("p", 5, tm.cfg.vocab)
    _, cache = tm.prefill(tp, torch.from_numpy(prompt).long()[None], MAX_LEN)
    sess = tm.session_from_prefill(cache)
    template = tm.session_template(MAX_LEN)
    for (path, s), t in zip(zip(*TM.flatten(sess)),
                            TM.flatten(template)[1]):
        assert (tuple(s.shape), s.dtype) == (tuple(t.shape), t.dtype), path
    assert int(sess["index"]) == 5
    with pytest.raises(ValueError, match="batch = 1"):
        _, c2 = tm.prefill(tp, torch.zeros((2, 5), dtype=torch.long),
                           MAX_LEN)
        tm.session_from_prefill(c2)


# ---- decode_step(active=) and decode_rollout against jitted JAX -------------

def _jax_pool(jm, jp):
    """A 3-slot JAX pool: streams of 6 and 4 tokens in slots 0 and 2, slot
    1 vacant (admitted, stepped, evicted)."""
    s = JLMScheduler(jm, jp, slots=3, max_len=MAX_LEN)
    vocab = jm.cfg.vocab
    s.admit_prompt("a", _prompt("a", 6, vocab))
    s.admit_prompt("b", _prompt("b", 3, vocab))
    s.admit_prompt("c", _prompt("c", 4, vocab))
    s.step()
    s.evict("b")
    return s


@pytest.mark.parametrize("quant", (False, True), ids=("f32", "int8"))
@pytest.mark.parametrize("arch", ARCHS)
def test_pool_decode_step_and_rollout_match_jax(arch, quant, models):
    jm, jp, tm, tp = models(arch, quant)
    js = _jax_pool(jm, jp)
    jcache, jtok = js.pool["cache"], js.pool["tok"]
    active_j = js._active_mask()
    active = torch.from_numpy(np.asarray(active_j))
    assert active.tolist() == [True, False, True]
    like = tm.pool_cache(3, MAX_LEN, "cpu")

    # one step with the vacant slot
    tcache = _port_tree(like, jcache)
    vacant = [t.select(ax, 1).clone() for t, ax in zip(TM.flatten(tcache)[1],
                               TM.flatten(tm.cache_axes(MAX_LEN))[1])]
    jl, jc = jax.jit(jm.decode_step)(jp, jcache, jtok[:, None],
                                     active=active_j)
    tl, tc = tm.decode_step(tp, tcache, torch.from_numpy(
        np.asarray(jtok)).long()[:, None], active=active)
    act = active.numpy()
    np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                               rtol=1e-4, atol=1e-4)
    assert (tl.numpy()[act].argmax(-1) == np.asarray(jl)[act].argmax(-1)
            ).all()
    _assert_tree_close(tc, jc, f"{arch} step", quant)
    for v, t, ax in zip(vacant, TM.flatten(tc)[1],
                        TM.flatten(tm.cache_axes(MAX_LEN))[1]):
        assert torch.equal(v, t.select(ax, 1))
    assert tc["index"].tolist() == np.asarray(jc["index"]).tolist()

    # a K = 3 window from the same pool
    k = 3
    toks = np.stack([_prompt(f"w{s}", k, tm.cfg.vocab) for s in range(3)])
    tcache = _port_tree(like, jcache)
    jl, jc = jax.jit(jm.decode_rollout)(jp, jcache, jnp.asarray(toks),
                                        active=active_j)
    tl, tc = tm.decode_rollout(tp, tcache, torch.from_numpy(toks).long(),
                               active=active)
    assert tl.shape == (3, k, tm.cfg.vocab)
    np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                               rtol=1e-4, atol=1e-4)
    _assert_tree_close(tc, jc, f"{arch} window", quant)
    for v, t, ax in zip(vacant, TM.flatten(tc)[1],
                        TM.flatten(tm.cache_axes(MAX_LEN))[1]):
        assert torch.equal(v, t.select(ax, 1))
    assert tc["index"].tolist() == (np.asarray(js.pool["cache"]["index"])
                                    + k * act).tolist()


def test_lockstep_decode_is_unchanged_by_a_full_active_mask(models):
    """The scalar-index lockstep path keeps its bits: an all-true mask on
    a lockstep cache gives the same logits and cache as no mask."""
    _, _, tm, tp = models("zamba2-7b", True)
    toks = torch.from_numpy(np.stack([_prompt("x", 5, tm.cfg.vocab),
                                      _prompt("y", 5, tm.cfg.vocab)])).long()
    outs = []
    for active in (None, torch.ones(2, dtype=torch.bool)):
        _, cache = tm.prefill(tp, toks, MAX_LEN)
        logits, cache = tm.decode_step(tp, cache, toks[:, -1:],
                                       active=active)
        outs.append((logits, cache))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(TM.flatten(outs[0][1])[1], TM.flatten(outs[1][1])[1]):
        assert torch.equal(a, b)


# ---- the adapter window -------------------------------------------------------

def _adapter_inputs(quant, b=3, k=4, n=8, d=16, seed=0):
    """Adapter params, a state with a step counter near the int32 wrap in
    slot 0, and hidden states (B, K, D), in both packages."""
    rng = np.random.default_rng(seed)
    cfg_j = j_get_smoke("qwen3-4b").with_(
        d_model=d, dtype="float32", plastic_adapter=True, adapter_neurons=n,
        adapter_impl="xla", adapter_quant=quant)
    cfg_t = get_smoke("qwen3-4b").with_(
        d_model=d, dtype="float32", plastic_adapter=True, adapter_neurons=n,
        adapter_quant=quant)
    params = {"p_in": rng.normal(0, 1.2, (d, n)).astype(np.float32),
              "p_out": rng.normal(0, 0.3, (n, d)).astype(np.float32),
              "theta": rng.normal(0, 0.05, (4, n, n)).astype(np.float32),
              "scale": np.float32(0.5)}
    jstate = jax.tree.map(np.asarray, j_init_from_plan(
        j_plastic.plan_cache(cfg_j, b), jax.random.PRNGKey(0)))
    jstate["t"] = np.array([2 ** 31 - 2, 5, 0], np.int32)[:b]
    h = rng.normal(0, 1.0, (b, k, d)).astype(np.float32)
    return cfg_j, cfg_t, params, jstate, h


def _to_t(tree):
    return {k: convert.tensor(v, "cpu") for k, v in tree.items()}


@pytest.mark.parametrize("quant", (False, True), ids=("f32", "int8"))
def test_plastic_decode_rollout_matches_jax_and_k_steps(quant):
    cfg_j, cfg_t, params, jstate, h = _adapter_inputs(quant)
    active = np.array([True, False, True])
    jh, js = jax.jit(lambda p, s, h, a: j_plastic.decode_rollout(
        p, s, h, cfg_j, active=a))(params, jstate, h, active)
    tp, ts = _to_t(params), _to_t(jstate)
    th, tstate = plastic.decode_rollout(tp, ts, torch.from_numpy(h), cfg_t,
                                        active=torch.from_numpy(active))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    for key, want in js.items():
        got, want = tstate[key].numpy(), np.asarray(want)
        assert got.dtype == want.dtype, key
        if quant and key != "v1":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=key)
        np.testing.assert_array_equal(got[1], jstate[key][1], err_msg=key)
    assert tstate["t"].tolist()[1:] == [5, 4]
    assert np.abs(tstate["w_fast"].numpy()).max() > 0      # the rule ran
    # K port steps on the same hidden states: the same bits
    s = _to_t(jstate)
    outs = []
    for k in range(h.shape[1]):
        o, s = plastic.decode_step(tp, s, torch.from_numpy(h[:, k:k + 1]),
                                   cfg_t, active=torch.from_numpy(active))
        outs.append(o)
    assert torch.equal(torch.cat(outs, 1), th)
    for key in s:
        assert torch.equal(s[key], tstate[key]), key


@pytest.mark.parametrize("quant", (False, True), ids=("f32", "int8"))
def test_adapter_telemetry_and_weight_norm_match_jax(quant):
    cfg_j, cfg_t, params, jstate, h = _adapter_inputs(quant, seed=1)
    qj = j_plastic.QUANT if quant else None
    qt = plastic.QUANT if quant else None
    active = np.array([True, False, True])
    # per step, then per window (the caller divides by K)
    step = jax.jit(lambda p, s, h, a: j_plastic.decode_step(
        p, s, h, cfg_j, active=a))
    _, after = step(params, jstate, h[:, :1], active)
    _, win = jax.jit(lambda p, s, h, a: j_plastic.decode_rollout(
        p, s, h, cfg_j, active=a))(params, jstate, h, active)
    for what, a in (("step", after), ("window", win)):
        jtel = jax.jit(lambda b_, a_, m: JT.adapter_telemetry(
            b_, a_, m, qcfg=qj))(jstate, a, active)
        ttel = adapter_telemetry(_to_t(jstate), _to_t(a),
                                 torch.from_numpy(active), qcfg=qt)
        for f in ("spike_rate", "mean_abs_dw", "sat_frac", "occupancy"):
            np.testing.assert_allclose(getattr(ttel, f).numpy(),
                                       np.asarray(getattr(jtel, f)),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{what} {f}")
        assert float(ttel.spike_rate[1]) == 0.0
        np.testing.assert_allclose(
            adapter_weight_norm(_to_t(a), quant).numpy(),
            np.asarray(jax.jit(lambda a_: JR.adapter_weight_norm(
                a_, quant))(a)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("quant", (False, True), ids=("f32", "int8"))
def test_adapter_flight_recorder_matches_jax(quant, tmp_path):
    cfg_j, cfg_t, params, jstate, h = _adapter_inputs(quant, k=12, seed=2)
    hk = dict(window=5, warmup=2, hysteresis=(2, 1, 3, 2),
              bounds=((0.0, 0.05), (0.0, 1e9), (0.0, 1.0), (0.0, 1e9)))
    jrec = JR.AdapterFlightRecorder(JHealthConfig(**hk), slots=3,
                                    qcfg=j_plastic.QUANT if quant else None)
    trec = AdapterFlightRecorder(HealthConfig(**hk), slots=3,
                                 qcfg=plastic.QUANT if quant else None,
                                 device="cpu")
    step = jax.jit(lambda p, s, h: j_plastic.decode_step(p, s, h, cfg_j))
    js = jstate
    for k in range(h.shape[1]):
        _, js2 = step(params, js, h[:, k:k + 1])
        jrec.observe(js, js2)
        trec.observe(_to_t(jax.tree.map(np.asarray, js)),
                     _to_t(jax.tree.map(np.asarray, js2)))
        js = js2
    np.testing.assert_allclose(trec.rec.ring.numpy(),
                               np.asarray(jrec.rec.ring), rtol=1e-6,
                               atol=1e-7)
    for f in ("flagged", "streaks", "steps"):
        np.testing.assert_array_equal(
            getattr(trec.rec.health, f).numpy(),
            np.asarray(getattr(jrec.rec.health, f)), err_msg=f)
    assert trec.flagged_slots() == jrec.flagged_slots()
    assert trec.flagged_slots(), "the spike-rate corridor flags no slot"
    got = trec.dump(str(tmp_path / "t"), uid_by_slot={0: "u0"})
    want = jrec.dump(str(tmp_path / "j"), uid_by_slot={0: "u0"})
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    tsum = json.loads((tmp_path / "t" / "flight_summary.json").read_text())
    jsum = json.loads((tmp_path / "j" / "flight_summary.json").read_text())
    assert tsum == jsum


def test_flight_summary_written_when_no_slot_is_flagged(tmp_path):
    rec = AdapterFlightRecorder(HealthConfig(), slots=2, device="cpu")
    assert rec.dump(str(tmp_path)) == []
    doc = json.loads((tmp_path / "flight_summary.json").read_text())
    assert doc["steps_recorded"] == 0 and doc["flagged_slots"] == []


# ---- the window kernel's plan at the adapter's width --------------------------

def test_window_plan_at_the_adapter_width():
    """#3 fleet at one 128 -> 128 layer, B = 8 pool slots: float32 does
    not fit the default tile of 8 and takes 3 streams a CTA, one buffer,
    the rule through L2; int8 takes all 8."""
    with pytest.raises(ValueError, match="lower block_b"):
        fused.fleet_plan((128, 128), 8, 8, (True,), quant=False,
                         limit=H100_SMEM)
    p32 = fused.fleet_fit((128, 128), 8, (True,), quant=False,
                          limit=H100_SMEM)
    assert (p32["tile"], p32["warps"], p32["buffers"], p32["theta"],
            p32["smem"]) == (3, 8, "single", "l2", 204304)
    p8 = fused.fleet_fit((128, 128), 8, (True,), quant=True,
                         limit=H100_SMEM, w_bytes=1)
    assert (p8["tile"], p8["warps"], p8["buffers"], p8["theta"],
            p8["smem"]) == (8, 4, "single", "l2", 151696)
    assert fused.fleet_fit((128, 128), 2, (True,), quant=False,
                           limit=H100_SMEM)["tile"] == 2


@pytest.mark.parametrize("n,quant", ((512, False), (512, True),
                                     (256, False)))
def test_window_refuses_an_adapter_whose_stream_exceeds_an_sm(n, quant):
    with pytest.raises(ValueError, match="lower block_b"):
        fused.fleet_plan((n, n), 8, 1, (True,), quant=quant,
                         limit=H100_SMEM, w_bytes=1 if quant else 4)
    with pytest.raises(ValueError, match="exceeds an SM"):
        fused.fleet_fit((n, n), 8, (True,), quant=quant, limit=H100_SMEM,
                        w_bytes=1 if quant else 4)
