"""The port's LM serving path against the JAX reference, on the smoke
configs of qwen3-4b (the ``dense`` layout), mamba2-1.3b (``ssm``),
zamba2-7b (``hybrid``: a shared attention + MLP block and Mamba2 blocks),
deepseek-moe-16b and grok-1-314b (``moe``: a dense first layer for
deepseek, then attention + routed experts) and the other dense archs:
qwen2-72b and qwen1.5-32b (QKV bias), internlm2-20b, and musicgen-medium
and pixtral-12b, whose prefill takes embeddings (``input_mode =
"embeddings"``, the prompt through the stub frontend `serve.embed_stub`),
with the plastic adapter.

The JAX parameters (``model.init``) are carried into the port by
`convert.lm_params`; the JAX side runs jitted ``make_prefill`` /
``make_decode_step`` (its prefill through each of two attention or SSD
implementations, or pairs of them for the hybrid).  float32: logits within
rtol = atol = 1e-4 and the same greedy tokens at every step.  bfloat16:
both round at the same places (`rms_norm`, `rope`, every product, silu
after each of its ops, the attention output), but sums run in other orders
and attention's scores in another form, so the logits are held within 2e-2
of the largest logit.  The adapter on the same hidden states: the int8
datapath bit for bit, float32 within 1e-5.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.launch.steps import make_prefill as j_make_prefill
from repro.models import factory as j_factory
from repro.models import plastic as j_plastic
from repro.models import transformer as j_transformer
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import steps
from repro_torch.models import factory, plastic, transformer
from repro_torch.models.layers import leaves

ROOT = Path(__file__).resolve().parents[1]
B, S, GEN = 2, 40, 4          # S = 40 is ragged in mamba2's 16-token chunks
MAX_LEN = S + GEN
ARCHS = ("qwen3-4b", "mamba2-1.3b", "zamba2-7b", "deepseek-moe-16b",
         "grok-1-314b", "qwen2-72b", "internlm2-20b", "qwen1.5-32b",
         "musicgen-medium", "pixtral-12b")
MOE_ARCHS = ARCHS[3:5]


def _impl_kw(arch, impl):
    """The JAX prefill's implementation of the arch's sequence mixer; the
    hybrid's names its attention's and its SSD's as "<attn>+<ssd>"."""
    if arch == "zamba2-7b":
        attn, ssd = impl.split("+")
        return dict(attn_impl=attn, ssd_impl=ssd)
    return {"ssd_impl" if arch == "mamba2-1.3b" else "attn_impl": impl}


def _prompts(cfg, toks):
    """Both packages' prompt: the tokens, or for an embeddings arch the
    stub frontend's one-hot embeddings of them (the same values)."""
    if cfg.input_mode != "embeddings":
        return jnp.asarray(toks), torch.from_numpy(toks).long()
    from repro_torch.launch.serve import embed_stub
    t = embed_stub(torch.from_numpy(toks), cfg)
    return (jax.nn.one_hot(jnp.asarray(toks) % cfg.d_model, cfg.d_model,
                           dtype=getattr(jnp, cfg.dtype)), t)


def _cfgs(dtype="float32", quant=False, arch="qwen3-4b", **kw):
    over = dict(dtype=dtype, plastic_adapter=True, adapter_neurons=128,
                adapter_quant=quant, **kw)
    return (j_get_smoke(arch).with_(**over), get_smoke(arch).with_(**over))


@pytest.fixture(scope="module")
def jax_params():
    """JAX parameters per (arch, dtype): one init each, made at first use
    and shared by the tests."""
    made = {}

    def get(arch, dtype):
        if (arch, dtype) not in made:
            made[arch, dtype] = j_factory.build(
                _cfgs(dtype, arch=arch)[0]).init(jax.random.PRNGKey(0))
        return made[arch, dtype]
    return get


def _tokens(vocab=512):
    return np.random.default_rng(0).integers(0, vocab, (B, S)).astype(
        np.int32)


def _run(arch, dtype, quant, impl, params):
    """Prefill + GEN greedy decode steps in both packages; JAX's greedy
    tokens feed both.  Returns per-step (jax logits, port logits) and the
    final adapter states."""
    jcfg, tcfg = _cfgs(dtype, quant, arch)
    tparams = convert.lm_params(params, tcfg, "cpu")
    jin, tin = _prompts(tcfg, _tokens(tcfg.vocab))
    jl, jc = jax.jit(j_make_prefill(jcfg, MAX_LEN, **_impl_kw(arch, impl)))(
        params, jin)
    tl, tc = steps.make_prefill(tcfg, MAX_LEN)(tparams, tin)
    pairs = [(np.asarray(jl, np.float32), tl.float().numpy())]
    jdec = jax.jit(j_make_decode_step(jcfg))
    tdec = steps.make_decode_step(tcfg)
    for _ in range(GEN):
        tok = pairs[-1][0].argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdec(params, jc, jnp.asarray(tok))
        tl, tc = tdec(tparams, tc, torch.from_numpy(tok).long())
        pairs.append((np.asarray(jl, np.float32), tl.float().numpy()))
    assert int(tc["index"]) == int(jc["index"]) == S + GEN
    return pairs, jc["adapter"], tc["adapter"]


@pytest.mark.parametrize("arch,impl", (
    ("qwen3-4b", "xla_flash"), ("qwen3-4b", "xla"),
    ("mamba2-1.3b", "xla"), ("mamba2-1.3b", "scan"),
    ("zamba2-7b", "xla_flash+xla"), ("zamba2-7b", "xla+scan"),
    ("deepseek-moe-16b", "xla_flash"), ("grok-1-314b", "xla"),
    ("qwen2-72b", "xla_flash"), ("internlm2-20b", "xla"),
    ("qwen1.5-32b", "xla_flash"), ("musicgen-medium", "xla"),
    ("pixtral-12b", "xla_flash")))
@pytest.mark.parametrize("quant", (False, True), ids=("f32-adapter",
                                                      "int8-adapter"))
def test_float32_prefill_and_decode_match_jax(quant, arch, impl,
                                              jax_params):
    pairs, jad, tad = _run(arch, "float32", quant, impl,
                           jax_params(arch, "float32"))
    for step, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(b.argmax(-1), a.argmax(-1))
    for k, want in jad.items():
        got, want = tad[k].numpy(), np.asarray(want)
        assert got.dtype == want.dtype, k
        if quant and k != "v1":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    assert np.abs(tad["w_fast"].numpy()).max() > 0      # the rule ran


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_prefill_and_decode_match_jax(arch, jax_params):
    impl = {"mamba2-1.3b": "xla",
            "zamba2-7b": "xla_flash+xla"}.get(arch, "xla_flash")
    pairs, _, _ = _run(arch, "bfloat16", False, impl,
                       jax_params(arch, "bfloat16"))
    for step, (a, b) in enumerate(pairs):
        err = np.abs(a - b).max()
        assert err <= 2e-2 * np.abs(a).max(), (step, err)


def test_hybrid_remainder_prefill_cache_matches_jax():
    """zamba2's SMOKE at n_layers = 7: two super-blocks (the shared block
    and two Mamba2 blocks each) and a one-block ``ssm`` remainder segment.
    The prefill cache, the K/V rows of each super-block and the nested SSD
    states and conv windows included, equals jitted JAX's within 1e-5 of
    each leaf's largest value, and so do the logits of the prefill and of
    GEN decode steps after it."""
    jcfg, tcfg = _cfgs("float32", arch="zamba2-7b", n_layers=7)
    from repro_torch.models.transformer import segments
    assert segments(tcfg) == [("zsuper", 2), ("ssm", 1)]
    params = j_factory.build(jcfg).init(jax.random.PRNGKey(1))
    tparams = convert.lm_params(params, tcfg, "cpu")
    toks = _tokens(tcfg.vocab)
    jl, jc = jax.jit(j_make_prefill(jcfg, MAX_LEN))(params, jnp.asarray(toks))
    tl, tc = steps.make_prefill(tcfg, MAX_LEN)(
        tparams, torch.from_numpy(toks).long())
    jsegs, tsegs = jc["segments"], tc["segments"]
    assert tsegs[0]["ssm"]["ssm"].shape == (2, 2, B, 8, 16, 16)
    assert tsegs[1]["conv"].shape == (1, B, 3, 160)
    jleaves, tleaves = jax.tree.leaves(jsegs), jax.tree.leaves(tsegs)
    assert len(jleaves) == len(tleaves) == 6
    for j, t in zip(jleaves, tleaves):
        j = np.asarray(j)
        assert t.shape == j.shape and t.numpy().dtype == j.dtype
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())
    jdec = jax.jit(j_make_decode_step(jcfg))
    tdec = steps.make_decode_step(tcfg)
    for _ in range(GEN):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdec(params, jc, jnp.asarray(tok))
        tl, tc = tdec(tparams, tc, torch.from_numpy(tok).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
def test_silu_rounds_as_jax_writes_it(dtype):
    """`layers.silu` against jitted ``jax.nn.silu``: bfloat16 bit for bit
    (``F.silu``, which rounds once, differs on about a third of the
    elements), float32 within one rounding of exp."""
    from repro_torch.models.layers import silu
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 4
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jax.jit(jax.nn.silu)(jx), np.float32)
    tx = convert.tensor(np.asarray(jx), "cpu")
    got = silu(tx)
    assert got.dtype == tx.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
        once = torch.nn.functional.silu(tx).float().numpy()
        assert (once != want).mean() > 0.2
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_silu_product_matches_jax():
    """`layers.silu(x, u)`, the SwiGLU gate's product, against jitted
    ``jax.nn.silu(x) * u`` on bfloat16 x and u, bit for bit.  (The Mamba2
    gate's float32 product is held inside a jitted JAX block by
    tests/test_torch_ssd.py: alone, XLA computes that silu in float32.)"""
    from repro_torch.models.layers import silu
    rng = np.random.default_rng(1)
    x, u = (jnp.asarray(rng.standard_normal(4096) * 4, jnp.bfloat16)
            for _ in range(2))
    want = np.asarray(jax.jit(lambda a, b: jax.nn.silu(a) * b)(x, u),
                      np.float32)
    tx, tu = (convert.tensor(np.asarray(t), "cpu") for t in (x, u))
    got = silu(tx, tu)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def _adapter_inputs(n_steps):
    """Hidden states on a 1/8 grid and p_in on a 1/64 grid: every drive is
    an exact float32 sum in any order, so both packages see the same
    spikes; the scale is set so that the drive crosses threshold."""
    rng = np.random.default_rng(5)
    d = 128
    h = rng.integers(-16, 17, (n_steps, B, 1, d)).astype(np.float32) / 8
    p_in = rng.integers(-8, 9, (d, 128)).astype(np.float32) / 64
    return h, p_in


@pytest.mark.parametrize("quant,masked", ((False, False), (True, False),
                                          (True, True)),
                         ids=("float32", "int8", "int8-vacant-slot"))
def test_adapter_decode_step_matches_jax(quant, masked, jax_params):
    """``masked``: slot 1 is vacant and must stay bit-frozen."""
    jcfg, tcfg = _cfgs("float32", quant)
    active = np.array([1, 0], np.int32) if masked else None
    params = dict(jax_params("qwen3-4b", "float32")["adapter"])
    h, p_in = _adapter_inputs(6)
    params["p_in"] = jnp.asarray(p_in)
    params["scale"] = jnp.asarray(0.5, jnp.float32)
    tparams = {k: convert.tensor(np.asarray(v), "cpu")
               for k, v in params.items()}
    jstate = j_factory.build(jcfg).init_cache(B, MAX_LEN)["adapter"]
    tstate = transformer.init_cache(tcfg, B, MAX_LEN, device="cpu")[
        "adapter"]
    start = {k: v.clone() for k, v in tstate.items()}
    jstep = jax.jit(lambda p, s, x, a: j_plastic.decode_step(
        p, s, x, jcfg, active=a))
    spikes = 0
    for t in range(h.shape[0]):
        jh, jstate = jstep(params, jstate, jnp.asarray(h[t]),
                           None if active is None else jnp.asarray(active))
        th, tstate = plastic.decode_step(
            tparams, tstate, torch.from_numpy(h[t]), tcfg,
            active=None if active is None else torch.from_numpy(active))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)
        spikes += int((np.asarray(jstate["tr1"]) != 0).sum())
        for k, want in jstate.items():
            got, want = tstate[k].numpy(), np.asarray(want)
            if quant or k in ("t", "v1", "tr1"):
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=k)
    assert spikes > 0
    assert np.abs(tstate["w_fast"].numpy()).max() > 0
    if masked:
        for k, v in start.items():
            assert torch.equal(tstate[k][1], v[1]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip(arch, jax_params):
    """Every JAX leaf lands at its path in the port's tree with its shape,
    dtype and bits; the port's own plan has the same leaves."""
    jcfg, tcfg = _cfgs("bfloat16", arch=arch)
    params = jax_params(arch, "bfloat16")
    tparams = convert.lm_params(params, tcfg, "cpu")
    jleaves = jax.tree.leaves(params)
    tleaves = leaves(transformer.plan(tcfg))
    assert len(jleaves) == len(tleaves) == len(
        jax.tree.leaves(tparams))
    back = jax.tree.map(lambda t: t.view(torch.int16).numpy()
                        if t.dtype == torch.bfloat16 else t.numpy(),
                        tparams)
    for j, t, d in zip(jleaves, jax.tree.leaves(back), tleaves):
        j = np.asarray(j)
        assert tuple(j.shape) == tuple(d.shape) == t.shape
        if j.dtype.name == "bfloat16":
            j = j.view(np.int16)
        np.testing.assert_array_equal(t, j)
    bad = jax.tree.map(lambda x: x, params)
    bad["final_norm"] = np.zeros((7,), np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        convert.lm_params(bad, tcfg, "cpu")


def _desc_leaves(plan):
    """(shape, dtype, init, scale, fan_in) of every leaf of a parameter or
    cache plan of either package, dict keys sorted."""
    if isinstance(plan, dict):
        return [d for k in sorted(plan) for d in _desc_leaves(plan[k])]
    if isinstance(plan, (list, tuple)):
        return [d for p in plan for d in _desc_leaves(p)]
    return [(tuple(plan.shape), plan.dtype, plan.init, plan.scale,
             plan.fan_in)]


@pytest.mark.parametrize("arch,least", (("qwen3-4b", 4.0e9),
                                        ("mamba2-1.3b", 1.3e9),
                                        ("zamba2-7b", 6.0e9),
                                        ("deepseek-moe-16b", 16.3e9),
                                        ("grok-1-314b", 316e9),
                                        ("qwen2-72b", 72.7e9),
                                        ("internlm2-20b", 19.8e9),
                                        ("qwen1.5-32b", 35.1e9),
                                        ("musicgen-medium", 1.8e9),
                                        ("pixtral-12b", 12.2e9)), ids=ARCHS)
def test_configs_and_plans_match_jax(arch, least):
    """Every field the port keeps equals the JAX config's; the full
    config's parameter count (counted from the plan, nothing allocated)
    equals the JAX package's; and so do the parameter and decode-cache
    plans, leaf for leaf, at full width (the hybrid's nested stacks
    included, and MoE's routed and shared experts)."""
    for jc, tc in ((j_get_config(arch), get_config(arch)),
                   (j_get_smoke(arch), get_smoke(arch))):
        for f in tc.__dataclass_fields__:
            mine, theirs = getattr(tc, f), getattr(jc, f)
            if dataclasses.is_dataclass(mine):        # MoEConfig, SSMConfig
                mine, theirs = (dataclasses.asdict(mine),
                                dataclasses.asdict(theirs))
            assert mine == theirs, f
    for plastic_on in (False, True):
        over = dict(plastic_adapter=plastic_on, adapter_neurons=128)
        assert (factory.build(arch, **over).n_params()
                == j_factory.build(arch, **over).n_params())
        jc, tc = (j_get_config(arch).with_(**over),
                  get_config(arch).with_(**over))
        assert (_desc_leaves(transformer.plan(tc))
                == _desc_leaves(j_transformer.plan(jc)))
        assert (_desc_leaves(transformer.cache_plan(tc, 4, 2080))
                == _desc_leaves(j_transformer.cache_plan(jc, 4, 2080)))
    assert factory.build(arch).n_params() > least


def test_unported_archs_and_layouts_raise():
    """Every arch of the JAX package resolves in the port, at full width
    and smoke scale, and the int8 cache plans for each LM; unknown archs
    and layouts still raise, and so does the SNN controller's arch."""
    from repro.configs import ARCHS as J_ARCHS
    from repro_torch.configs import ARCHS as T_ARCHS
    assert T_ARCHS == J_ARCHS
    for arch in J_ARCHS:
        for get in (get_config, get_smoke):
            cfg = get(arch)
            if arch == "firefly-snn":
                continue
            assert factory.build(cfg).cfg is cfg
            plan = transformer.cache_plan(cfg.with_(kv_quant=True), 1, 8)
            for seg in plan["segments"]:
                if "k" in seg:
                    assert seg["k"].dtype == "int8"
                    assert seg["k_scale"].dtype == "float32"
    with pytest.raises(ValueError, match="layout"):
        factory.build(get_smoke("qwen3-4b").with_(layout="no-such-layout"))
    with pytest.raises(KeyError):
        factory.build("no-such-arch")
    with pytest.raises(KeyError):
        get_smoke("qwen2-7b")
    with pytest.raises(TypeError, match="firefly-snn"):
        factory.build("firefly-snn")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_serve_cli_runs_on_cpu(quant, arch):
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
            "--arch", arch, "--device", "cpu", "--plastic", "--batch", "2",
            "--prompt-len", "12", "--gen", "3"]
    if quant:
        args.append("--adapter-quant")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(args, capture_output=True, text=True, env=env,
                       timeout=240, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout)
    assert out["arch"] == f"{arch}-smoke" and out["plastic"]
    assert out["adapter_quant"] == quant and out["generated"] == 3
    assert out["decode_ms_p50"] > 0 and out["tokens_per_s"] > 0
    # the CPU runs the plain versions: no kernel was launched
    assert set(out["launches"].values()) == {0}


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_and_sampled(arch):
    """`serve.generate` returns (B, gen) tokens with one latency per step;
    greedy decoding follows the argmax of the logits, and sampling at a
    temperature is reproducible from the generator's seed."""
    from repro_torch.launch import serve
    _, tcfg = _cfgs("float32", arch=arch)
    params = factory.build(tcfg).init(torch.Generator().manual_seed(0))
    prompts = _prompts(tcfg, _tokens(tcfg.vocab))[1]
    toks, lats, cache, prefill_s = serve.generate(tcfg, params, prompts,
                                                  MAX_LEN, GEN)
    assert toks.shape == (B, GEN) and len(lats) == GEN and prefill_s > 0
    assert int(cache["index"]) == S + GEN
    logits, _ = steps.make_prefill(tcfg, MAX_LEN)(params, prompts)
    assert torch.equal(toks[:, 0], logits.argmax(-1).to(torch.int32))
    runs = [serve.generate(tcfg, params, prompts, MAX_LEN, GEN,
                           temperature=0.8,
                           generator=torch.Generator().manual_seed(3))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < tcfg.vocab


# ---- the MoE layout ------------------------------------------------------------


def _moe_cfgs(arch, dtype, capacity=None):
    jcfg, tcfg = (get(arch).with_(dtype=dtype)
                  for get in (j_get_smoke, get_smoke))
    if capacity is not None:
        jcfg, tcfg = (c.with_(moe=dataclasses.replace(
            c.moe, capacity_factor=capacity)) for c in (jcfg, tcfg))
    return jcfg, tcfg


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch, dtype):
    """Full-sequence logits of the MoE smoke LMs against jitted JAX
    ``transformer.forward`` at the default capacity (assignments dropped):
    float32 within 1e-4 of the largest logit with the same argmax at
    every position, bfloat16 within 2e-2 of it."""
    jcfg, tcfg = _moe_cfgs(arch, dtype)
    params = j_factory.build(jcfg).init(jax.random.PRNGKey(2))
    tparams = convert.lm_params(params, tcfg, "cpu")
    toks = _tokens(tcfg.vocab)
    want, _ = jax.jit(lambda p, t: j_transformer.forward(
        p, t, jcfg, attn_impl="xla_flash"))(params, jnp.asarray(toks))
    want = np.asarray(want, np.float32)
    got = transformer.forward(tparams, torch.from_numpy(toks).long(),
                              tcfg).float().numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    if dtype == "float32":
        assert err <= 1e-4 * scale, err
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        assert err <= 2e-2 * scale, err


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_forward(arch):
    """Teacher-forced decode reproduces the full-sequence logits in
    float32 (within 1e-4 of the largest) once ``capacity_factor = 64``
    leaves every assignment its row: a decode step routes B tokens where
    the forward routes B * S, so at the default capacity the two drop
    different assignments (tests/test_models.py does the same)."""
    _, tcfg = _moe_cfgs(arch, "float32", 64.0)
    model = factory.build(tcfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_tokens(tcfg.vocab)[:, :12]).long()
    full = model.forward(params, toks)
    prefix = 4
    logits, cache = model.prefill(params, toks[:, :prefix], 12)
    outs = [logits]
    for t in range(prefix, 12):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1])
        outs.append(logits)
    scale = float(full.abs().max())
    for i, lg in enumerate(outs):
        err = float((lg - full[:, prefix - 1 + i]).abs().max())
        assert err <= 1e-4 * scale, (i, err)


def test_n_active_params_equal_jax():
    """`steps.n_active_params` of every ported LM arch, full width, with
    and without the adapter, equals the JAX package's; deepseek-moe-16b
    touches 2.62 B of its 16.38 B parameters a token."""
    from repro.launch.steps import n_active_params as j_n_active
    for arch in ARCHS:
        for over in ({}, dict(plastic_adapter=True, adapter_neurons=128)):
            assert (steps.n_active_params(get_config(arch).with_(**over))
                    == j_n_active(j_get_config(arch).with_(**over))), arch
    cfg = get_config("deepseek-moe-16b")
    assert (factory.build(cfg).n_params(), steps.n_active_params(cfg)) == \
        (16_375_728_128, 2_618_935_296)
