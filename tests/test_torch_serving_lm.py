"""The port's LM decode pool (`serving.LMScheduler`, `AdapterPool`, the
serve CLI's sessions, flight recorder and metrics flags) on CPU tensors,
with the scripts of tests/test_serving_lm.py run through JAX's scheduler
and the port's on the same parameters (JAX's, carried over by
`convert.lm_params`), smoke configs in float32 with an 8-neuron adapter:

  * mixed occupancy: a stream's tokens under neighbour churn equal its
    tokens alone and JAX's; its session equals its session alone bit for
    bit, and JAX's (int8 adapter bit for bit, float32 within 1e-5, the
    backbone within 1e-4); a vacant slot's whole row is bit-frozen;
  * `decode_window(K)` equals K `step` calls (tokens, pending token and
    session bit for bit), and resumes bit for bit across a window boundary
    through an evict -> persist -> re-admit into another slot;
  * the MoE layout (deepseek-moe-16b's smoke config): at
    ``capacity_factor = num_experts`` the churn script's tokens equal the
    stream's alone and JAX's; at the default capacity, where a decode
    step's capacity is one row an expert, a vacant slot's pending token
    takes no capacity: the active streams' logits and sessions are bit for
    bit the same whatever it holds;
  * the compile audit: `compiled_programs()` pinned with JAX's keys;
  * the serve loop's `AdapterPool` round trip through a durable store,
    a JAX-persisted LM session restored and continued, and the serve CLI's
    JSON keys against JAX's.
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.launch import serve as j_serve
from repro.models import factory as j_factory
from repro.serving import AdapterPool as JAdapterPool
from repro.serving import LMScheduler as JLMScheduler
from repro.serving import SessionStore as JSessionStore
from repro_torch import convert
from repro_torch.checkpoint import manager as TM
from repro_torch.configs import get_smoke
from repro_torch.launch import serve
from repro_torch.models import factory, plastic
from repro_torch.serving import AdapterPool, LMScheduler, SessionStore

LAYOUT_ARCH = {"dense": "qwen3-4b", "ssm": "mamba2-1.3b",
               "hybrid": "zamba2-7b"}
DATAPATHS = ("float32", "int8")


def _cfgs(arch, datapath, neurons=8):
    over = dict(dtype="float32", plastic_adapter=True,
                adapter_neurons=neurons, adapter_quant=datapath == "int8")
    return (j_get_smoke(arch).with_(adapter_impl="xla", **over),
            get_smoke(arch).with_(**over))


@pytest.fixture(scope="module")
def models():
    """Per (layout, datapath): JAX's model and parameters and the port's,
    made at first use and shared by the tests."""
    made = {}

    def get(layout, datapath):
        if (layout, datapath) not in made:
            jcfg, tcfg = _cfgs(LAYOUT_ARCH[layout], datapath)
            jm = j_factory.build(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            jp["adapter"]["scale"] = jnp.float32(0.5)
            made[layout, datapath] = (jm, jp, factory.build(tcfg),
                                      convert.lm_params(jp, tcfg, "cpu"))
        return made[layout, datapath]
    return get


def _prompt(uid, n, vocab):
    """A deterministic prompt per uid (no string hashing)."""
    rng = np.random.RandomState(sum(map(ord, uid)) * 7 + n)
    return rng.randint(0, vocab, size=n).astype(np.int32)


def _same(a, b):
    for x, y in zip(TM.flatten(a)[1], TM.flatten(b)[1]):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _close_to_jax(got, want, quant):
    """A port session against JAX's: integers bit for bit, the int8
    adapter bit for bit, the float32 adapter within 1e-5, the backbone
    within 1e-4."""
    paths, leaves = TM.flatten(got)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p.replace("/", "") for p in paths] == \
        [jax.tree_util.keystr(p) for p, _ in flat]
    for path, g, (_, w) in zip(paths, leaves, flat):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, path
        if not np.issubdtype(w.dtype, np.floating) or (
                quant and "adapter" in path and "v1" not in path):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            tol = 1e-5 if "adapter" in path else 1e-4
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=path)


# ---- mixed occupancy ------------------------------------------------------------

@pytest.mark.parametrize("datapath", DATAPATHS)
def test_churn_invariance_and_vacant_freeze(datapath, models):
    """tests/test_serving_lm.py::TestMixedOccupancy's script: the stream
    alone, then under a rival admitted and evicted around each of its
    first 5 steps, its slot-1 neighbour row frozen over 3 more."""
    jm, jp, tm, tp = models("dense", datapath)
    vocab, quant = tm.cfg.vocab, datapath == "int8"

    def script(sched, churn):
        sched.admit_prompt("keep", _prompt("keep", 6, vocab))
        toks, frozen = [], None
        for t in range(8):
            if churn and t < 5:
                sched.admit_prompt(f"r{t}", _prompt(f"r{t}", 6, vocab))
            if churn and t == 5:
                frozen = sched._take(sched.pool, 1)
            toks.append(sched.step()["keep"])
            if churn and t < 5:
                sched.evict(f"r{t}")
        return toks, frozen

    ref = LMScheduler(tm, tp, slots=3, max_len=24)
    ref_toks, _ = script(ref, False)
    churn = LMScheduler(tm, tp, slots=3, max_len=24)
    toks, frozen = script(churn, True)
    assert toks == ref_toks
    _same(frozen, churn._take(churn.pool, 1))        # the vacant row
    _same(ref.session_view("keep"), churn.session_view("keep"))
    js = JLMScheduler(jm, jp, slots=3, max_len=24)
    jtoks, _ = script(js, True)
    assert toks == jtoks
    _close_to_jax(churn.session_view("keep"), js.session_view("keep"),
                  quant)


# ---- the MoE layout ----------------------------------------------------------------

def _moe_models(datapath, capacity=None):
    """deepseek-moe-16b's smoke pool model in both packages (JAX's
    parameters carried over), at ``capacity`` (the default if None)."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b", datapath)
    if capacity is not None:
        jcfg, tcfg = (c.with_(moe=dataclasses.replace(
            c.moe, capacity_factor=capacity)) for c in (jcfg, tcfg))
    jm = j_factory.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jp["adapter"]["scale"] = jnp.float32(0.5)
    return jm, jp, factory.build(tcfg), convert.lm_params(jp, tcfg, "cpu")


def test_moe_churn_invariance_matches_jax():
    """The mixed-occupancy script on deepseek-moe-16b's smoke config with
    an int8 adapter and ``capacity_factor = num_experts`` (so that no
    assignment is dropped and a stream's tokens cannot depend on its
    neighbours, as tests/test_serving_lm.py sets it): the stream's tokens
    under churn equal its tokens alone and JAX's, its session equals its
    session alone bit for bit and JAX's (`_close_to_jax`), and the vacant
    row stays frozen."""
    jm, jp, tm, tp = _moe_models("int8", 8.0)
    vocab = tm.cfg.vocab

    def script(sched, churn):
        sched.admit_prompt("keep", _prompt("keep", 6, vocab))
        toks, frozen = [], None
        for t in range(8):
            if churn and t < 5:
                sched.admit_prompt(f"r{t}", _prompt(f"r{t}", 6, vocab))
            if churn and t == 5:
                frozen = sched._take(sched.pool, 1)
            toks.append(sched.step()["keep"])
            if churn and t < 5:
                sched.evict(f"r{t}")
        return toks, frozen

    ref = LMScheduler(tm, tp, slots=3, max_len=24)
    ref_toks, _ = script(ref, False)
    churn = LMScheduler(tm, tp, slots=3, max_len=24)
    toks, frozen = script(churn, True)
    assert toks == ref_toks
    _same(frozen, churn._take(churn.pool, 1))
    _same(ref.session_view("keep"), churn.session_view("keep"))
    js = JLMScheduler(jm, jp, slots=3, max_len=24)
    jtoks, _ = script(js, True)
    assert toks == jtoks
    _close_to_jax(churn.session_view("keep"), js.session_view("keep"), True)
    # the session template (the store's validation) has the view's leaves
    for t, v in zip(TM.flatten(tm.session_template(24))[1],
                    TM.flatten(churn.session_view("keep"))[1]):
        assert (t.shape, t.dtype) == (v.shape, v.dtype)


@pytest.mark.parametrize("datapath", DATAPATHS)
def test_moe_vacant_slot_takes_no_capacity(datapath):
    """At the default capacity (one row an expert at decode), slot 0
    vacant and the streams in slots 1 and 2: whatever token the vacant
    slot holds, the active streams' logits, tokens and sessions are bit
    for bit the same and the vacant row stays frozen.  Without the token
    mask the vacant token, sorting first, does take capacity: some of the
    same tokens then move the active logits."""
    from repro_torch.models import moe as TMoE
    _, _, tm, tp = _moe_models(datapath)
    vocab = tm.cfg.vocab
    assert TMoE.capacity(tm.cfg, 3) == 1

    def run(vacant_tok, masked=True):
        sched = LMScheduler(tm, tp, slots=3, max_len=24)
        for u in ("gone", "a", "b"):
            sched.admit_prompt(u, _prompt(u, 6, vocab))
        sched.evict("gone")
        sched.pool["tok"][0] = vacant_tok
        frozen = sched._take(sched.pool, 0)
        seen, real = [], tm.decode_step

        def decode_step(*a, **kw):
            logits, cache = real(*a, **kw)
            seen.append(logits[1:].clone())
            return logits, cache

        apply = TMoE.apply
        with mock.patch.object(tm, "decode_step", decode_step), \
                mock.patch.object(TMoE, "apply", apply if masked else (
                    lambda *a, token_mask=None, **kw: apply(*a, **kw))):
            toks = [sched.step() for _ in range(3)]
        _same(frozen, sched._take(sched.pool, 0))
        return (seen, toks, sched.session_view("a"),
                sched.session_view("b"))

    base = run(0)
    for tok in (1, 77, 300, 511):
        seen, toks, a, b = run(tok)
        assert toks == base[1]
        assert all(torch.equal(x, y) for x, y in zip(seen, base[0]))
        _same(a, base[2])
        _same(b, base[3])
    unmasked = [run(tok, masked=False)[0] for tok in (0, 1, 77, 300, 511)]
    assert any(not torch.equal(x[0], unmasked[0][0]) for x in unmasked[1:])


# ---- the windowed decode ---------------------------------------------------------

@pytest.mark.parametrize("layout", ("ssm", "hybrid"))
@pytest.mark.parametrize("datapath", DATAPATHS)
def test_window_equals_sequential_steps(datapath, layout, models):
    """decode_window(K) == K step() calls: tokens, pending token and every
    session leaf, the fixed-point round's stream included; the tokens are
    JAX's."""
    jm, jp, tm, tp = models(layout, datapath)
    vocab, k = tm.cfg.vocab, 3
    a = LMScheduler(tm, tp, slots=2, max_len=16)
    a.admit_prompt("u", _prompt("u", 5, vocab))
    first = a.pending("u")
    seq_toks = [a.step()["u"] for _ in range(k)]
    ja = JLMScheduler(jm, jp, slots=2, max_len=16)
    ja.admit_prompt("u", _prompt("u", 5, vocab))
    assert ja.pending("u") == first
    assert [ja.step()["u"] for _ in range(k)] == seq_toks

    b = LMScheduler(tm, tp, slots=2, max_len=16)
    b.admit_prompt("u", _prompt("u", 5, vocab))
    window = np.array([first] + seq_toks[:-1], np.int32)
    logits = b.decode_window({"u": window})["u"]
    assert tuple(logits.shape) == (k, vocab)
    assert logits.argmax(-1).tolist() == seq_toks
    assert b.pending("u") == seq_toks[-1]
    _same(a.session_view("u"), b.session_view("u"))
    _close_to_jax(b.session_view("u"), ja.session_view("u"),
                  datapath == "int8")


@pytest.mark.parametrize("datapath", DATAPATHS)
def test_resume_across_window_boundary(datapath, models):
    """Evict -> persist (the archive, not the warm cache) -> a rival takes
    the slot -> re-admit elsewhere between two windows: the second
    window's logits and the final session equal an uninterrupted run's
    bit for bit, and its greedy tokens JAX's uninterrupted run's."""
    jm, jp, tm, tp = models("dense", datapath)
    vocab, k = tm.cfg.vocab, 3
    prompt = _prompt("u", 5, vocab)
    forced = _prompt("forced", 2 * (k - 1), vocab)

    def uninterrupted(cls, model, params):
        s = cls(model, params, slots=3, max_len=24)
        s.admit_prompt("u", prompt)
        w1 = np.concatenate([[s.pending("u")], forced[:k - 1]])
        s.decode_window({"u": w1})
        w2 = np.concatenate([[s.pending("u")], forced[k - 1:]])
        return s, w1, w2, s.decode_window({"u": w2})["u"]

    ref, w1, w2, ref_logits = uninterrupted(LMScheduler, tm, tp)
    _, jw1, jw2, jlogits = uninterrupted(JLMScheduler, jm, jp)
    assert (w1.tolist(), w2.tolist()) == (jw1.tolist(), jw2.tolist())
    assert ref_logits.argmax(-1).tolist() == \
        np.asarray(jlogits).argmax(-1).tolist()

    s = LMScheduler(tm, tp, slots=3, max_len=24, store=SessionStore())
    s.admit_prompt("u", prompt)
    s.decode_window({"u": w1})
    s.evict("u")
    s.store._warm.pop("u", None)           # force the archive restore
    s.admit_prompt("rival", _prompt("rival", 5, vocab))     # slot 0
    s.step()                               # the pool moves while u waits
    slot = s.admit_prompt("u", prompt)     # restored; the prompt ignored
    assert slot != s.user_slot["rival"] and s.store.restores == 1
    assert s.pending("u") == w2[0]
    out = s.decode_window({
        "u": w2, "rival": np.full((k,), s.pending("rival"), np.int32)})
    assert torch.equal(out["u"], ref_logits)
    _same(ref.session_view("u"), s.session_view("u"))


def test_window_inputs_are_checked(models):
    _, _, tm, tp = models("dense", "int8")
    s = LMScheduler(tm, tp, slots=2, max_len=16)
    s.admit_prompt("a", _prompt("a", 4, tm.cfg.vocab))
    s.admit_prompt("b", _prompt("b", 4, tm.cfg.vocab))
    with pytest.raises(ValueError, match="cover exactly"):
        s.decode_window({"a": np.zeros(2, np.int32)})
    with pytest.raises(ValueError, match="cover exactly"):
        s.decode_window({"a": np.zeros(2), "b": np.zeros(2), "c": [0, 0]})
    with pytest.raises(ValueError, match="one length"):
        s.decode_window({"a": np.zeros(2), "b": np.zeros(3)})
    with pytest.raises(ValueError, match=r"\(S,\)"):
        s.admit_prompt("c", np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="not poolable"):
        LMScheduler(factory.build(tm.cfg.with_(input_mode="embeddings")),
                    tp, slots=2, max_len=16)
    with pytest.raises(ValueError, match="plastic_adapter=False"):
        LMScheduler(factory.build(tm.cfg.with_(plastic_adapter=False)),
                    tp, slots=2, max_len=16).step(telemetry=True)
    with pytest.raises(ValueError, match="not poolable"):
        LMScheduler(factory.build("musicgen-medium", smoke=True), tp,
                    slots=2, max_len=16)


def test_a_stream_at_max_len_is_refused_before_dispatch(models):
    """A step or window that would write K/V rows past max_len raises,
    naming the session, before anything is dispatched: the pool and the
    program counts stay as they were.  A layout without attention has no
    such rows and decodes on past max_len."""
    _, _, tm, tp = models("dense", "float32")
    s = LMScheduler(tm, tp, slots=2, max_len=12)
    s.admit_prompt("a", _prompt("a", 8, tm.cfg.vocab))
    s.admit_prompt("b", _prompt("b", 3, tm.cfg.vocab))
    for _ in range(3):
        s.step()                                   # a at 11, b at 6
    pool = TM.tree_map(torch.clone, s.pool)
    programs = s.compiled_programs()
    with pytest.raises(ValueError, match=r"max_len = 12 .*'a' \(11 tokens"):
        s.decode_window({u: np.full((2,), s.pending(u), np.int32)
                         for u in ("a", "b")})
    _same(s.pool, pool)
    assert s.compiled_programs() == programs
    s.step()                                       # a reaches max_len
    with pytest.raises(ValueError, match=r"'a' \(12 tokens\)"):
        s.step()
    s.evict("a")
    s.step()
    assert int(s.pool["cache"]["index"][s.user_slot["b"]]) == 8
    _, _, sm, sp = models("ssm", "float32")
    s = LMScheduler(sm, sp, slots=2, max_len=6)
    s.admit_prompt("a", _prompt("a", 5, sm.cfg.vocab))
    for _ in range(3):
        s.step()
    assert int(s.pool["cache"]["index"][0]) == 8


def test_fresh_sessions_keep_the_int8_scale(models):
    """A new user's session is slot 0 of the initial pool, not zeros: an
    int8 adapter row keeps its non-zero w_scale (ROADMAP.md Queue 3)."""
    _, _, tm, tp = models("dense", "int8")
    pool = AdapterPool(tm.cfg, slots=2, device="cpu")
    pool.admit("u")
    assert pool.pool["w_scale"].tolist() == [plastic.QUANT.w_scale] * 2
    s = LMScheduler(tm, tp, slots=2, max_len=16)
    fresh = s._session_factory()
    assert float(fresh["cache"]["adapter"]["w_scale"]) == \
        plastic.QUANT.w_scale
    s.admit("v")          # a uid the store does not know: the fresh row
    assert float(s.pool["cache"]["adapter"]["w_scale"][0]) == \
        plastic.QUANT.w_scale


def test_telemetry_and_record_leave_the_decode_unchanged(models):
    from repro_torch.obs import HealthConfig
    _, _, tm, tp = models("hybrid", "int8")
    vocab = tm.cfg.vocab

    def run(**kw):
        s = LMScheduler(tm, tp, slots=3, max_len=24,
                        health=HealthConfig(window=4))
        s.admit_prompt("a", _prompt("a", 5, vocab))
        s.admit_prompt("b", _prompt("b", 3, vocab))
        toks = [s.step(**kw) for _ in range(2)]
        win = s.decode_window({u: np.full((2,), s.pending(u), np.int32)
                               for u in ("a", "b")}, **kw)
        return s, toks, win

    plain, toks, win = run()
    for kw in (dict(telemetry=True), dict(record=True),
               dict(telemetry=True, record=True)):
        s, t2, w2 = run(**kw)
        if kw.get("telemetry"):
            t2 = [t for t, _ in t2]
            w2, tel = w2
            assert tel.occupancy.tolist() == [1.0, 1.0, 0.0]
            assert float(tel.spike_rate[2]) == 0.0
            assert s.metrics.snapshot()["adapter_occupancy"]["value"] == \
                2 / 3
        assert t2 == toks
        for u in win:
            assert torch.equal(w2[u], win[u])
        _same(plain.pool, s.pool)
        if kw.get("record"):
            assert s._rec_pos == 3 and s.last_verdict.shape == (3,)
            assert s._rec.health.steps.tolist() == [3, 3, 0]


# ---- bfloat16 sessions through the store ---------------------------------------

@pytest.mark.parametrize("disk", (False, True), ids=("ram", "disk"))
def test_bf16_lm_session_round_trips_the_store(disk, tmp_path):
    """A bfloat16 LM session (its K/V planes) evicted and restored through
    a RAM or disk `SessionStore` comes back bit for bit.  Both stores
    copied through numpy, which has no bfloat16 (ROADMAP.md Queue 3): the
    archive now copies tensors, a checkpoint stores bfloat16 as its 2-byte
    words under "bfloat16", as the JAX package's files do."""
    model = factory.build("qwen3-4b", smoke=True, plastic_adapter=True,
                          adapter_neurons=8)
    assert model.cfg.dtype == "bfloat16"
    params = model.init(torch.Generator().manual_seed(0))
    store = SessionStore(root=str(tmp_path) if disk else None)
    s = LMScheduler(model, params, slots=2, max_len=16, store=store)
    prompt = _prompt("u", 5, model.cfg.vocab)
    s.admit_prompt("u", prompt)
    s.step()
    before = s.session_view("u")
    assert before["cache"]["segments"][0]["k"].dtype == torch.bfloat16
    s.evict("u")
    store._warm.clear()
    s.admit_prompt("u", prompt)
    assert store.restores == 1
    _same(before, s.session_view("u"))
    s.step()                                     # it decodes on
    if disk:
        step_dir = tmp_path / "u" / "step_000000001"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        dtypes = {e["path"]: e["dtype"] for e in manifest["leaves"]}
        assert dtypes["['cache']/['segments']/[0]/['k']"] == "bfloat16"


def test_bf16_checkpoint_layout_equals_jax(tmp_path):
    """bfloat16 leaves in both packages' checkpoints: JAX's file loads in
    the port and the port's file holds JAX's bytes and manifest dtype."""
    from repro.checkpoint import manager as JM
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    JM.save_checkpoint(str(tmp_path / "j"), 0, {"a": jx})
    TM.save_checkpoint(str(tmp_path / "t"), 0, {"a": tx})
    got, _, _ = TM.load_checkpoint(str(tmp_path / "j"), {"a": tx})
    assert torch.equal(got["a"], tx)
    for d in ("j", "t"):
        m = json.loads((tmp_path / d / "step_000000000" / "manifest.json")
                       .read_text())
        assert m["leaves"][0]["dtype"] == "bfloat16"
    jb = np.load(tmp_path / "j" / "step_000000000" / "leaf_00000.npy")
    tb = np.load(tmp_path / "t" / "step_000000000" / "leaf_00000.npy")
    assert jb.dtype == tb.dtype and jb.tobytes() == tb.tobytes()


# ---- the compile audit --------------------------------------------------------------

def test_pinned_program_counts(models):
    """tests/test_serving_lm.py::TestCompileAudit's sequence through both
    pools.  The port counts static signatures, JAX executables; the one
    count that differs is slot_take before any admission: JAX compiled it
    to gather the fresh-session template, the port copies slot 0 without
    dispatching an entry point."""
    jm, jp, tm, tp = models("dense", "int8")
    vocab = tm.cfg.vocab
    s = LMScheduler(tm, tp, slots=3, max_len=24)
    js = JLMScheduler(jm, jp, slots=3, max_len=24)
    start = dict.fromkeys(js.compiled_programs(), 0)
    assert js.compiled_programs() == dict(start, slot_take=1)
    assert s.compiled_programs() == start

    for sched in (s, js):
        sched.admit_prompt("a", _prompt("a", 6, vocab))
        sched.admit_prompt("b", _prompt("b", 4, vocab))   # 2nd length
        for _ in range(2):
            sched.step()
        sched.step(telemetry=True)
        k2 = {u: np.full((2,), sched.pending(u), np.int32)
              for u in ("a", "b")}
        sched.decode_window(k2)
        sched.decode_window(k2, telemetry=True)
        sched.evict("b")
    expected = {
        "slot_put": 1, "slot_take": 1, "recorder_reset": 0, "prefill": 2,
        "decode_step": 1, "decode_step_telemetry": 1, "decode_window": 1,
        "decode_window_telemetry": 1, "decode_step_record": 0,
        "decode_window_record": 0}
    assert s.compiled_programs() == js.compiled_programs() == expected
    assert s.compile_count() == sum(expected.values())
    for sched in (s, js):
        sched.decode_window({"a": np.full((3,), sched.pending("a"),
                                          np.int32)})
    assert s.compiled_programs() == js.compiled_programs() == \
        dict(expected, decode_window=2)


# ---- the serve loop's sessions --------------------------------------------------------

@pytest.mark.parametrize("datapath", DATAPATHS)
def test_durable_roundtrip_and_resume(datapath, models, tmp_path):
    """tests/test_serving_lm.py::TestServeAdapterPool through the port's
    `generate`: the tokens are JAX's, the learned rows round-trip a
    durable store bit for bit and keep learning after the restore."""
    jm, jp, tm, tp = models("dense", datapath)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 4),
                                            0, tm.cfg.vocab))
    users = ["user0", "user1"]
    store = SessionStore(root=str(tmp_path / "port"), capacity=2)
    pool = AdapterPool(tm.cfg, slots=2, store=store, device="cpu")
    for u in users:
        pool.admit(u)
    toks, _, _, _ = serve.generate(tm.cfg, tp, torch.from_numpy(prompts),
                                   max_len=12, gen=3, adapters=pool)
    jpool = JAdapterPool(jm.cfg, slots=2)
    for u in users:
        jpool.admit(u)
    jtoks, _, _ = j_serve.generate(jm.cfg, jp, jnp.asarray(prompts),
                                   max_len=12, gen=3, adapters=jpool)
    assert toks.tolist() == np.asarray(jtoks).tolist()
    learned = [pool._take(pool.pool, s) for s in (0, 1)]
    for s in (0, 1):
        got = convert.adapter_row(jax.tree.map(
            np.asarray, jpool._take(jpool.pool, jnp.int32(s))), tm.cfg,
            "cpu")
        for k, v in got.items():
            if datapath == "int8" and k != "v1":
                assert torch.equal(learned[s][k], v), k
            else:
                torch.testing.assert_close(learned[s][k], v, rtol=1e-5,
                                           atol=1e-5)
    assert [int(pool._steps[s]) for s in (0, 1)] == [3, 3]
    for u in users:
        pool.evict(u)

    store2 = SessionStore(root=str(tmp_path / "port"), capacity=2)
    pool2 = AdapterPool(tm.cfg, slots=2, store=store2, device="cpu")
    for u in users:
        pool2.admit(u)
    assert store2.restores == 2 and store2.creates == 0
    for s in (0, 1):
        _same(learned[s], pool2._take(pool2.pool, s))
        assert int(pool2._steps[s]) == 3
    serve.generate(tm.cfg, tp, torch.from_numpy(prompts), max_len=12, gen=2,
                   adapters=pool2)
    assert [int(pool2._steps[s]) for s in (0, 1)] == [5, 5]
    assert any(not torch.equal(a, b) for s in (0, 1)
               for a, b in zip(TM.flatten(learned[s])[1],
                               TM.flatten(pool2._take(pool2.pool, s))[1]))


def test_jax_persisted_lm_session_restores_and_continues(models, tmp_path):
    """An int8 LM session persisted by JAX's pool (evict: write-through to
    disk) loads in the port's store bit for bit, converts through
    `convert.lm_session` to the same tensors, and decodes on in a port
    pool with JAX's tokens and state."""
    jm, jp, tm, tp = models("hybrid", "int8")
    root = str(tmp_path / "sessions")
    js = JLMScheduler(jm, jp, slots=2, max_len=20, store=JSessionStore(root))
    js.admit_prompt("u", _prompt("u", 5, tm.cfg.vocab))
    for _ in range(3):
        js.step()
    jsession = jax.tree.map(np.asarray, js.session_view("u"))
    js.evict("u")

    store = SessionStore(root=root)
    ts = LMScheduler(tm, tp, slots=2, max_len=20, store=store)
    state, step = store.checkout("u", ts._session_factory,
                                 template=ts._template, device="cpu")
    assert step == 3 and store.restores == 1
    _same(state, convert.lm_session(jsession, tm.cfg, 20, "cpu"))
    store.checkin("u", state, step)

    js.admit_prompt("u", _prompt("u", 5, tm.cfg.vocab))
    slot = ts.admit_prompt("u", np.zeros(5, np.int32))     # restored
    assert ts.pending("u") == js.pending("u") and int(ts._steps[slot]) == 3
    assert [ts.step()["u"] for _ in range(2)] == \
        [js.step()["u"] for _ in range(2)]
    _close_to_jax(ts.session_view("u"), js.session_view("u"), True)


# The keys of JAX's serve CLI with --session-dir, --flight-dir and
# --metrics-json (src/repro/launch/serve.py, `main`'s ``out``).  Its CLI is
# not run here: it builds a device mesh whose explicit axes this JAX
# version refuses on the CPU (the test_launch.py failures of ROADMAP.md
# Queue 3); its `generate` runs above without the mesh.
JAX_CLI_KEYS = {"arch", "plastic", "batch", "generated", "decode_ms_p50",
                "decode_ms_mean", "tokens_per_s", "recompiles_after_warmup",
                "sessions", "flight", "metrics_json"}
JAX_SESSION_KEYS = {"users", "resumed", "created", "tokens_learned"}
JAX_FLIGHT_KEYS = {"dir", "steps_recorded", "flagged_slots", "incidents"}


def test_serve_cli_flags_and_keys_equal_jax(tmp_path):
    """The serve CLI with sessions, the flight recorder and periodic
    metrics snapshots: JAX's JSON keys, plus the port's own (its kernel
    launches, its prefill and run details and its parameter counts); a
    second run resumes both users from the store."""
    argv = ["--arch", "qwen3-4b", "--smoke", "--batch", "2",
            "--prompt-len", "4", "--gen", "3", "--plastic",
            "--adapter-quant", "--users", "ann,bob", "--device", "cpu",
            "--session-dir", str(tmp_path / "s")]

    def run(extra=()):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert serve.main(argv + list(extra)) == 0
        return json.loads(buf.getvalue())

    port = run(["--flight-dir", str(tmp_path / "f"), "--metrics-json",
                str(tmp_path / "m.json"), "--metrics-interval", "2"])
    assert set(port) - JAX_CLI_KEYS == {"launches", "adapter_quant",
                                        "device", "prompt_len", "prefill_ms",
                                        "n_params", "n_active_params"}
    assert JAX_CLI_KEYS <= set(port)
    assert set(port["sessions"]) == JAX_SESSION_KEYS
    assert set(port["flight"]) == JAX_FLIGHT_KEYS
    assert port["sessions"] == {"users": ["ann", "bob"], "resumed": 0,
                                "created": 2, "tokens_learned": [3, 3]}
    assert port["flight"]["steps_recorded"] == 3
    assert port["recompiles_after_warmup"] == 0
    assert set(port["launches"]) == {"flash_attention", "ssd_scan", "silu",
                                     "fleet_step", "fleet_step_q",
                                     "rollout", "record_step"}
    summary = json.loads((tmp_path / "f" / "flight_summary.json")
                         .read_text())
    assert summary["steps_recorded"] == 3 and summary["slots"] == 2
    snap = json.loads((tmp_path / "m.json").read_text())
    assert snap["serve_decode_seconds"]["count"] == 3
    again = run()["sessions"]
    assert (again["resumed"], again["created"]) == (2, 0)
    assert again["tokens_learned"] == [6, 6]


@pytest.mark.parametrize("argv,msg", (
    (["--session-dir", "x"], "require --plastic"),
    (["--plastic", "--users", "a"], "pass --session-dir"),
    (["--adapter-quant"], "pass --plastic"),
    (["--flight-dir", "x"], "pass --plastic")))
def test_serve_cli_argument_errors(argv, msg, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu"] + argv)
    assert msg in capsys.readouterr().err
