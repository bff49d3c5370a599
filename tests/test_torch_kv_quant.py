"""The port's int8 KV cache (``cfg.kv_quant``) against the JAX package
under `jax.jit`, on the same numpy-made inputs and JAX's parameters
(carried into the port by `convert.lm_params`), at the smoke configs of
qwen3-4b (``dense``), deepseek-moe-16b (``dense_ff`` + ``moe``) and
zamba2-7b (``zsuper`` + ``ssm``):

  * `quantize_kv` / `dequantize_kv` bit for bit on the same inputs, in
    float32 and bfloat16 (XLA turns ``amax / 127`` into a product with
    float32 1/127; the port computes that product);
  * prefill's codes and scales: bit for bit JAX's `quantize_kv` of the
    port's own float cache, and against JAX's int8 prefill the scales
    within 1e-5 and every code the same but where JAX's unrounded code
    lies within 1e-3 of a rounding tie (the two float caches differ in
    their last bits, as the port's float32 LM tests hold them to 1e-5);
  * lockstep decode from JAX's prefill cache and per-slot decode (a step
    and a window with a vacant slot) on a pool JAX's `LMScheduler` built:
    logits within the port's float32 LM tolerance (rtol = atol = 1e-4),
    the same greedy tokens, the codes of every new row as above, a
    vacant slot's codes and scales bit for bit frozen;
  * JAX's own criterion (tests/test_models.py): the int8 cache's decode
    within 0.05 of the largest logit of the float cache's forward;
  * bfloat16, where the share of codes that differ from JAX's is
    reported and held below 5%;
  * an int8-cache LM session through a RAM and a disk `SessionStore` bit
    for bit, a JAX-persisted one restored through `convert.lm_session`,
    and the serve CLI's ``--kv-quant``.
"""
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

from repro.configs import get_smoke as j_get_smoke
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.launch.steps import make_prefill as j_make_prefill
from repro.models import attention as j_attention
from repro.models import factory as j_factory
from repro.serving import LMScheduler as JLMScheduler
from repro.serving import SessionStore as JSessionStore
from repro_torch import convert
from repro_torch.checkpoint import manager as TM
from repro_torch.configs import get_smoke
from repro_torch.models import attention, factory, transformer
from repro_torch.serving import LMScheduler, SessionStore

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-4b", "deepseek-moe-16b", "zamba2-7b")
B, S, GEN = 2, 40, 5
MAX_LEN = S + GEN
TIE = 1e-3           # distance from a rounding tie within which ulps decide


def _cfgs(arch, dtype="float32", kv_quant=True, **kw):
    over = dict(dtype=dtype, kv_quant=kv_quant, plastic_adapter=True,
                adapter_neurons=8, **kw)
    jcfg, tcfg = (get(arch).with_(**over) for get in (j_get_smoke,
                                                       get_smoke))
    if jcfg.moe is not None:
        # every routed assignment keeps its row, so that a decode step's
        # routing does not depend on which neighbours share its experts
        cap = float(jcfg.moe.num_experts)
        jcfg, tcfg = (c.with_(moe=c.moe.__class__(
            **dict(c.moe.__dict__, capacity_factor=cap)))
            for c in (jcfg, tcfg))
    return jcfg.with_(adapter_impl="xla"), tcfg


@pytest.fixture(scope="module")
def models():
    """Per (arch, dtype): JAX's int8-cache model and parameters and the
    port's, made at first use and shared by the tests."""
    made = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in made:
            jcfg, tcfg = _cfgs(arch, dtype)
            jm = j_factory.build(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            jp["adapter"]["scale"] = jnp.float32(0.5)
            made[arch, dtype] = (jm, jp, factory.build(tcfg),
                                 convert.lm_params(jp, tcfg, "cpu"))
        return made[arch, dtype]
    return get


def _tokens(vocab, n=S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(
        np.int32)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _port_tree(like, jtree):
    """JAX's tree as tensors in the structure of the port's ``like``."""
    leaves = jax.tree.leaves(jtree)
    assert len(leaves) == len(TM.flatten(like)[1])
    return TM.unflatten(like, [convert.tensor(x, "cpu") for x in leaves])


def _attn_segments(cache):
    """(segment index, its cache dict) of every attention segment."""
    return [(i, c) for i, c in enumerate(cache["segments"]) if "k" in c]


def _assert_codes_match_at_ties(got, want, unrounded, what):
    """Codes equal JAX's except where JAX's unrounded code lies within
    TIE of a rounding tie, and there they differ by one."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = got != want
    if diff.any():
        u = np.abs(np.asarray(unrounded, np.float64)[diff])
        assert (np.abs(u - np.floor(u) - 0.5) < TIE).all(), what
        assert (np.abs(got - want)[diff] == 1).all(), what
    return int(diff.sum())


# ---- the quantizer -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_quantize_and_dequantize_match_jax(dtype):
    """Bit for bit on the same inputs: random rows at several scales, a
    row of zeros (the 1e-6 floor), rows of exact half-steps (round half
    to even) and a row far above the others."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 50, 4, 64)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-3, 3, (3, 50, 4, 1))
    x[0, 0] = 0.0
    x[0, 1, :, :] = (np.arange(64) - 31.5).astype(np.float32)
    x[0, 2, 0, 0] = 1e4
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = convert.tensor(np.asarray(jx), "cpu")
    jq, js = jax.jit(j_attention.quantize_kv)(jx)
    tq, ts = attention.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.asarray(jq).min() >= -127 and np.asarray(jq).max() == 127
    for out in ("float32", "bfloat16"):
        want = jax.jit(lambda q, s: j_attention.dequantize_kv(
            q, s, getattr(jnp, out)))(jq, js)
        got = attention.dequantize_kv(tq, ts, getattr(torch, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


# ---- prefill ------------------------------------------------------------------------

def _prefill_both(models, arch, dtype="float32"):
    jm, jp, tm, tp = models(arch, dtype)
    toks = _tokens(tm.cfg.vocab)
    jl, jc = jax.jit(j_make_prefill(jm.cfg, MAX_LEN))(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks).long(), MAX_LEN)
    return toks, (jl, jc), (tl, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_codes_and_scales_match_jax(arch, models):
    jm, jp, tm, tp = models(arch)
    toks, (jl, jc), (tl, tc) = _prefill_both(models, arch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    # the float caches of both packages, on the same parameters
    fcfg = tm.cfg.with_(kv_quant=False)
    _, tfc = transformer.prefill(tp, torch.from_numpy(toks).long(), fcfg,
                                 MAX_LEN)
    _, jfc = jax.jit(j_make_prefill(jm.cfg.with_(kv_quant=False),
                                    MAX_LEN))(jp, jnp.asarray(toks))
    jquant = jax.jit(j_attention.quantize_kv)
    flips = 0
    for i, c in _attn_segments(tc):
        assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == \
            torch.float32
        assert c["k_scale"].shape == c["k"].shape[:-1]
        for name in ("k", "v"):
            # JAX's quantizer over the port's own float cache: bit for bit
            q, s = jquant(jnp.asarray(
                tfc["segments"][i][name][:, :, :S].numpy()))
            np.testing.assert_array_equal(c[name][:, :, :S].numpy(),
                                          np.asarray(q))
            np.testing.assert_array_equal(
                c[f"{name}_scale"][:, :, :S].numpy(), np.asarray(s))
            # JAX's int8 prefill: JAX's quantizer over JAX's float cache
            jf = np.asarray(jfc["segments"][i][name])
            jq = np.asarray(jc["segments"][i][name])
            js = np.asarray(jc["segments"][i][f"{name}_scale"])
            np.testing.assert_array_equal(jq, np.asarray(jquant(jf)[0]))
            np.testing.assert_allclose(c[f"{name}_scale"].numpy(), js,
                                       rtol=1e-5, atol=0)
            # rows past the prompt hold zeros in both
            assert not c[name][:, :, S:].any()
            assert not c[f"{name}_scale"][:, :, S:].any()
            unrounded = (jf[:, :, :S].astype(np.float64)
                         / np.maximum(js[:, :, :S, :, None], 1e-30))
            flips += _assert_codes_match_at_ties(
                c[name].numpy()[:, :, :S], jq[:, :, :S], unrounded,
                f"seg {i} {name}")
    n = sum(c[x].numel() for _, c in _attn_segments(tc) for x in "kv")
    assert flips <= 1e-3 * n, flips


# ---- decode -------------------------------------------------------------------------

class _TieResolver:
    """Wraps the port's `quantize_kv` during a decode: each call's codes
    are held against JAX's codes of the same new row (``expect``, in the
    decode's order: token, segment, layer, then K before V), on the rows
    a mask marks.  A code may differ only where the port's unrounded code
    lies within TIE of a rounding tie, and by one; there it takes JAX's
    code, so that both packages go on from the same cache and the logits
    can be held to the float32 tolerance.  ``resolved`` counts them."""

    def __init__(self):
        self._inner = attention.quantize_kv
        self._want = iter(())
        self.resolved = self.checked = 0

    def expect(self, rows):
        self._want = iter(rows)

    def __call__(self, x):
        q, s = self._inner(x)
        want, mask = next(self._want)
        m = torch.from_numpy(np.asarray(mask, bool)).reshape(
            (-1,) + (1,) * (q.ndim - 1)).expand_as(q)
        unrounded = x.double() / s.double()[..., None]
        want = torch.from_numpy(np.asarray(want)).reshape(q.shape)
        self.resolved += _assert_codes_match_at_ties(
            q[m].numpy(), want[m].numpy(), unrounded[m].numpy(),
            "a new row's codes")
        self.checked += int(m.sum())
        return torch.where(m, want, q), s


def _rows_at(jc, pos, mask):
    """JAX's new-row codes at the positions ``pos (B,)`` in decode order
    (segments, layers, K then V), each with the row mask."""
    idx = np.arange(len(pos))
    out = []
    for i, c in _attn_segments(jc):
        for layer in range(c["k"].shape[0]):
            for name in ("k", "v"):
                out.append((np.asarray(c[name])[layer, idx, pos][:, None],
                            mask))
    return out


def _assert_caches_match(tc, jc, what):
    """Every attention segment's codes bit for bit, its scales within
    1e-5 (the float rows they come from agree to the last bits)."""
    for i, c in _attn_segments(tc):
        jseg = jc["segments"][i]
        for name in ("k", "v"):
            np.testing.assert_array_equal(c[name].numpy(),
                                          np.asarray(jseg[name]),
                                          err_msg=f"{what} seg {i} {name}")
            np.testing.assert_allclose(
                c[f"{name}_scale"].numpy(),
                np.asarray(jseg[f"{name}_scale"]), rtol=1e-5, atol=0,
                err_msg=f"{what} seg {i} {name}_scale")


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_decode_matches_jax(arch, models, monkeypatch):
    """From JAX's int8 prefill cache (carried bit for bit), GEN decode
    steps on JAX's greedy tokens in both packages: logits within 1e-4,
    the same argmax, each new row's codes JAX's but at ties, the caches'
    codes bit for bit after them and their scales within 1e-5."""
    jm, jp, tm, tp = models(arch)
    toks = _tokens(tm.cfg.vocab)
    jl, jc = jax.jit(j_make_prefill(jm.cfg, MAX_LEN))(jp, jnp.asarray(toks))
    tc = _port_tree(transformer.init_cache(tm.cfg, B, MAX_LEN, "cpu"), jc)
    ties = _TieResolver()
    monkeypatch.setattr(attention, "quantize_kv", ties)
    jdec = jax.jit(j_make_decode_step(jm.cfg))
    for step in range(GEN):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, jnp.asarray(tok))
        ties.expect(_rows_at(jc, np.full(B, S + step), np.ones(B, bool)))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))
        _assert_caches_match(tc, jc, f"step {step}")
    assert int(tc["index"]) == S + GEN
    assert ties.checked > 0 and ties.resolved <= 1e-3 * ties.checked


def _jax_pool(jm, jp):
    """A 3-slot JAX pool: streams of 6 and 4 tokens in slots 0 and 2, slot
    1 vacant (admitted, stepped, evicted)."""
    s = JLMScheduler(jm, jp, slots=3, max_len=24)
    vocab = jm.cfg.vocab
    for uid, n in (("a", 6), ("b", 3), ("c", 4)):
        s.admit_prompt(uid, np.random.RandomState(n).randint(
            0, vocab, size=n).astype(np.int32))
    s.step()
    s.evict("b")
    return s


@pytest.mark.parametrize("arch", ARCHS)
def test_per_slot_decode_and_window_match_jax(arch, models, monkeypatch):
    """On a pool JAX's `LMScheduler` built (slot 1 vacant), 4 pool steps
    and a 3-token window in both packages: the active rows' logits within
    1e-4 with JAX's argmax, each new row's codes JAX's but at ties, the
    caches as JAX's after each call, and the vacant slot's codes, scales
    and index bit for bit as they were."""
    jm, jp, tm, tp = models(arch)
    js = _jax_pool(jm, jp)
    jcache, jtok = js.pool["cache"], np.asarray(js.pool["tok"])
    active_j = js._active_mask()
    act = np.array(active_j)
    active = torch.from_numpy(act)
    assert act.tolist() == [True, False, True]
    tc = _port_tree(tm.pool_cache(3, 24, "cpu"), jcache)
    vacant = [t.select(ax, 1).clone() for t, ax in zip(
        TM.flatten(tc["segments"])[1],
        TM.flatten(tm.cache_axes(24)["segments"])[1])]
    ties = _TieResolver()
    monkeypatch.setattr(attention, "quantize_kv", ties)
    jstep = jax.jit(jm.decode_step)
    for step in range(4):
        pos = np.asarray(jcache["index"])
        jl, jcache = jstep(jp, jcache, jnp.asarray(jtok)[:, None],
                           active=active_j)
        ties.expect(_rows_at(jcache, pos, act))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(jtok).long()[:, None],
                                active=active)
        np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")
        _assert_caches_match(tc, jcache, f"step {step}")
        jtok = np.asarray(jl).argmax(-1).astype(np.int32)
        assert (tl.numpy()[act].argmax(-1) == jtok[act]).all()
    window = np.stack([jtok, (jtok + 1) % tm.cfg.vocab,
                       (jtok + 2) % tm.cfg.vocab], axis=1)
    pos = np.asarray(jcache["index"])
    jl, jcache = jax.jit(jm.decode_rollout)(jp, jcache, jnp.asarray(window),
                                            active=active_j)
    ties.expect([r for k in range(3)
                 for r in _rows_at(jcache, pos + k * act, act)])
    tl, tc = tm.decode_rollout(tp, tc, torch.from_numpy(window).long(),
                               active=active)
    np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                               rtol=1e-4, atol=1e-4)
    _assert_caches_match(tc, jcache, "window")
    assert tc["index"].tolist() == np.asarray(jcache["index"]).tolist()
    for before, (t, ax) in zip(vacant, zip(
            TM.flatten(tc["segments"])[1],
            TM.flatten(tm.cache_axes(24)["segments"])[1])):
        assert torch.equal(t.select(ax, 1), before)
    assert ties.checked > 0 and ties.resolved <= 1e-3 * ties.checked


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_tracks_the_float_forward(arch):
    """tests/test_models.py's criterion in the port: prefill 4 tokens
    into an int8 cache, then teacher-forced decode; every step's logits
    within 0.05 of the largest logit of the float forward at its
    position."""
    _, tcfg = _cfgs(arch, kv_quant=False)
    model = factory.build(tcfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_tokens(tcfg.vocab, 8, seed=2)[:1]).long()
    full = model.forward(params, toks)
    qcfg = tcfg.with_(kv_quant=True)
    _, cache = transformer.prefill(params, toks[:, :4], qcfg, 8)
    assert cache["segments"][0]["k"].dtype == torch.int8
    for t in range(4, 8):
        lg, cache = transformer.decode_step(params, cache, toks[:, t:t + 1],
                                            qcfg)
        ref = full[0, t]
        rel = float((lg[0] - ref).abs().max() / ref.abs().max())
        assert rel < 0.05, (t, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_codes_and_logits_match_jax(arch, models):
    """bfloat16: the float caches of both packages differ by a bf16 step
    here and there (attention's sums run in other orders, and the
    differences grow with depth), so a share of the codes differs: it is
    printed and held below 5% (truncating instead of rounding would move
    about half of them); the prefill and GEN decode steps' logits within
    2e-2 of the largest, as the bf16 LM tests hold them."""
    jm, jp, tm, tp = models(arch, "bfloat16")
    toks, (jl, jc), (tl, tc) = _prefill_both(models, arch, "bfloat16")
    jdec = jax.jit(j_make_decode_step(jm.cfg))
    pairs = [(np.asarray(jl, np.float32), _np(tl))]
    for _ in range(GEN):
        tok = pairs[-1][0].argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long())
        pairs.append((np.asarray(jl, np.float32), _np(tl)))
    for step, (a, b) in enumerate(pairs):
        assert np.abs(a - b).max() <= 2e-2 * np.abs(a).max(), step
    differ = total = worst = 0
    for i, c in _attn_segments(tc):
        for name in ("k", "v"):
            got, want = c[name].numpy(), np.asarray(jc["segments"][i][name])
            differ += int((got != want).sum())
            total += got[:, :, :S + GEN].size
            worst = max(worst, int(np.abs(got.astype(np.int32) - want).max()))
    share = differ / total
    print(f"{arch} bf16: {differ} of {total} int8 codes differ from "
          f"JAX's ({share:.3%}), by at most {worst}")
    assert share < 0.05, share


# ---- sessions and the CLI ----------------------------------------------------------

@pytest.mark.parametrize("disk", (False, True), ids=("ram", "disk"))
def test_int8_cache_session_round_trips_the_store(disk, models, tmp_path):
    """An int8-cache LM session (codes and scale planes) evicted and
    restored through a RAM or disk `SessionStore` comes back bit for bit
    and decodes on; on disk its manifest names JAX's leaf paths and
    dtypes."""
    _, _, tm, tp = models("zamba2-7b")
    store = SessionStore(root=str(tmp_path) if disk else None)
    s = LMScheduler(tm, tp, slots=2, max_len=16, store=store)
    prompt = np.arange(5, dtype=np.int32)
    s.admit_prompt("u", prompt)
    s.admit_prompt("w", prompt[::-1].copy())
    s.step()
    before = s.session_view("u")
    seg = before["cache"]["segments"][0]
    assert seg["k"].dtype == torch.int8 and seg["k_scale"].dtype ==         torch.float32
    s.evict("u")
    store._warm.clear()
    s.admit_prompt("u", prompt)
    assert store.restores == 1
    for x, y in zip(TM.flatten(before)[1], TM.flatten(s.session_view("u"))[1]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    s.step()
    if disk:
        manifest = json.loads((tmp_path / "u" / "step_000000001" /
                               "manifest.json").read_text())
        dtypes = {e["path"]: e["dtype"] for e in manifest["leaves"]}
        assert dtypes["['cache']/['segments']/[0]/['k']"] == "int8"
        assert dtypes["['cache']/['segments']/[0]/['k_scale']"] == "float32"


def test_jax_persisted_int8_cache_session_restores(models, tmp_path):
    """An int8-cache session persisted by JAX's pool loads in the port's
    store bit for bit, equals `convert.lm_session` of JAX's session, and
    decodes on with JAX's tokens."""
    jm, jp, tm, tp = models("qwen3-4b")
    root = str(tmp_path / "sessions")
    js = JLMScheduler(jm, jp, slots=2, max_len=20, store=JSessionStore(root))
    prompt = np.arange(3, 9, dtype=np.int32)
    js.admit_prompt("u", prompt)
    for _ in range(3):
        js.step()
    jsession = jax.tree.map(np.asarray, js.session_view("u"))
    js.evict("u")
    store = SessionStore(root=root)
    ts = LMScheduler(tm, tp, slots=2, max_len=20, store=store)
    state, step = store.checkout("u", ts._session_factory,
                                 template=ts._template, device="cpu")
    assert step == 3
    want = convert.lm_session(jsession, tm.cfg, 20, "cpu")
    assert want["cache"]["segments"][0]["k"].dtype == torch.int8
    for x, y in zip(TM.flatten(state)[1], TM.flatten(want)[1]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    store.checkin("u", state, step)
    js.admit_prompt("u", prompt)
    ts.admit_prompt("u", np.zeros(6, np.int32))          # restored
    assert ts.pending("u") == js.pending("u")
    assert [ts.step()["u"] for _ in range(2)] == \
        [js.step()["u"] for _ in range(2)]


def test_int8_cache_pool_refuses_a_write_past_max_len(models):
    """The pool's host-side length check holds for the int8 cache: a step
    that would write a code row past ``max_len`` raises, naming the
    session, and leaves the pool as it was."""
    _, _, tm, tp = models("qwen3-4b")
    s = LMScheduler(tm, tp, slots=2, max_len=10)
    s.admit_prompt("a", np.arange(8, dtype=np.int32))
    s.admit_prompt("b", np.arange(3, dtype=np.int32))
    s.step()
    s.step()                                       # a at 10 tokens
    pool = TM.tree_map(torch.clone, s.pool)
    with pytest.raises(ValueError, match=r"max_len = 10 .*'a' \(10 tokens"):
        s.step()
    for x, y in zip(TM.flatten(pool)[1], TM.flatten(s.pool)[1]):
        assert torch.equal(x, y)


def test_admission_frees_its_prefill_cache_without_the_collector(models):
    """A pool admission's B = 1 prefill cache is freed when the admission
    returns, not at the next garbage collection: `checkpoint.manager`'s
    tree rebuild leaves no reference cycle holding the leaves."""
    import gc
    import weakref
    _, _, tm, tp = models("qwen3-4b")
    s = LMScheduler(tm, tp, slots=2, max_len=16)
    made, real = [], tm.prefill

    def prefill(*a, **kw):
        logits, cache = real(*a, **kw)
        made.extend(weakref.ref(t) for t in TM.flatten(cache)[1])
        return logits, cache

    gc.collect()
    gc.disable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tm, "prefill", prefill)
            s.admit_prompt("a", np.arange(5, dtype=np.int32))
        assert made and all(w() is None for w in made)
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        tree = TM.tree_map(lambda t: t, {"x": [leaf]})
        del tree, leaf
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("arch", ("qwen1.5-32b", "pixtral-12b"))
def test_serve_cli_kv_quant_runs_on_cpu(arch):
    """``--kv-quant`` through the serve CLI, on a QKV-bias arch and on an
    embeddings arch (its prompt through the stub frontend)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--arch", arch, "--device", "cpu", "--kv-quant", "--plastic",
         "--batch", "2", "--prompt-len", "12", "--gen", "3"],
        capture_output=True, text=True, env=env, timeout=240, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout)
    assert out["arch"] == f"{arch}-smoke" and out["generated"] == 3
    assert set(out["launches"].values()) == {0}


def test_serve_generate_keeps_an_int8_cache():
    """`serve.generate` under ``kv_quant``: an int8 cache with its scale
    planes, and the tokens of the float cache on most steps."""
    from repro_torch.launch import serve
    cfg = get_smoke("musicgen-medium").with_(dtype="float32")
    params = factory.build(cfg).init(torch.Generator().manual_seed(0))
    prompts = serve.embed_stub(torch.from_numpy(_tokens(cfg.vocab, 12)), cfg)
    assert prompts.shape == (B, 12, cfg.d_model)
    assert prompts.dtype == torch.float32
    qcfg = cfg.with_(kv_quant=True)
    toks, lats, cache, _ = serve.generate(qcfg, params, prompts, 16, 4)
    seg = cache["segments"][0]
    assert seg["k"].dtype == torch.int8 and seg["v_scale"].shape == (
        cfg.n_layers, B, 16, cfg.n_kv_heads)
    assert toks.shape == (B, 4) and len(lats) == 4
    ftoks = serve.generate(cfg, params, prompts, 16, 4)[0]
    assert (toks == ftoks).float().mean() >= 0.5
