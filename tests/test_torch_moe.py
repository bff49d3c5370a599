"""The port's MoE FFN (`repro_torch.models.moe`) against jitted JAX
(`repro.models.moe.apply`), on the MoE layers of deepseek-moe-16b's and
grok-1-314b's smoke configs, inputs made by numpy from a seed.

JAX's dispatch and combine run inside ``jax.vmap`` and return nothing but
the FFN's output, so the tests read them out of the jitted program: the
module's ``jax`` is replaced, for the test only, by a view of ``jax`` whose
``vmap`` passes the per-group dispatch's and combine's operands and results
to ``jax.debug.callback``.

Held: the discrete routing (each token's experts, which assignments are
kept, their buffer rows and tokens) exactly; the gates within 1e-6 (both
packages compute the router product and exp in float32 with other
summation orders and other exp approximations, so a gate may differ in its
last bits); the output within 1e-5 of the largest in float32, and in
bfloat16 bit for bit but for at most 0.1% of the elements, each within one
bf16 step of the largest (`_assert_bf16`); the combine bit for bit in
float32 on JAX's own expert outputs.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import moe as j_moe
from repro.models import transformer as j_transformer
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.models import moe, transformer
from repro_torch.models.layers import rms_norm

ARCHS = ("deepseek-moe-16b", "grok-1-314b")
B, S = 4, 24
# a shared direction in every token concentrates the routing on a few
# experts, so the default capacity drops assignments
SKEW = 3.0


class _Capture:
    """A stand-in for ``jax`` in `repro.models.moe` that records the
    per-group dispatch's and combine's operands and results."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        mapped = jax.vmap(fn, *a, **kw)
        names = {"dispatch_one": ("xt", "expert_idx", "gates", "buf",
                                  "dest", "tok", "w"),
                 "combine_one": ("eo", "c_dest", "c_tok", "c_w", "out")}
        if fn.__name__ not in names:
            return mapped

        def record(*args):
            outs = mapped(*args)
            flat = (*args, *(outs if isinstance(outs, tuple) else (outs,)))
            jax.debug.callback(
                lambda *v: self.seen.update(
                    zip(names[fn.__name__], map(np.asarray, v))), *flat)
            return outs
        return record


def _cfgs(arch, dtype, capacity=None):
    jcfg, tcfg = (get(arch).with_(dtype=dtype)
                  for get in (j_get_smoke, get_smoke))
    if capacity is not None:
        jcfg, tcfg = (c.with_(moe=dataclasses.replace(
            c.moe, capacity_factor=capacity)) for c in (jcfg, tcfg))
    return jcfg, tcfg


def _layer(arch, dtype, seed=0):
    """One MoE layer's JAX parameters and the port's copy of them."""
    jcfg, _ = _cfgs(arch, dtype)
    seg = j_transformer.init(jcfg, jax.random.PRNGKey(seed))["segments"][-1]
    jp = jax.tree.map(lambda a: a[0], seg["moe"])
    return jp, {k: convert.tensor(np.asarray(v), "cpu")
                for k, v in jp.items()}


def _x(d, dtype, seed=0, shape=(B, S)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, d)) + SKEW * rng.standard_normal(d)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jx, convert.tensor(np.asarray(jx), "cpu")


def _jax_apply(jp, jx, jcfg, groups, mask=None, o=None):
    """Jitted JAX `moe.apply` (of ``x + o`` if ``o`` is given) and what
    its dispatch and combine saw."""
    cap = _Capture()
    with mock.patch.object(j_moe, "jax", cap):
        fn = jax.jit(lambda p, x, m, o: j_moe.apply(
            p, x if o is None else x + o, jcfg, groups=groups,
            token_mask=m))
        out = fn(jp, jx, mask, o)
        out.block_until_ready()
    return np.asarray(out.astype(jnp.float32)), cap.seen


def _apply(tp, tx, tcfg, **kw):
    """The port's MoE FFN on x, normed as its block norms it."""
    return moe.apply(tp, tx, rms_norm(tx, tp["norm"], tcfg.norm_eps), tcfg,
                     **kw)


def _routing(tp, tx, tcfg, groups, mask=None):
    h = rms_norm(tx, tp["norm"], tcfg.norm_eps)
    return moe.route(h, tp["router"], tcfg, groups, mask)


def _dest(r, e):
    """JAX's buffer row within the group, ``expert * cap + position`` or
    ``E * cap`` (the trash row) where dropped, from the port's expert-major
    row ``expert * (G * cap) + group * cap + position``."""
    span = r.order.shape[0] * r.cap
    return torch.where(r.keep, r.row // span * r.cap + r.row % r.cap,
                       torch.full_like(r.row, e * r.cap))


def _assert_routing(r, seen, e):
    np.testing.assert_array_equal(r.expert_idx.numpy(), seen["expert_idx"])
    np.testing.assert_array_equal(_dest(r, e).numpy(), seen["dest"])
    np.testing.assert_array_equal(r.tok.numpy(), seen["tok"])
    np.testing.assert_array_equal(r.keep.numpy(),
                                  seen["dest"] < e * r.cap)
    np.testing.assert_allclose(r.gates.numpy(), seen["gates"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(r.w.numpy(), seen["w"], rtol=0, atol=1e-6)


def _assert_bf16(got, want):
    """bfloat16 outputs: bit for bit, but for at most 0.1% of the elements,
    where an expert GEMM's float32 sum, taken in another order, rounds to
    the neighbouring bf16 value; those within one bf16 step of the largest
    |out|."""
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert (got != want).mean() <= 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=step)


@pytest.mark.parametrize("groups", (1, 2))
@pytest.mark.parametrize("capacity", ("default", "raised"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, dtype, capacity, groups):
    """Routing exactly JAX's; at the default capacity some assignments
    are dropped, at ``capacity_factor = num_experts`` none; the output
    within 1e-5 of the largest in float32, as `_assert_bf16` says in
    bfloat16."""
    raised = capacity == "raised"
    jcfg, tcfg = _cfgs(arch, dtype,
                       get_smoke(arch).moe.num_experts if raised else None)
    jp, tp = _layer(arch, dtype)
    jx, tx = _x(tcfg.d_model, dtype)
    want, seen = _jax_apply(jp, jx, jcfg, groups)
    r = _routing(tp, tx, tcfg, groups)
    assert r.order.shape[0] == groups
    _assert_routing(r, seen, tcfg.moe.num_experts)
    dropped = int((~r.keep).sum())
    assert (dropped == 0) if raised else (dropped > 0)
    got = _apply(tp, tx, tcfg, groups=groups)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    if dtype == "bfloat16":
        _assert_bf16(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_residual_feeds_the_norm_unrounded(arch):
    """The block after attention: jitted JAX applies the FFN to the bf16
    sum ``x + o`` and XLA feeds that sum into the norm's float32 upcast
    unrounded, while the residual and the two adds after the combine
    round to bf16.  The port's block (`transformer._ffn`) does the same
    (`_assert_bf16`), and rounding the sum before the norm moves over 10%
    of the outputs."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _layer(arch, "bfloat16", seed=3)
    jx, tx = _x(tcfg.d_model, "bfloat16", seed=3)
    rng = np.random.default_rng(4)
    jo = jnp.asarray(rng.standard_normal(jx.shape) * 0.3, jnp.bfloat16)
    to = convert.tensor(np.asarray(jo), "cpu")
    want, _ = _jax_apply(jp, jx, jcfg, 1, o=jo)
    got = transformer._ffn({"moe": tp}, tx, to.float(), tcfg)
    _assert_bf16(got.float().numpy(), want)
    rounded = _apply(tp, (tx.float() + to).to(torch.bfloat16),
                     tcfg).float().numpy()
    assert (rounded != want).mean() > 0.1


@pytest.mark.parametrize("groups", (1, 2))
@pytest.mark.parametrize("arch", ARCHS)
def test_masked_tokens_take_no_capacity(arch, groups):
    """A ``token_mask``'s masked rows hold garbage: their assignments take
    the sentinel expert as in JAX, the valid tokens' routing is JAX's, and
    the valid rows' output is bit for bit the same under other garbage."""
    jcfg, tcfg = _cfgs(arch, "float32")
    e = tcfg.moe.num_experts
    jp, tp = _layer(arch, "float32")
    jx, tx = _x(tcfg.d_model, "float32")
    mask = np.ones((B, S), bool)
    mask[1] = False
    mask[3, ::3] = False
    _, seen = _jax_apply(jp, jx, jcfg, groups, mask=jnp.asarray(mask))
    tmask = torch.from_numpy(mask)
    r = _routing(tp, tx, tcfg, groups, tmask)
    _assert_routing(r, seen, e)
    assert int((r.expert_idx == e).sum()) == (~mask).sum() * tcfg.moe.top_k
    outs = []
    for seed in (7, 8):
        garbage = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            tx.shape).astype(np.float32) * 50)
        x = torch.where(tmask[..., None], tx, garbage)
        outs.append(_apply(tp, x, tcfg, groups=groups, token_mask=tmask))
    assert torch.equal(outs[0][tmask], outs[1][tmask])
    assert not torch.equal(outs[0][~tmask], outs[1][~tmask])


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_sums_in_jax_order_bit_for_bit(arch):
    """At ``capacity_factor = num_experts`` every token keeps all K
    assignments; fed JAX's own expert outputs, rows and weights, the
    port's combine (K gathers summed left to right from zero) equals
    JAX's scatter-add bit for bit in float32, and a pairwise sum of the
    same terms does not."""
    jcfg, tcfg = _cfgs(arch, "float32", get_smoke(arch).moe.num_experts)
    jp, tp = _layer(arch, "float32")
    jx, tx = _x(tcfg.d_model, "float32")
    _, seen = _jax_apply(jp, jx, jcfg, 1)
    r = _routing(tp, tx, tcfg, 1)
    assert bool(r.keep.all())
    eo = seen["eo"]                               # (G, E, cap, D)
    _, e, cap, d = eo.shape
    eflat = torch.cat([convert.tensor(eo.reshape(e * cap, d), "cpu"),
                       torch.zeros(1, d)])
    # with one group the expert-major row is JAX's buffer row
    r.row = convert.tensor(seen["c_dest"], "cpu").long()
    r.w = convert.tensor(seen["c_w"], "cpu")
    got = moe.combine(eflat, r, B * S).numpy()
    want = seen["out"]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_capacity_and_groups_follow_jax():
    """``cap = max(int(capacity_factor * Tg * k / E), 1)`` per group, the
    groups gcd(B, groups); at decode (B <= 8) deepseek-moe-16b's capacity
    is 1."""
    from repro_torch.configs import get_config
    full = get_config("deepseek-moe-16b")
    assert [moe.capacity(full, b) for b in (1, 4, 8)] == [1, 1, 1]
    assert moe.capacity(full, 4 * 2048) == 960
    assert [moe.n_groups(4, g) for g in (1, 2, 3, 8)] == [1, 2, 1, 4]
    cfg = get_smoke("grok-1-314b")
    assert moe.capacity(cfg, 48) == int(1.25 * 48 * 2 / 4)


def test_apply_reads_nothing_back():
    """`apply` and `route` never read a value back to the host (no
    ``item``, ``tolist``, truth value, ``nonzero``), so the dispatch has
    no data-dependent shape and a pool step stays shape-static."""
    _, tcfg = _cfgs("deepseek-moe-16b", "float32")
    _, tp = _layer("deepseek-moe-16b", "float32")
    _, tx = _x(tcfg.d_model, "float32")
    mask = torch.ones(B, S, dtype=torch.bool)
    mask[0, 0] = False

    def refuse(*a, **kw):
        raise AssertionError("a host read in the MoE dispatch")

    with mock.patch.multiple(torch.Tensor, item=refuse, tolist=refuse,
                             nonzero=refuse, __bool__=refuse,
                             __int__=refuse, __index__=refuse), \
            mock.patch.object(torch, "nonzero", refuse):
        out = _apply(tp, tx, tcfg, groups=2, token_mask=mask)
    assert out.shape == tx.shape


def test_plan_is_jax_leaf_for_leaf():
    """`plan` against JAX's `moe.plan`, stacked and not: keys, shapes,
    dtypes (the router float32), inits and fan-ins."""
    for arch in ARCHS:
        for stack in (0, 3):
            jcfg, tcfg = _cfgs(arch, "bfloat16")
            want = j_moe.plan(jcfg, stack)
            got = moe.plan(tcfg, stack)
            assert sorted(got) == sorted(want)
            for k, d in got.items():
                w = want[k]
                assert ((d.shape, d.dtype, d.init, d.scale, d.fan_in)
                        == (tuple(w.shape), w.dtype, w.init, w.scale,
                            w.fan_in)), k
    assert "ws_gate" not in moe.plan(get_smoke("grok-1-314b"))
    assert moe.plan(get_smoke("deepseek-moe-16b"))["router"].dtype == \
        "float32"


@pytest.mark.parametrize("arch", ARCHS)
def test_routed_experts_call_silu_through_layers(arch):
    """The routed experts call `layers.silu` through its module, so a
    patch of ``layers.silu`` (the plain path that the card's check sends
    the model through) reaches them as it reaches the shared experts and
    the dense MLP: one call for the routed experts, one more with shared
    experts, each on the expert GEMMs' ``(E, cap, d_expert)`` outputs."""
    from repro_torch.models import layers
    _, tcfg = _cfgs(arch, "float32")
    _, tp = _layer(arch, "float32")
    _, tx = _x(tcfg.d_model, "float32")
    shapes, real = [], layers.silu

    def spy(x, *a, **kw):
        shapes.append(tuple(x.shape))
        return real(x, *a, **kw)

    with mock.patch.object(layers, "silu", spy):
        _apply(tp, tx, tcfg)
    m = tcfg.moe
    routed = (m.num_experts, moe.capacity(tcfg, B * S), m.d_expert)
    assert shapes[0] == routed
    assert shapes[1:] == ([(B, S, m.n_shared * m.d_expert)] if m.n_shared
                          else [])
