"""Training the port's ``moe`` layout (deepseek-moe-16b, grok-1-314b)
against the JAX reference on the CPU: the loss and every gradient leaf of
both smoke archs with and without dropped assignments, the MoE block's
vjp alone (with a token mask and in two dispatch groups), the rounding
sites of the dispatch's and combine's backwards, the absence of any
accumulating scatter in the block's backward, remat, the per-layer
leaves and the microbatch accumulator, three microbatched train steps,
the load-balance auxiliary, a JAX-written train checkpoint continued and
the train CLI.

Every JAX function runs under ``jax.jit``; inputs come from numpy seeds or
from JAX's init carried over by `convert.lm_params`.  Tolerances:

* the loss and every leaf, as ``tests/test_torch_train.py``'s
  ``test_loss_and_grads_match_jax``: float32 1e-6 relative and 1e-5 of
  each leaf's largest |g|, bfloat16 1e-3 and 3e-2;
* the block's vjp (`moe.apply` after the block's norm, against
  ``jax.vjp`` of JAX's ``moe.apply``): float32 within 1e-5 of each
  gradient's largest |g|, bfloat16 within 3e-2;
* the dispatch's backward: bit for bit in bfloat16 and float32 against
  ``jax.vjp`` of JAX's dispatch expression (the transpose of its gather
  ``xt_g[tok]`` adds each token's K rows in ascending sorted position and
  rounds every add to bf16); the combine's expert-output gradient bit for
  bit (``go[tok] * w`` rounded once), its gate-weight gradient (a float32
  row dot product summed in another order) within 1e-6 of the largest;
* three steps of two microbatches: float32 losses within 1e-5 relative;
* `aux_load_balance_loss`: value and gradient within 1e-6 relative.
"""
import contextlib
import dataclasses
import io
import json
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke as j_get_smoke
from repro.launch.steps import make_loss_fn as j_make_loss_fn
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import factory as j_factory
from repro.models import moe as j_moe
from repro.models import transformer as j_transformer
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint
from repro_torch.checkpoint.manager import flatten, structure
from repro_torch.configs import get_smoke
from repro_torch.launch import steps
from repro_torch.launch import train as T_train
from repro_torch.models import factory, moe
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.optim import adamw, warmup_cosine

ARCHS = ("deepseek-moe-16b", "grok-1-314b")
B, S = 4, 24
# a shared direction in every token concentrates the routing on a few
# experts, so the default capacity drops assignments (as test_torch_moe)
SKEW = 3.0


def _f32(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _cfgs(arch, dtype, capacity=None):
    jcfg, cfg = (get(arch).with_(dtype=dtype)
                 for get in (j_get_smoke, get_smoke))
    if capacity is not None:
        jcfg, cfg = (c.with_(moe=dataclasses.replace(
            c.moe, capacity_factor=capacity)) for c in (jcfg, cfg))
    return jcfg, cfg


def _jax_and_port(arch, dtype, capacity=None, seed=0):
    jcfg, cfg = _cfgs(arch, dtype, capacity)
    jp = j_factory.build(jcfg).init(jax.random.PRNGKey(seed))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _batch(cfg, b=2, s=24, seed=0):
    """Both packages' batch: tokens and labels shifted left, the last one
    a pad."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    return ({"inputs": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"inputs": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def _port_grads(params, slots):
    """The per-layer leaves' grads stacked back into the params' leaves."""
    by = {}
    for t, (i, j) in slots:
        by.setdefault(i, {})[j] = t.grad
    out = []
    for i, leaf in enumerate(flatten(params)[1]):
        d = by[i]
        out.append(d[None] if None in d else
                   torch.stack([d[j] for j in range(len(d))]))
    return out


def _routing_log():
    """A patch of `moe.route` that keeps every `Routing` it makes."""
    seen, real = [], moe.route

    def route(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]
    return seen, mock.patch.object(moe, "route", route)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

class _JaxChoices:
    """A stand-in for ``jax`` in `repro.models.moe` that records each MoE
    layer's expert choices (its per-group dispatch's ``expert_idx``) from
    inside the jitted program, layer by layer."""

    def __init__(self):
        self.idx = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        mapped = jax.vmap(fn, *a, **kw)
        if fn.__name__ != "dispatch_one":
            return mapped

        def record(*args):
            jax.debug.callback(lambda i: self.idx.append(np.asarray(i)),
                               args[1], ordered=True)
            return mapped(*args)
        return record


class _RouteAs:
    """A stand-in for ``torch`` in `repro_torch.models.moe` whose ``sort``
    (`moe.route`'s top-k) puts the given expert choices first, call by
    call, and records each token that the port alone would have routed
    elsewhere: (its k-th largest probability, the largest probability
    among the given experts it did not choose)."""

    def __init__(self, choices):
        self.choices, self.flips = list(choices), []

    def __getattr__(self, name):
        return getattr(torch, name)

    def sort(self, probs, **kw):
        _, idx = torch.sort(probs, **kw)
        want = torch.from_numpy(self.choices.pop(0)).long()
        k = want.shape[-1]
        own = idx[..., :k]
        for g, t in (own != want).any(-1).nonzero().tolist():
            p = probs[g, t].detach()
            other = [e for e in want[g, t].tolist()
                     if e not in own[g, t].tolist()]
            self.flips.append((float(p[own[g, t, -1]]),
                               max(float(p[e]) for e in other)))
        idx = torch.cat([want, idx[..., k:]], -1)
        return probs.gather(-1, idx), idx


@pytest.mark.parametrize("capacity", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, dtype, capacity):
    """The loss and every gradient leaf (the dense first layer's, each MoE
    layer's router, routed and shared experts, attention, the embedding
    and head) against jitted JAX's ``value_and_grad``; at capacity 0.5
    the capacity drops assignments in every MoE layer.

    The gradients are compared on JAX's routing, read out of its jitted
    program: in float32 the port routes every token as JAX does (held
    here).  In bfloat16 the attention's sums run in another order than
    JAX's, so a token whose k-th and (k+1)-th router probabilities are
    within a few bf16 steps can pick the other expert (seed 0,
    deepseek-moe-16b at capacity 1.25: one token of the second MoE
    layer, its probabilities 1.2e-5 apart), and a whole token's update
    then differs; each such token must be a near tie (the two
    probabilities within 1e-2 of each other) and is routed as JAX routed
    it."""
    jcfg, cfg, jp, tp = _jax_and_port(arch, dtype, capacity)
    jb, tb = _batch(cfg)
    choices = _JaxChoices()
    with mock.patch.object(j_moe, "jax", choices):
        lj, gj = jax.jit(jax.value_and_grad(j_make_loss_fn(jcfg)))(jp, jb)
        jax.effects_barrier()
    assert len(choices.idx) == cfg.n_layers - cfg.moe.first_dense
    tree, slots = steps._layer_leaves(tp)
    seen, patch = _routing_log()
    forced = _RouteAs(choices.idx)
    with patch, mock.patch.object(moe, "torch", forced):
        loss = steps.make_loss_fn(cfg)(tree, tb)
    loss.backward()
    assert not forced.choices
    if dtype == "float32":
        assert not forced.flips
    for kth, other in forced.flips:
        assert kth - other <= 1e-2 * kth
    if capacity < 1:
        assert all(int((~r.keep).sum()) > 0 for r in seen)
    rel, leaf_tol = (1e-6, 1e-5) if dtype == "float32" else (1e-3, 3e-2)
    assert abs(float(loss.detach()) - float(lj)) <= rel * abs(float(lj))
    got = _port_grads(tp, slots)
    assert len(got) == len(jax.tree.leaves(gj))
    for w, g in zip(jax.tree.leaves(gj), got):
        w, g = _f32(w), _f32(g)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= leaf_tol * max(np.abs(w).max(), 1e-30)


# ---------------------------------------------------------------------------
# the block alone
# ---------------------------------------------------------------------------

def _layer(arch, dtype, seed=0):
    """One MoE layer's JAX parameters and the port's copy of them."""
    jcfg, _ = _cfgs(arch, dtype)
    seg = j_transformer.init(jcfg, jax.random.PRNGKey(seed))["segments"][-1]
    jp = jax.tree.map(lambda a: a[0], seg["moe"])
    return jp, {k: convert.tensor(np.asarray(v), "cpu")
                for k, v in jp.items()}


def _block_inputs(d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)) + SKEW * rng.standard_normal(d)
    ct = rng.standard_normal((B, S, d))
    jx, jct = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, ct))
    return jx, jct, *(convert.tensor(np.asarray(a), "cpu") for a in (jx, jct))


def _port_block(tp, tx, cfg, **kw):
    """The block as the model runs it: the norm, then `moe.apply`."""
    return moe.apply(tp, tx, rms_norm(tx, tp["norm"], cfg.norm_eps), cfg,
                     **kw)


MASK = np.ones((B, S), bool)
MASK[1, 5:] = False
MASK[3, ::4] = False


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_vjp_matches_jax(arch, dtype, groups, masked):
    """`moe.apply`'s vjp (x and every parameter) against ``jax.vjp`` of
    JAX's ``moe.apply`` at the default capacity (some assignments
    dropped), in one and two dispatch groups, with and without a token
    mask.  A masked token takes no expert: its gradient through the
    block's normed input is exactly the shared experts' (zero without
    them), and the routed experts' and router's gradients do not move
    when its output gradient does."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp, tp = _layer(arch, dtype)
    jx, jct, tx, tct = _block_inputs(cfg.d_model, dtype)
    jmask = jnp.asarray(MASK) if masked else None
    tmask = torch.from_numpy(MASK) if masked else None

    def jfn(p, x):
        return j_moe.apply(p, x, jcfg, groups=groups, token_mask=jmask)

    want = jax.jit(lambda p, x, ct: jax.vjp(jfn, p, x)[1](ct))(jp, jx, jct)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    _port_block(leaves, x, cfg, groups=groups, token_mask=tmask).backward(
        tct)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for name, g in [*((k, v.grad) for k, v in leaves.items()),
                    ("x", x.grad)]:
        w = _f32(want[1] if name == "x" else want[0][name])
        g = _f32(g)
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), \
            name
    if not masked:
        return
    h = rms_norm(tx, tp["norm"], cfg.norm_eps).requires_grad_()
    routed = {k: v.clone().requires_grad_() for k, v in tp.items()}
    moe.apply(routed, tx, h, cfg, groups=groups,
              token_mask=tmask).backward(tct)
    if cfg.moe.n_shared:
        hs = h.detach().requires_grad_()
        swiglu(hs, tp["ws_gate"], tp["ws_up"], tp["ws_down"]).backward(tct)
        shared = hs.grad
    else:
        shared = torch.zeros_like(h)
    assert torch.equal(h.grad[~tmask], shared[~tmask])
    # garbage output gradients at the masked tokens move nothing routed
    ct2 = torch.where(tmask[..., None], tct, 50 * torch.randn_like(tct))
    again = {k: v.clone().requires_grad_() for k, v in tp.items()}
    moe.apply(again, tx, h.detach(), cfg, groups=groups,
              token_mask=tmask).backward(ct2)
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert torch.equal(routed[k].grad, again[k].grad), k


def _jax_dispatch(idx, cap, e):
    """The JAX package's per-group dispatch (``src/repro/models/moe.py``,
    ``dispatch_one``) as an expression of x alone, vmapped over groups."""
    def one(xt_g, idx_g):
        tg, k = idx_g.shape
        flat_e = idx_g.reshape(-1)
        order = jnp.argsort(flat_e)
        sorted_e = flat_e[order]
        pos = jnp.arange(tg * k) - jnp.searchsorted(sorted_e, sorted_e,
                                                    side="left")
        keep = (pos < cap) & (sorted_e < e)
        dest = jnp.where(keep, sorted_e * cap + pos, e * cap)
        buf = jnp.zeros((e * cap + 1, xt_g.shape[-1]), xt_g.dtype)
        buf = buf.at[dest].set(xt_g[order // k])
        return buf[:e * cap].reshape(e, cap, -1)
    return lambda xt: jax.vmap(one)(xt, idx)


@pytest.mark.parametrize("form", ["function", "indexing"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_backward_rounds_as_jax(arch, dtype, groups, form):
    """The dispatch's backward bit for bit against ``jax.vjp`` of JAX's
    dispatch expression on the same routing: each token's K kept rows
    summed in ascending sorted position, every add rounded to the
    gradient's dtype (in bf16 a float32 sum rounded once is not JAX's:
    checked here too), dropped assignments adding nothing.  Each token
    takes K = 3 experts (the smoke configs' 2 add once: any order and
    either rounding give the same bits).  Both `_Dispatch` and autograd
    of the indexing form (`dispatch_plain`, whose backward is an
    ``index_put_`` with accumulate, applied in index order) round so."""
    _, cfg = _cfgs(arch, dtype)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, top_k=3))
    _, tp = _layer(arch, dtype)
    _, _, tx, _ = _block_inputs(cfg.d_model, dtype)
    h = rms_norm(tx, tp["norm"], cfg.norm_eps)
    r = moe.route(h, tp["router"], cfg, groups)
    assert int((~r.keep).sum()) > 0
    g_n, e, cap, d = r.order.shape[0], cfg.moe.num_experts, r.cap, \
        cfg.d_model
    rng = np.random.default_rng(5)
    gbuf = jnp.asarray(rng.standard_normal((g_n, e, cap, d)) * 3,
                       getattr(jnp, dtype))
    xt = jnp.asarray(_f32(h).reshape(g_n, -1, d), getattr(jnp, dtype))
    fn = _jax_dispatch(jnp.asarray(r.expert_idx.numpy()), cap, e)
    want = _f32(jax.jit(lambda x, g: jax.vjp(fn, x)[1](g)[0])(xt, gbuf))
    hg = h.detach().requires_grad_()
    buf = (moe.dispatch if form == "function" else moe.dispatch_plain)(
        hg, r, cfg)
    # the port's buffer is expert-major, (E, G, cap): JAX's (G, E, cap)
    tg = convert.tensor(np.asarray(gbuf), "cpu").transpose(0, 1).reshape(
        e * g_n * cap, d)
    buf[:-1].backward(tg)
    got = _f32(hg.grad).reshape(g_n, -1, d)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if dtype == "bfloat16":
        _, rows = moe._token_tables(r, B * S // g_n)
        flat = torch.cat([tg.float(), torch.zeros(1, d)])
        once = flat[rows].sum(-2).to(torch.bfloat16).float().numpy()
        assert not np.array_equal(once, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_combine_backward_matches_autograd_of_the_indexing_form(arch, dtype):
    """`_Combine`'s gradients against autograd of `combine_plain` (whose
    backward scatters with accumulation) on the same tables: the expert
    outputs' bit for bit (``go[tok] * w`` rounded once, each kept row
    written once, the trash row's dropped), the sorted gate weights'
    within 1e-6 of the largest (a row dot product summed in another
    order)."""
    _, cfg = _cfgs(arch, dtype)
    _, tp = _layer(arch, dtype)
    _, _, tx, _ = _block_inputs(cfg.d_model, dtype)
    h = rms_norm(tx, tp["norm"], cfg.norm_eps)
    r = moe.route(h, tp["router"], cfg, 2)
    rows_n = cfg.moe.num_experts * 2 * r.cap
    gen = torch.Generator().manual_seed(3)
    eo = torch.cat([torch.randn(rows_n, cfg.d_model, generator=gen),
                    torch.zeros(1, cfg.d_model)]).to(tx.dtype)
    tg = B * S // 2
    go = torch.randn(2, tg, cfg.d_model, generator=gen)
    got = []
    for fn in ("function", "plain"):
        e_ = eo.clone().requires_grad_()
        w_ = r.w.detach().clone().requires_grad_()
        rr = dataclasses.replace(r, w=w_)
        out = (moe.combine if fn == "function" else moe.combine_plain)(
            e_, rr, tg)
        out.backward(go)
        got.append((out.detach(), e_.grad, w_.grad))
    (o1, ge1, gw1), (o2, ge2, gw2) = got
    assert torch.equal(o1, o2)
    ge2[-1] = 0                       # the plain form sums into the trash
    assert torch.equal(ge1, ge2)
    assert float((gw1 - gw2).abs().max()) <= 1e-6 * float(gw2.abs().max())


_ACCUMULATING = ("aten.index_add", "aten.index_put", "aten._index_put_impl_",
                 "aten.scatter_add", "aten.scatter_reduce",
                 "aten.index_reduce", "aten.put")


class _RefuseAccumulation(TorchDispatchMode):
    """Raises on any ATen op that accumulates into a tensor by index
    (autograd's own gather and indexing backwards included): an
    ``index_put`` with ``accumulate=True``, ``index_add``,
    ``scatter_add``, ``scatter_reduce``, ``index_reduce``, ``put``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if name.startswith(_ACCUMULATING):
            acc = (kwargs.get("accumulate", args[3] if len(args) > 3
                              else False)
                   if "index_put" in name or name == "aten.put" else True)
            if acc:
                raise AssertionError(f"an accumulating scatter: {func}")
        return func(*args, **kwargs)


def _refuse(*a, **kw):
    raise AssertionError("an accumulating scatter in the MoE backward")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_backward_uses_no_atomics(arch):
    """The whole MoE layer's backward (route, dispatch, experts, combine,
    shared experts) runs no accumulating scatter: ``index_add_``,
    ``scatter_add_`` and ``index_put_(accumulate=True)`` raise when
    called, and so does every ATen op that accumulates by index (what
    autograd's gather and indexing backwards would run).  The indexing
    form differentiated by autograd runs one (the refusal bites)."""
    _, cfg = _cfgs(arch, "float32")
    _, tp = _layer(arch, "float32")
    _, _, tx, tct = _block_inputs(cfg.d_model, "float32")
    real_put = torch.Tensor.index_put_

    def index_put_(self, indices, values, accumulate=False):
        if accumulate:
            _refuse()
        return real_put(self, indices, values, accumulate)

    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    out = _port_block(leaves, x, cfg, groups=2,
                      token_mask=torch.from_numpy(MASK))
    with mock.patch.multiple(torch.Tensor, index_add_=_refuse,
                             scatter_add_=_refuse, index_put_=index_put_), \
            _RefuseAccumulation():
        out.backward(tct)
    assert all(v.grad is not None for v in leaves.values())
    with mock.patch.object(moe, "combine", moe.combine_plain):
        out = _port_block({k: v.clone().requires_grad_()
                           for k, v in tp.items()}, tx, cfg)
    with pytest.raises(AssertionError, match="accumulating"), \
            _RefuseAccumulation():
        out.backward(tct)


def test_experts_without_grad_write_out_in_place():
    """Serving's form: under ``no_grad`` the routed experts' last product
    writes into ``out`` in place and hands it back; under autograd they
    make a new tensor with a gradient."""
    cfg = get_smoke("deepseek-moe-16b").with_(dtype="float32")
    e, f, d = cfg.moe.num_experts, cfg.moe.d_expert, cfg.d_model
    params = {"w_gate": torch.randn(e, d, f, requires_grad=True),
              "w_up": torch.randn(e, d, f), "w_down": torch.randn(e, f, d)}
    buf = torch.randn(e, 3, d)
    store = torch.zeros(e * 3 + 1, d)
    with torch.no_grad():
        out = moe.experts(params, buf, store[:-1].view(e, 3, d))
    assert out.data_ptr() == store.data_ptr()
    assert not bool((store[:-1] == 0).all()) and bool((store[-1] == 0).all())
    got = moe.experts(params, buf)
    assert got.requires_grad and torch.equal(got.detach(), out)
    got.sum().backward()
    assert params["w_gate"].grad is not None


# ---------------------------------------------------------------------------
# remat, train steps, the auxiliary loss
# ---------------------------------------------------------------------------

def test_remat_recomputes_the_forward_routing():
    """With remat on, each MoE layer routes twice (the forward and its
    recompute in the backward), and the recompute's `Routing` is the
    forward's: every index table, the gates and the weights equal, the
    same capacity."""
    _, cfg, _, tp = _jax_and_port("deepseek-moe-16b", "bfloat16", 0.5)
    _, tb = _batch(cfg, seed=4)
    tree, _ = steps._layer_leaves(tp)
    seen, patch = _routing_log()
    with patch:
        steps.make_loss_fn(cfg.with_(remat=True))(tree, tb).backward()
    n = cfg.n_layers - cfg.moe.first_dense
    assert len(seen) == 2 * n
    # the backward recomputes the layers last first
    for a, b in zip(seen[:n], seen[n:][::-1]):
        assert a.cap == b.cap
        for f in dataclasses.fields(moe.Routing):
            if f.name != "cap":
                assert torch.equal(getattr(a, f.name), getattr(b, f.name))


def test_layer_leaves_split_the_moe_stacks():
    """`steps._layer_leaves` hands the loss each MoE layer's experts as a
    view of its stack: the ``(L, E, D, F)`` leaves split into L ``(E, D,
    F)`` leaves that share the stack's storage, each its own slot, as a
    dense segment's leaves split."""
    _, cfg, _, tp = _jax_and_port("deepseek-moe-16b", "float32")
    paths, leaves = flatten(tp)
    tree, slots = steps._layer_leaves(tp)
    n = cfg.n_layers - cfg.moe.first_dense
    by_path = {paths[i]: [] for i in range(len(paths))}
    for t, (i, j) in slots:
        by_path[paths[i]].append((j, t))
    for name in ("w_gate", "w_up", "w_down", "router"):
        i = paths.index(f"['segments']/[1]/['moe']/['{name}']")
        got = sorted(by_path[paths[i]], key=lambda p: p[0])
        assert [j for j, _ in got] == list(range(n))
        for j, t in got:
            assert t.shape == leaves[i].shape[1:] and t.requires_grad
            assert t.data_ptr() == leaves[i][j].data_ptr()
    assert tree["segments"][1]["moe"]["w_gate"][0].shape == (
        cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert)


def test_train_step_accumulates_moe_leaves_as_value_and_grad():
    """Two microbatches: the optimizer gets the float32 mean of the two
    backwards' gradients, ``(0 + g0) + g1`` then halved, for every leaf
    (each MoE layer's experts and router included); one: the gradients
    autograd gives."""
    _, cfg, _, tp = _jax_and_port("deepseek-moe-16b", "float32")
    seen = {}

    class Spy:
        def update(self, grads, state, params):
            seen["grads"] = [g.clone() for g in flatten(grads)[1]]
            return params, state

    _, tb = _batch(cfg, b=4, seed=3)
    for mb in (1, 2):
        steps.make_train_step(cfg, Spy(), microbatches=mb)(tp, None, tb)
        want = []
        for k in range(mb):
            tree, slots = steps._layer_leaves(tp)
            part = {key: x[k * 4 // mb:(k + 1) * 4 // mb]
                    for key, x in tb.items()}
            steps.make_loss_fn(cfg)(tree, part).backward()
            g = _port_grads(tp, slots)
            want = g if not want else [a + b for a, b in zip(want, g)]
        want = [w / mb for w in want] if mb > 1 else want
        assert all(torch.equal(a, b) for a, b in zip(seen["grads"], want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    """Three steps of two microbatches, AdamW with warmup-cosine: the
    float32 losses within 1e-5 relative, the step counter as JAX's."""
    jcfg, cfg, jp, tp = _jax_and_port(arch, "float32")
    jopt = j_adamw(lr=j_warmup_cosine(1e-3, 1, 3))
    topt = adamw(lr=warmup_cosine(1e-3, 1, 3))
    jstep = jax.jit(j_make_train_step(jcfg, jopt, microbatches=2))
    tstep = steps.make_train_step(cfg, topt, microbatches=2)
    js, ts = jopt.init(jp), topt.init(tp)
    for k in range(3):
        jb, tb = _batch(cfg, b=4, seed=10 + k)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        lj, lt = float(jm["loss"]), float(tm["loss"])
        assert abs(lt - lj) <= 1e-5 * abs(lj)
        assert int(ts.step) == int(js.step) == k + 1
    assert structure(ts.mu) == structure(tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches_jax(arch):
    """`aux_load_balance_loss` of one MoE layer: its value and its
    gradient (x, the norm and the router; the top-1 counts carry none)
    against jitted JAX's, within 1e-6 relative."""
    jcfg, cfg = _cfgs(arch, "float32")
    jp, tp = _layer(arch, "float32")
    jx, _, tx, _ = _block_inputs(cfg.d_model, "float32", seed=6)
    lj, (gpj, gxj) = jax.jit(jax.value_and_grad(
        lambda p, x: j_moe.aux_load_balance_loss(p, x, jcfg),
        argnums=(0, 1)))(jp, jx)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    lt = moe.aux_load_balance_loss(leaves, x, cfg)
    lt.backward()
    assert lt.dtype == torch.float32
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    for name, g, w in [("x", x.grad, gxj), *((k, leaves[k].grad, gpj[k])
                                            for k in ("norm", "router"))]:
        w, g = _f32(w), _f32(g)
        assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-30), \
            name
    assert leaves["w_gate"].grad is None


# ---------------------------------------------------------------------------
# a JAX checkpoint continued; the CLI
# ---------------------------------------------------------------------------

def test_jax_train_checkpoint_continues_in_the_port(tmp_path):
    """JAX trains deepseek-moe-16b's smoke config one step and saves
    {"params", "opt"}; the port restores it and both take the next step
    on the same batch: the same loss within 1e-5, the same step count,
    the params within 1e-5 of each leaf's largest |x|, the routed
    experts' within 5e-5: an expert weight that few tokens reach can
    have a gradient near AdamW's eps (1e-8), where the step m / (sqrt(v)
    + eps) turns the float32 sums' last-bit differences into a visible
    move (measured: 1.31e-5 of w_gate's largest, at an element whose
    gradient is ~6e-10)."""
    jcfg, cfg, jp, _ = _jax_and_port("deepseek-moe-16b", "float32")
    jopt = j_adamw(lr=1e-3, master_weights=True)
    jstep = jax.jit(j_make_train_step(jcfg, jopt))
    js = jopt.init(jp)
    jb, _ = _batch(cfg, seed=20)
    jp, js, _ = jstep(jp, js, jb)
    JCheckpointManager(str(tmp_path)).save(1, {"params": jp, "opt": js})

    topt = adamw(lr=1e-3, master_weights=True)
    like_p = factory.build(cfg).init(torch.Generator().manual_seed(9))
    state, step, _ = load_checkpoint(str(tmp_path), {
        "params": like_p, "opt": topt.init(like_p)})
    assert step == 1 and int(state["opt"].step) == 1
    via = convert.opt_state(jax.tree.map(np.asarray, js), cfg, "cpu")
    for a, b in zip(flatten(via)[1], flatten(state["opt"])[1]):
        assert torch.equal(a, b)
    jb, tb = _batch(cfg, seed=21)
    jp, js, jm = jstep(jp, js, jb)
    tp, ts, tm = steps.make_train_step(cfg, topt)(state["params"],
                                                 state["opt"], tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert int(ts.step) == int(js.step) == 2
    for path, a, b in zip(flatten(tp)[0], jax.tree.leaves(jp),
                          flatten(tp)[1]):
        a, b = _f32(a), _f32(b)
        tol = 5e-5 if path.split("/")[-1] in ("['w_gate']", "['w_up']",
                                              "['w_down']") \
            and "['moe']" in path else 1e-5
        assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-30)


def _cli(ckpt, arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = T_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "4", "--global-batch", "2",
                           "--seq-len", "20", "--ckpt", str(ckpt),
                           "--save-every", "2"])
    text = buf.getvalue()
    return rc, json.loads(text[text.index("{"):])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_and_resumes_the_moe_layout(arch, tmp_path):
    """``launch.train --arch deepseek-moe-16b`` / ``grok-1-314b --smoke``
    on the CPU: finite losses, no kernel launches (the plain versions);
    the same command again resumes at step 4 and runs none."""
    rc, first = _cli(tmp_path, arch)
    assert rc == 0 and first["steps"] == 4 and first["start_step"] == 0
    assert math.isfinite(first["first_loss"]) and math.isfinite(
        first["last_loss"])
    assert abs(first["first_loss"] - np.log(512)) < 1.0
    assert set(first["launches"].values()) == {0}
    rc, again = _cli(tmp_path, arch)
    assert rc == 0 and again["start_step"] == 4 and again["steps"] == 0
