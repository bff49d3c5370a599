"""Training the port's ``ssm`` and ``hybrid`` layouts (mamba2-1.3b,
zamba2-7b) against the JAX reference on the CPU: the SSD scan's backward,
the backward of silu's two Mamba2 forms, the loss and every gradient leaf
of both smoke archs, remat, three microbatched train steps, the hybrid's
shared leaves and the train CLI.

Every JAX function runs under ``jax.jit``; inputs come from numpy seeds or
from JAX's init carried over by `convert.lm_params`.  JAX trains through
its XLA chunked scan (``ssd_impl="xla"``), so the SSD gradient is held
against ``jax.vjp`` of it.  Tolerances:

* `ssd_scan_bwd_plain` against ``jax.vjp`` of the chunked oracle: float32
  within 1e-5 of each gradient's largest |g| (sums in another order;
  measured: 3e-6 at most); bfloat16 dx, dB and dC within one bf16 step of
  their largest |g| (both round a float32 sum once: JAX's B and C are
  repeated to heads after their float32 upcast here, so that a group's
  heads add in float32 as the port adds them; repeated in bf16 each head's
  share rounds first, two steps off at 8 heads), ddt and da (float32) as
  float32;
* the autograd Function on the CPU: exactly the plain gradients;
* silu's Mamba2 forms: bfloat16 bit for bit (the one-operand ``silu(x)``
  and the gate ``y * silu(z)`` upcast unrounded into the norm, whose
  transpose is `silu_bwd` of the float32 gradient rounded to bf16, as
  JAX's transpose of the upcast rounds it); float32 as
  ``tests/test_torch_train.py`` holds it (bit for bit given JAX's sigmoid,
  within 1e-6 of the largest |x| given the port's);
* the loss and every leaf, as ``test_loss_and_grads_match_jax``: float32
  1e-6 relative and 1e-5 of each leaf's largest |g|, bfloat16 1e-3 and
  3e-2; but zamba2's float32 leaves within 3e-5: they differ from JAX's
  by 0.5-2.5e-5 of their largest |g| (measured at 16, 24 and 40 tokens,
  seeds 0-2; 1.02e-5 here) whether the SSD scan is differentiated by its
  backward or by autograd of its plain chunked form (1.05e-5), since the
  shared block's and both super-blocks' float32 sums run in other orders
  (mamba2's within 3e-6 at 24 tokens); and zamba2's bfloat16 leaves
  within 5e-2: its attention's bf16 sums run in another order than
  JAX's, so even its forward is not JAX's bits, and with the SSD scan
  differentiated by autograd of its plain form (which rounds a head's dB
  and dC before the group's sum, as JAX's bf16 repeat does) a leaf is
  4.25e-2 off as with its backward (mamba2's within 1.6e-2);
* three steps of two microbatches: float32 losses within 1e-5 relative.
"""
import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke as j_get_smoke
from repro.kernels.ssd import ssd as j_ssd
from repro.launch.steps import make_loss_fn as j_make_loss_fn
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import factory as j_factory
from repro.models.layers import rms_norm as j_rms_norm
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro_torch import convert
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import get_smoke
from repro_torch.kernels.ssd import kernel as TK
from repro_torch.kernels.ssd import ref as TR
from repro_torch.launch import steps
from repro_torch.launch import train as T_train
from repro_torch.models import layers
from repro_torch.optim import adamw, warmup_cosine

ARCHS = ("mamba2-1.3b", "zamba2-7b")
GRADS = ("dx", "ddt", "da", "dB", "dC")


def _f32(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _bf16_step(w):
    m = float(np.abs(w).max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


# ---------------------------------------------------------------------------
# the SSD scan's backward
# ---------------------------------------------------------------------------

# (B, L, H, P, S, G, chunk, with dstate)
SSD_BWD_CASES = {"g1": (2, 64, 4, 16, 8, 1, 16, False),
                 "g2": (2, 64, 4, 16, 8, 2, 16, False),
                 "ragged": (1, 100, 4, 16, 8, 1, 32, False),
                 "dstate": (2, 96, 4, 16, 16, 2, 32, True)}


def _ssd_case(case, seed=0):
    """numpy float32 inputs, an output gradient and (maybe) a final-state
    gradient; dt and a keep every decay of a chunk within exp(-60), where
    the chunked oracle's masked exponent stays finite."""
    b, length, h, p, s, g, chunk, with_ds = SSD_BWD_CASES[case]
    rng = np.random.default_rng(seed + 11 * length + h)
    x = rng.standard_normal((b, length, h, p)).astype(np.float32)
    dt = (0.5 * np.log1p(np.exp(rng.standard_normal((b, length, h))))
          ).astype(np.float32)
    a = (-np.exp(0.2 * rng.standard_normal(h))).astype(np.float32)
    bm = rng.standard_normal((b, length, g, s)).astype(np.float32)
    cm = rng.standard_normal((b, length, g, s)).astype(np.float32)
    dy = rng.standard_normal((b, length, h, p)).astype(np.float32)
    ds = (rng.standard_normal((b, h, s, p)).astype(np.float32) if with_ds
          else None)
    return (x, dt, a, bm, cm, dy, ds), chunk


def _jax_ssd_vjp(h, chunk):
    def f(x, dt, a, bm, cm):
        rep = h // bm.shape[2]
        up = (lambda t: jnp.repeat(t.astype(jnp.float32), rep, axis=2))
        return j_ssd(x, dt, a, up(bm), up(cm), chunk=chunk, impl="xla")

    @jax.jit
    def vjp(x, dt, a, bm, cm, dy, ds):
        (_, state), pb = jax.vjp(f, x, dt, a, bm, cm)
        return pb((dy, jnp.zeros_like(state) if ds is None else ds))
    return vjp


def _port(arrays, dtype):
    """float32 numpy -> the port's tensors: x, B, C, dy in ``dtype``."""
    x, dt, a, bm, cm, dy, ds = arrays
    cast = (lambda t: torch.from_numpy(t).to(dtype))
    return (cast(x), torch.from_numpy(dt), torch.from_numpy(a), cast(bm),
            cast(cm), cast(dy), None if ds is None else torch.from_numpy(ds))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_BWD_CASES))
def test_ssd_scan_bwd_plain_matches_jax_vjp(case, dtype):
    arrays, chunk = _ssd_case(case)
    tdt = getattr(torch, dtype)
    tx, tdtv, ta, tb, tc, tdy, tds = _port(arrays, tdt)
    jx, jb, jc, jdy = (jnp.asarray(_f32(t), getattr(jnp, dtype))
                       for t in (tx, tb, tc, tdy))
    want = _jax_ssd_vjp(tx.shape[2], chunk)(
        jx, jnp.asarray(arrays[1]), jnp.asarray(arrays[2]), jb, jc, jdy,
        None if tds is None else jnp.asarray(arrays[6]))
    got = TR.ssd_scan_bwd_plain(tx, tdtv, ta, tb, tc, tdy, tds, chunk=chunk)
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == tuple(w.shape), name
        assert g.dtype == (tdt if name in ("dx", "dB", "dC")
                           else torch.float32), name
        g, w = _f32(g), _f32(w)
        err = float(np.abs(g - w).max())
        if dtype == "bfloat16" and name in ("dx", "dB", "dC"):
            assert err <= _bf16_step(w), (name, err, _bf16_step(w))
        else:
            assert err <= 1e-5 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("state_used", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_autograd_function_gives_the_plain_gradients(dtype, state_used):
    """On the CPU `ssd_scan` under autograd is the Function: its outputs
    are `ssd_scan_plain`'s bits and its gradients `ssd_scan_bwd_plain`'s
    (an unread final state's gradient counts as zero); it launches
    nothing."""
    arrays, chunk = _ssd_case("dstate")
    tx, tdtv, ta, tb, tc, tdy, tds = _port(arrays, getattr(torch, dtype))
    ins = [t.clone().requires_grad_() for t in (tx, tdtv, ta, tb, tc)]
    launches = (TK.ssd_scan.launches, TK.ssd_scan.bwd_launches)
    y, state = TK.ssd_scan(*ins, chunk=chunk)
    assert y.grad_fn is not None and "_Ssd" in type(y.grad_fn).__name__
    want_y, want_state = TK.ssd_scan_plain(tx, tdtv, ta, tb, tc, chunk=chunk)
    assert torch.equal(y.detach(), want_y)
    assert torch.equal(state.detach(), want_state)
    outs = (y, state) if state_used else (y,)
    grads = (tdy, tds) if state_used else (tdy,)
    torch.autograd.backward(outs, grads)
    want = TR.ssd_scan_bwd_plain(tx, tdtv, ta, tb, tc, tdy,
                                 tds if state_used else None, chunk=chunk)
    for name, t, w in zip(GRADS, ins, want):
        assert torch.equal(t.grad, w), name
    assert (TK.ssd_scan.launches, TK.ssd_scan.bwd_launches) == launches


def test_ssd_bwd_reads_strided_views():
    """x, B and C cut from one packed projection (as the Mamba2 block
    hands them over) give the gradients of their contiguous copies."""
    arrays, chunk = _ssd_case("g2")
    x, dt, a, bm, cm, dy, _ = _port(arrays, torch.float32)
    b, length, h, p = x.shape
    g, s = bm.shape[2:]
    packed = torch.cat([x.flatten(2), bm.flatten(2), cm.flatten(2)], -1)
    xv = packed[..., :h * p].unflatten(-1, (h, p))
    bv = packed[..., h * p:h * p + g * s].unflatten(-1, (g, s))
    cv = packed[..., h * p + g * s:].unflatten(-1, (g, s))
    assert not xv.is_contiguous()
    got = TK.ssd_scan_bwd(xv, dt, a, bv, cv, dy, chunk=chunk)
    want = TK.ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=chunk)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


# ---- the bf16 Hopper backward's arithmetic (csrc/ssd_bwd.cu) ---------------

# (B, L, H, P, S, G, heads a slab): the model's head over a ragged 200 with
# its group's 4 heads in slabs of 3 (the last one not full), zamba2's
# S = 64 with G = 2 over a ragged 150
EMULATED_BWD = {"model": (1, 200, 4, 64, 128, 1, 3),
                "s64-g2": (2, 150, 4, 32, 64, 2, 2)}


def _hi_lo(v, split=True):
    """v as bf16 hi and lo (lo zero unless ``split``), each in float32."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float() if split else torch.zeros_like(v)


def _emulate_bwd(x, dt, a, bmat, c, dy, dstate=None, *, slab, single=()):
    """The bf16 kernels' arithmetic in torch, per 64-row chunk (the ragged
    tail padded with zeros and dt = 0): the walks carry the state and its
    gradient in float32, each step taking the state as it stands in bf16
    hi + lo (``single`` "S_in" or "dS_out": hi alone) and adding
    (w o x)^T B or (exp(lg) o dy)^T C with w o x and exp(lg) o dy split;
    per chunk and head, products of the bf16 inputs in float32, the decay
    as 2^(lg_t log2(e) - lg_z log2(e)); dx = w o (B dS_out) + G^T dy with G
    split ("G": hi alone); dC and dB summed over a slab's heads in head
    order as exp(lg) o dy S_in^T and w o x dS_out^T, then the slab's dG'
    sum times B and its transpose times C, split ("dG": hi alone); the
    slabs summed in order; d(lg) in float32 into ddt and da; dx, dB, dC
    rounded once to bf16."""
    b, length, h, p = x.shape
    g, s = bmat.shape[2:]
    per, q = h // g, 64
    pad = (-length) % q
    n = (length + pad) // q

    def chunks(t):                       # (B, L, K, m) -> (B, n, K, q, m)
        t = F.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(b, n, q, t.shape[2], t.shape[3]).transpose(2, 3)
    xc, dyc = chunks(x), chunks(dy)                     # (B, n, H, q, P)
    bc, cc = chunks(bmat), chunks(c)                    # (B, n, G, q, S)
    bh, ch = (t.repeat_interleave(per, 2) for t in (bc, cc))
    dtc = F.pad(dt, (0, 0, 0, pad)).reshape(b, n, q, h).transpose(2, 3)
    cs = torch.cumsum(dtc, -1)                          # (B, n, H, q)
    lg = a[:, None] * cs
    lend = lg[..., -1:]
    el, w, last = torch.exp(lg), torch.exp(lend - lg) * dtc, torch.exp(lend)
    lg2 = lg * np.float32(np.log2(np.e))
    tri = torch.ones(q, q, dtype=torch.bool).tril()

    # the walks
    st = torch.zeros(b, h, s, p)
    sin = []
    for i in range(n):
        sin.append(_hi_lo(st, "S_in" not in single))
        whi, wlo = _hi_lo(w[:, i, :, :, None] * xc[:, i])
        st = (st * last[:, i, :, :, None] + bh[:, i].transpose(-1, -2) @ whi
              + bh[:, i].transpose(-1, -2) @ wlo)
    ds = torch.zeros(b, h, s, p) if dstate is None else dstate.float()
    dso = [None] * n
    for i in reversed(range(n)):
        dso[i] = _hi_lo(ds, "dS_out" not in single)
        ehi, elo = _hi_lo(el[:, i, :, :, None] * dyc[:, i])
        ds = (ds * last[:, i, :, :, None] + ch[:, i].transpose(-1, -2) @ ehi
              + ch[:, i].transpose(-1, -2) @ elo)
    shi, slo = (torch.stack(t, 1) for t in zip(*sin))  # (B, n, H, S, P)
    dhi, dlo = (torch.stack(t, 1) for t in zip(*dso))

    # each chunk and head
    dec = torch.where(tri, torch.exp2(torch.where(
        tri, lg2[..., :, None] - lg2[..., None, :], 0.0)), 0.0)
    dtz = dtc[..., None, :]
    cb = ch @ bh.transpose(-1, -2)                      # (B, n, H, t, z)
    dg = dyc @ xc.transpose(-1, -2)
    dgp = dg * dec * dtz
    nm = dg * cb * dec
    col_n = nm.sum(-2)
    row_m = (nm * dtz).sum(-1)
    y = dyc @ shi.transpose(-1, -2) + dyc @ slo.transpose(-1, -2)
    dlg_i = el * (ch * y).sum(-1)
    bds = bh @ dhi + bh @ dlo                           # (B, n, H, z, P)
    dw = (xc * bds).sum(-1)
    ghi, glo = _hi_lo(cb * dec * dtz, "G" not in single)
    dx = (w[..., None] * bds + ghi.transpose(-1, -2) @ dyc
          + glo.transpose(-1, -2) @ dyc)
    zz = xc @ dhi.transpose(-1, -2) + xc @ dlo.transpose(-1, -2)
    dot = ((shi + slo) * (dhi + dlo)).sum((-2, -1))    # (B, n, H)
    dcy, dbz = el[..., None] * y, w[..., None] * zz

    # a slab's heads in head order, then the slabs in order
    db = torch.zeros(b, n, g, q, s)
    dc = torch.zeros(b, n, g, q, s)
    for k in range(g):
        for h0 in range(k * per, (k + 1) * per, slab):
            heads = range(h0, min(h0 + slab, (k + 1) * per))
            sc, sb, sg = dcy[:, :, h0], dbz[:, :, h0], dgp[:, :, h0]
            for hh in heads[1:]:
                sc, sb, sg = sc + dcy[:, :, hh], sb + dbz[:, :, hh], \
                    sg + dgp[:, :, hh]
            fhi, flo = _hi_lo(sg, "dG" not in single)
            sc = sc + fhi @ bc[:, :, k] + flo @ bc[:, :, k]
            sb = (sb + fhi.transpose(-1, -2) @ cc[:, :, k]
                  + flo.transpose(-1, -2) @ cc[:, :, k])
            dc[:, :, k] += sc
            db[:, :, k] += sb

    # d(lg) into ddt and da
    m = dw * w
    dlg = row_m - dtc * col_n + dlg_i - m
    dlg[..., -1] += m.sum(-1) + last[..., 0] * dot
    rev = torch.flip(torch.cumsum(torch.flip(dlg, (-1,)), -1), (-1,))
    ddt = col_n + dw * torch.exp(lend - lg) + a[:, None] * rev
    da = (dlg * cs).sum((0, 1, 3))

    def rows(t):                         # (B, n, K, q, m) -> (B, L, K, m)
        return t.transpose(2, 3).reshape(b, n * q, *t.shape[2:3],
                                         t.shape[-1])[:, :length]
    return (rows(dx).bfloat16(), rows(ddt[..., None])[..., 0], da,
            rows(db).bfloat16(), rows(dc).bfloat16())


def _bwd_inputs(case, dy_scale=1.0, seed=0):
    """numpy-seeded bf16 x, B, C and dy (dy times ``dy_scale``, a power of
    two), float32 dt, a and a final-state gradient."""
    b, length, h, p, s, g, _ = EMULATED_BWD[case]
    rng = np.random.default_rng(seed + 7 * length + h)
    x = rng.standard_normal((b, length, h, p)).astype(np.float32)
    dt = (0.5 * np.log1p(np.exp(rng.standard_normal((b, length, h))))
          ).astype(np.float32)
    a = (-np.exp(0.5 * rng.standard_normal(h))).astype(np.float32)
    bm = rng.standard_normal((b, length, g, s)).astype(np.float32)
    cm = rng.standard_normal((b, length, g, s)).astype(np.float32)
    dy = (rng.standard_normal((b, length, h, p)) * dy_scale).astype(
        np.float32)
    ds = rng.standard_normal((b, h, s, p)).astype(np.float32)
    bf = (lambda t: torch.from_numpy(t).bfloat16())
    return (bf(x), torch.from_numpy(dt), torch.from_numpy(a), bf(bm), bf(cm),
            bf(dy), torch.from_numpy(ds))


def _bwd_gate(got, want):
    """Each gradient's error in its gate's units: dx, dB, dC in bf16 steps
    of the largest |g|, ddt and da in 1e-4 of the largest |g|; the gate is
    passed at <= 1."""
    out = {}
    for name, u, w in zip(GRADS, got, want):
        assert u.shape == tuple(w.shape), name
        u, w = _f32(u), _f32(w)
        err = float(np.abs(u - w).max())
        out[name] = err / (_bf16_step(w) if name in ("dx", "dB", "dC")
                           else 1e-4 * float(np.abs(w).max()))
    return out


@pytest.mark.parametrize("dy_scale", [1.0, 8.0])
@pytest.mark.parametrize("case", sorted(EMULATED_BWD))
def test_split_ssd_bwd_emulation_matches_plain_and_jax(case, dy_scale):
    """The bf16 Hopper backward's arithmetic (`_emulate_bwd`: the states,
    G and dG' split hi + lo) against `ssd_scan_bwd_plain` and jitted
    ``jax.vjp`` of JAX's chunked oracle at the card's bf16 gate: dx, dB
    and dC within one bf16 step of their largest |g|, ddt and da within
    1e-4 of theirs; dy at unit and 8x scale, with a final-state
    gradient."""
    args = _bwd_inputs(case, dy_scale)
    x, dt, a, bm, cm, dy, ds = args
    got = _emulate_bwd(*args, slab=EMULATED_BWD[case][-1])
    plain = TR.ssd_scan_bwd_plain(*args, chunk=64)
    jx, jb, jc, jdy = (jnp.asarray(_f32(t), jnp.bfloat16)
                       for t in (x, bm, cm, dy))
    want = _jax_ssd_vjp(x.shape[2], 64)(
        jx, jnp.asarray(dt.numpy()), jnp.asarray(a.numpy()), jb, jc, jdy,
        jnp.asarray(ds.numpy()))
    for ref in (plain, want):
        errs = _bwd_gate(got, ref)
        assert max(errs.values()) <= 1.0, errs


def test_single_bf16_ssd_bwd_operands_leave_the_gate():
    """Why the backward splits, against the plain version with dy at 8x
    scale: S_in or dS_out rounded once to bf16 takes the gradients out of
    the gate (measured 2.3-12x its width over two shapes, dy at 1x and 8x
    and three seeds), and G (into dx) or the slab's dG' (into dB and dC)
    rounded once doubles or more its gradients' largest error, to the
    gate's edge of one bf16 step; split, every gradient stays inside."""
    args = _bwd_inputs("model", 8.0, seed=1)
    plain = TR.ssd_scan_bwd_plain(*args, chunk=64)
    split = _bwd_gate(_emulate_bwd(*args, slab=3), plain)
    assert max(split.values()) <= 0.5, split
    for single in ("S_in", "dS_out"):
        errs = _bwd_gate(_emulate_bwd(*args, slab=3, single=(single,)),
                         plain)
        assert max(errs.values()) > 2.0, (single, errs)
    for single, grads in (("G", ("dx",)), ("dG", ("dB", "dC"))):
        errs = _bwd_gate(_emulate_bwd(*args, slab=3, single=(single,)),
                         plain)
        worst = max(errs[k] for k in grads)
        assert worst >= 1.0 and worst >= 2 * max(split[k] for k in grads), \
            (single, errs, split)


def test_bwd_plan_at_the_training_shapes():
    """The bf16 backward's launch, as `bwd_plan` lays it out at 132 SMs and
    the C launcher checks it: mamba2-1.3b's training block (1, 4096, 64,
    64, 128) takes 32 heads a CTA in 2 slabs (128 CTAs), its walks 2
    pieces of S (256 CTAs); zamba2-7b's (1, 4096, 112, 64, 64) 56 heads in
    2 slabs, its walks one piece (224 CTAs); the shared bytes are the
    kernels' own; 7 heads a group take slabs of 3, the last one not full;
    a shape the kernels cannot take raises."""
    got = TK.bwd_plan(1, 4096, 64, 1, 64, 128)
    assert got == dict(heads_a_cta=32, slabs=2, walk_split=2, walk_ctas=256,
                       grad_ctas=128, finish_warps=4096,
                       grad_kernel="ssd_bwd_grad_kernel<S<=128>",
                       grad_smem=227872, walk_smem=50976)
    got = TK.bwd_plan(1, 4096, 112, 1, 64, 64)
    assert got == dict(heads_a_cta=56, slabs=2, walk_split=1, walk_ctas=224,
                       grad_ctas=128, finish_warps=7168,
                       grad_kernel="ssd_bwd_grad_kernel<S<=64>",
                       grad_smem=145952, walk_smem=50976)
    got = TK.bwd_plan(1, 1300, 14, 2, 36, 128)
    assert (got["heads_a_cta"], got["slabs"], got["grad_ctas"]) == (3, 3, 126)
    assert TK.BWD_SMEM_BYTES == {
        torch.bfloat16: {"ssd_bwd_walk_kernel": 50976,
                         "ssd_bwd_grad_kernel<S<=64>": 145952,
                         "ssd_bwd_grad_kernel<S<=128>": 227872},
        torch.float32: {"ssd_bwd_kernel<S<=64>": 135488,
                        "ssd_bwd_kernel<S<=128>": 201536}}
    assert TK.BWD_KERNELS == (
        "ssd_bwd_walk_kernel", "ssd_bwd_grad_kernel<S<=128>",
        "ssd_bwd_grad_kernel<S<=64>", "ssd_bwd_finish_kernel",
        "ssd_bwd_slab_kernel")
    for bad in ((1, 64, 4, 1, 65, 128), (1, 64, 4, 1, 64, 132),
                (1, 64, 4, 1, 64, 30), (1, 64, 6, 4, 64, 128)):
        with pytest.raises(ValueError, match="bf16 SSD backward"):
            TK.bwd_plan(*bad)


# ---------------------------------------------------------------------------
# silu's two Mamba2 forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form,dtype", [("conv", "bfloat16"),
                                        ("conv", "float32"),
                                        ("gate", "bfloat16")])
def test_silu_mamba2_backward_matches_jax_vjp(form, dtype, monkeypatch):
    """The conv's ``silu(x)`` and the gate's ``silu(z, y, float32)``
    (JAX: ``y * jax.nn.silu(z)`` in bf16, upcast into the norm) under
    autograd run as Functions whose backward is `silu_bwd`; against
    jitted ``jax.vjp``: bfloat16 bit for bit, the gate with its norm
    after it too (the norm's float32 gradient rounds to bf16, then
    `silu_bwd`); float32 bit for bit given JAX's sigmoid and within 1e-6
    of the largest |x| given the port's."""
    rng = np.random.default_rng(8)
    jdt = getattr(jnp, dtype)
    g, u, dy = (jnp.asarray(rng.standard_normal((37, 96)) * s, jdt)
                for s in (4, 1, 0.5))
    tg, tu, tdy = (convert.tensor(np.asarray(t), "cpu") for t in (g, u, dy))
    xg = tg.clone().requires_grad_()
    if form == "conv":
        dg = jax.jit(lambda g, d: jax.vjp(jax.nn.silu, g)[1](d)[0])(g, dy)
        want = convert.tensor(np.asarray(dg), "cpu")
        out = layers.silu(xg)
        assert "_Silu" in type(out.grad_fn).__name__
        out.backward(tdy)
        plain = layers.silu_bwd_plain(tg, None, tdy)
        assert plain[1] is None and torch.equal(xg.grad, plain[0])
        assert torch.equal(out.detach(), layers.silu_plain(tg))
        if dtype == "bfloat16":
            assert torch.equal(xg.grad, want)
            return
        assert ((xg.grad - want).abs().max()
                <= 1e-6 * want.abs().max())
        js = convert.tensor(np.asarray(jax.jit(jax.nn.sigmoid)(g)), "cpu")
        monkeypatch.setattr(layers, "_sigmoid", lambda x: js)
        assert torch.equal(layers.silu_bwd_plain(tg, None, tdy)[0], want)
        return
    # the gate: y * silu(z), upcast unrounded, then the norm
    w = jnp.asarray(1 + 0.1 * rng.standard_normal(96), jdt)
    dn = jnp.asarray(rng.standard_normal((37, 96)), jdt)
    dz, du = jax.jit(lambda z, y, d: jax.vjp(
        lambda z, y: j_rms_norm(y * jax.nn.silu(z), w, 1e-5), z, y)[1](d))(
        g, u, dn)
    xu = tu.clone().requires_grad_()
    prod = layers.silu(xg, xu, torch.float32)
    assert prod.dtype == torch.float32
    assert "_Silu" in type(prod.grad_fn).__name__
    assert torch.equal(prod.detach(), layers.silu_plain(tg, tu,
                                                        torch.float32))
    out = layers.rms_norm(prod, convert.tensor(np.asarray(w), "cpu"),
                          1e-5).to(torch.bfloat16)
    out.backward(convert.tensor(np.asarray(dn), "cpu"))
    assert torch.equal(xg.grad, convert.tensor(np.asarray(dz), "cpu"))
    assert torch.equal(xu.grad, convert.tensor(np.asarray(du), "cpu"))


# ---------------------------------------------------------------------------
# the loss and its gradients; remat; the train step
# ---------------------------------------------------------------------------

def _cfgs(arch, dtype):
    return (j_get_smoke(arch).with_(dtype=dtype),
            get_smoke(arch).with_(dtype=dtype))


def _batch(cfg, b=2, s=24, seed=0):
    """Both packages' batch: tokens and labels shifted left, the last one
    a pad (24 tokens: a chunk of the smoke configs' 16 and a ragged one)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    return ({"inputs": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"inputs": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def _port_grads(params, slots):
    """The per-layer leaves' grads stacked back into the params' leaves
    (a zsuper's leaves by super-block, then inner block)."""
    by = {}
    for t, (i, j) in slots:
        by.setdefault(i, {})[j] = t.grad
    out = []
    for i, leaf in enumerate(flatten(params)[1]):
        d = by[i]
        if None in d:
            out.append(d[None])
            continue
        g = torch.zeros_like(leaf)
        for j, t in d.items():
            g[j] = t
        out.append(g)
    return out


def _jax_and_port(arch, dtype, seed=0):
    jcfg, cfg = _cfgs(arch, dtype)
    jp = j_factory.build(jcfg).init(jax.random.PRNGKey(seed))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, dtype):
    """The loss and every gradient leaf (each Mamba2 block's, per layer
    and for zamba2 per (super-block, inner block), the shared attention
    and MLP's, the embedding's and head's) against jitted JAX's
    ``value_and_grad``."""
    jcfg, cfg, jp, tp = _jax_and_port(arch, dtype)
    jb, tb = _batch(cfg)
    lj, gj = jax.jit(jax.value_and_grad(j_make_loss_fn(jcfg)))(jp, jb)
    tree, slots = steps._layer_leaves(tp)
    loss = steps.make_loss_fn(cfg)(tree, tb)
    loss.backward()
    rel, leaf_tol = (1e-6, 1e-5) if dtype == "float32" else (1e-3, 3e-2)
    if cfg.layout == "hybrid":
        leaf_tol = 3e-5 if dtype == "float32" else 5e-2
    assert abs(float(loss.detach()) - float(lj)) <= rel * abs(float(lj))
    got = _port_grads(tp, slots)
    assert len(got) == len(jax.tree.leaves(gj))
    for w, g in zip(jax.tree.leaves(gj), got):
        w, g = _f32(w), _f32(g)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= leaf_tol * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_are_bit_for_bit(arch):
    """With remat on (each Mamba2 block, and zamba2's shared block,
    recomputed in the backward) the loss and every gradient leaf are the
    bits of remat off."""
    _, cfg, _, _ = _jax_and_port(arch, "float32")
    _, tb = _batch(cfg, seed=1)
    out = []
    for remat in (False, True):
        tp = _jax_and_port(arch, "float32", seed=1)[3]
        tree, slots = steps._layer_leaves(tp)
        loss = steps.make_loss_fn(cfg.with_(remat=remat))(tree, tb)
        loss.backward()
        out.append((loss.detach(), _port_grads(tp, slots)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


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


def test_zamba2_shared_leaves_get_one_gradient_a_step():
    """zamba2's shared attention and MLP run once a super-block; autograd
    sums their uses, so each shared leaf's post-accumulate hook fires once
    a backward (a microbatch), with the sum; each (super-block, inner
    block) leaf of the Mamba2 stack is its own leaf, once too."""
    _, cfg, _, tp = _jax_and_port("zamba2-7b", "float32")
    n_super = cfg.n_layers // cfg.ssm.attn_every
    assert n_super >= 2
    _, tb = _batch(cfg, seed=2)
    paths = flatten(tp)[0]
    tree, slots = steps._layer_leaves(tp)
    calls = {}
    for t, slot in slots:
        t.register_post_accumulate_grad_hook(
            lambda t, slot=slot: calls.__setitem__(
                slot, calls.get(slot, 0) + 1))
    steps.make_loss_fn(cfg)(tree, tb).backward()
    assert set(calls) == {slot for _, slot in slots}
    assert all(n == 1 for n in calls.values())
    shared = [t for t, (i, j) in slots if paths[i].startswith("['shared_")]
    assert len(shared) == 9 and all(t.grad is not None for t in shared)
    inner = [j for _, (i, j) in slots if isinstance(j, tuple)]
    assert len(inner) == 9 * n_super * (cfg.ssm.attn_every - 1)
    # the summed gradient, as the step's accumulator gets it (one
    # microbatch: the grads autograd gives)
    seen = {}

    class Spy:
        def update(self, grads, state, params):
            seen["grads"] = [g.clone() for g in flatten(grads)[1]]
            return params, state

    steps.make_train_step(cfg, Spy(), microbatches=1)(tp, None, tb)
    want = _port_grads(tp, slots)
    assert all(torch.equal(a, b) for a, b in zip(seen["grads"], want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_the_ssm_layouts(arch, tmp_path):
    """``launch.train --arch mamba2-1.3b`` / ``zamba2-7b --smoke`` on the
    CPU: finite losses, and no kernel launches (the plain versions)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = T_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "2", "--global-batch", "2",
                           "--seq-len", "20", "--ckpt", str(tmp_path),
                           "--save-every", "2"])
    text = buf.getvalue()
    out = json.loads(text[text.index("{"):])
    assert rc == 0 and out["steps"] == 2
    assert math.isfinite(out["first_loss"]) and math.isfinite(
        out["last_loss"])
    assert set(out["launches"].values()) == {0}
    assert "ssd_scan" in out["launches"] and "ssd_scan_bwd" in out[
        "launches"]
