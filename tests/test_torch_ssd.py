"""The port's SSD scan (`kernels.ssd`) and Mamba2 block (`models.ssm`)
against the JAX reference.

On CPU tensors `kernels.ssd.ssd` takes its plain version (the chunked form,
the length padded with dt = 0 steps).  The JAX side runs under ``jax.jit``
on the same numpy-seeded inputs: its literal recurrence (``impl="scan"``),
its chunked oracle (``impl="xla"``) and the TPU kernel ``ssd_pallas`` in the
Pallas interpreter (``impl="pallas"``), at the shapes of the JAX package's
own SSD test.  The port against JAX's same form: within 1e-5 of the largest
|y| (and of the largest |state|).  The chunked form against the recurrence:
rtol = atol = 2e-3, the JAX package's own bound (``tests/test_kernels.py``).
The JAX side takes B and C per head; the port takes them per group and
indexes group ``h // (H / G)``, so a G = 2 case feeds JAX the repeated
groups.  The Mamba2 block at mamba2-1.3b's SMOKE config in float32: within
1e-5 of the largest output.

The card's bf16 kernel runs its chunk products on the tensor cores, which
take bf16 operands.  `_emulate` repeats its arithmetic in torch (64-row
chunks, the state transposed, G, the state and w o x each split into bf16
hi + lo, float32 sums) and is held against JAX's interpreted TPU kernel
and its chunked oracle at ``chip_smoke.py``'s bf16 gate: y within one
bf16 step of the largest |y|, the state within rtol = atol = 2e-3.  A
single bf16 rounding of w o x leaves that gate, and one of G or of the
state doubles y's error to its edge, which is why the kernel splits them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke as j_get_smoke
from repro.kernels.ssd import ref as j_ref
from repro.kernels.ssd import ssd as j_ssd
from repro.kernels.ssd import ssd_decode_step as j_decode_step
from repro.models import ssm as j_ssm
from repro.models.layers import init_from_plan as j_init_from_plan
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.kernels.ssd import kernel as TK
from repro_torch.kernels.ssd import ref, ssd, ssd_decode_step
from repro_torch.models import ssm

# (B, L, H, P, S, chunk): the JAX package's test_ssd_matches_scan shapes
# (L = 100 takes the padding path) and a ragged 300 over 64-row chunks
SHAPES = {"16": (1, 16, 2, 8, 4, 8), "64": (2, 64, 4, 16, 8, 16),
          "100": (1, 100, 2, 32, 16, 32), "300": (2, 300, 4, 16, 8, 64)}
SAME_FORM = 1e-5                     # port vs JAX, relative to the largest
CHUNK_VS_SCAN = dict(rtol=2e-3, atol=2e-3)


def _inputs(b, length, h, p, s, groups=None, seed=0):
    """numpy float32 x, dt, a and per-group B, C (G = H unless given)."""
    rng = np.random.default_rng(seed + 7 * length + h)
    g = h if groups is None else groups
    x = rng.standard_normal((b, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, length, h)))).astype(
        np.float32)
    a = (-np.exp(0.1 * rng.standard_normal(h))).astype(np.float32)
    bm = rng.standard_normal((b, length, g, s)).astype(np.float32)
    cm = rng.standard_normal((b, length, g, s)).astype(np.float32)
    return x, dt, a, bm, cm


def _per_head(t, h):
    return np.repeat(t, h // t.shape[2], axis=2)


def _torch(*arrays):
    return [torch.from_numpy(np.array(t)) for t in arrays]


@functools.lru_cache(maxsize=None)
def _jax_ssd(impl, chunk):
    return jax.jit(functools.partial(j_ssd, impl=impl, chunk=chunk,
                                     interpret=impl == "pallas"))


def _close(got, want, tol=SAME_FORM):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_scan_ref_matches_jax_scan(shape):
    b, length, h, p, s, chunk = SHAPES[shape]
    arrays = _inputs(b, length, h, p, s)
    jy, js = _jax_ssd("scan", chunk)(*map(jnp.asarray, arrays))
    ty, ts = ref.ssd_scan_ref(*_torch(*arrays))
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


@pytest.mark.parametrize("impl", ("xla", "pallas"))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ssd_matches_jax_chunked(shape, impl):
    """`ops.ssd` on CPU tensors (the chunked form, padded where L is not a
    multiple of the chunk) against the JAX chunked oracle and the Pallas
    kernel in the interpreter."""
    b, length, h, p, s, chunk = SHAPES[shape]
    arrays = _inputs(b, length, h, p, s)
    jy, js = _jax_ssd(impl, chunk)(*map(jnp.asarray, arrays))
    launches = TK.ssd_scan.launches
    ty, ts = ssd(*_torch(*arrays), chunk=chunk)
    assert TK.ssd_scan.launches == launches     # the CPU launches nothing
    assert ty.shape == (b, length, h, p) and ts.shape == (b, h, s, p)
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_chunked_matches_scan(shape):
    b, length, h, p, s, chunk = SHAPES[shape]
    args = _torch(*_inputs(b, length, h, p, s))
    y, st = ssd(*args, chunk=chunk)
    y_ref, st_ref = ref.ssd_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, **CHUNK_VS_SCAN)
    torch.testing.assert_close(st, st_ref, **CHUNK_VS_SCAN)


@pytest.mark.parametrize("impl", ("scan", "xla", "pallas"))
def test_groups_are_indexed_not_repeated(impl):
    """G = 2 groups over 8 heads at L = 100 (the padding path): the port's
    per-group B and C give what JAX gives on the repeated per-head ones."""
    b, length, h, p, s, chunk = 2, 100, 8, 16, 8, 32
    x, dt, a, bm, cm = _inputs(b, length, h, p, s, groups=2)
    jy, js = _jax_ssd(impl, chunk)(
        *map(jnp.asarray, (x, dt, a, _per_head(bm, h), _per_head(cm, h))))
    args = _torch(x, dt, a, bm, cm)
    ty, ts = (ref.ssd_scan_ref(*args) if impl == "scan"
              else ssd(*args, chunk=chunk))
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


@pytest.mark.parametrize("form", ("scan", "chunked"))
def test_initial_state_matches_jax(form):
    b, length, h, p, s, chunk = 2, 64, 4, 16, 8, 16
    arrays = _inputs(b, length, h, p, s)
    state0 = np.random.default_rng(3).standard_normal(
        (b, h, s, p)).astype(np.float32)
    if form == "scan":
        jfn = jax.jit(j_ref.ssd_scan_ref)
        tfn = ref.ssd_scan_ref
    else:
        jfn = jax.jit(functools.partial(j_ref.ssd_chunked_ref, chunk=chunk))
        tfn = functools.partial(ref.ssd_chunked_ref, chunk=chunk)
    jy, js = jfn(*map(jnp.asarray, arrays), jnp.asarray(state0))
    ty, ts = tfn(*_torch(*arrays), torch.from_numpy(state0))
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


@pytest.mark.parametrize("length", (1, 100, 300))
def test_final_state_does_not_depend_on_padding(length):
    """A ragged length padded to the chunk gives the recurrence's final
    state and outputs: dt = 0 steps are exact no-ops."""
    args = _torch(*_inputs(2, length, 4, 16, 8, groups=2))
    for chunk in (16, 64, 256):
        y, st = ssd(*args, chunk=chunk)
        y_ref, st_ref = ref.ssd_scan_ref(*args)
        assert y.shape == y_ref.shape
        torch.testing.assert_close(y, y_ref, **CHUNK_VS_SCAN)
        torch.testing.assert_close(st, st_ref, **CHUNK_VS_SCAN)


@pytest.mark.parametrize("groups", (1, 2))
def test_decode_step_matches_jax_in_place(groups):
    b, h, p, s = 2, 4, 8, 16
    rng = np.random.default_rng(11 + groups)
    state = rng.standard_normal((b, h, s, p)).astype(np.float32)
    x, dt, a, bm, cm = _inputs(b, 1, h, p, s, groups=groups, seed=groups)
    jst, jy = jax.jit(j_decode_step)(
        jnp.asarray(state), jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]),
        jnp.asarray(a), jnp.asarray(_per_head(bm, h)[:, 0]),
        jnp.asarray(_per_head(cm, h)[:, 0]))
    tstate = torch.from_numpy(state.copy())
    tx, tdt, ta, tb, tc = _torch(x, dt, a, bm, cm)
    got_state, ty = ssd_decode_step(tstate, tx[:, 0], tdt[:, 0], ta,
                                    tb[:, 0], tc[:, 0])
    assert got_state is tstate                    # written in place
    assert ty.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(tstate.numpy(), jst)


def test_decode_steps_reproduce_the_scan():
    """Token by token through `ssd_decode_step` from a zero state gives the
    full-sequence scan's outputs and final state."""
    b, length, h, p, s = 2, 12, 4, 8, 4
    x, dt, a, bm, cm = _torch(*_inputs(b, length, h, p, s, groups=2))
    y_ref, st_ref = ssd(x, dt, a, bm, cm, chunk=8)
    state = torch.zeros((b, h, s, p))
    ys = [ssd_decode_step(state, x[:, t], dt[:, t], a, bm[:, t],
                          cm[:, t])[1] for t in range(length)]
    torch.testing.assert_close(torch.stack(ys, 1), y_ref, **CHUNK_VS_SCAN)
    torch.testing.assert_close(state, st_ref, **CHUNK_VS_SCAN)


def test_wrapper_refuses_other_devices():
    args = [t.to("meta") for t in _torch(*_inputs(1, 8, 2, 8, 4))]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TK.ssd_scan(*args)


# ---- the Mamba2 block at mamba2-1.3b's SMOKE config, float32 ------------

def _block_params():
    """One layer's JAX parameters, with the zero/one-initialised vectors
    drawn from numpy so that every term of the block is exercised."""
    jcfg = j_get_smoke("mamba2-1.3b").with_(dtype="float32")
    params = dict(j_init_from_plan(j_ssm.plan(jcfg), jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    for k in ("a_log", "dt_bias", "conv_b", "norm", "out_norm", "d_skip"):
        base = 1.0 if k in ("norm", "out_norm", "d_skip") else 0.0
        params[k] = jnp.asarray(base + 0.3 * rng.standard_normal(
            params[k].shape), jnp.float32)
    tparams = {k: convert.tensor(np.asarray(v), "cpu")
               for k, v in params.items()}
    tcfg = get_smoke("mamba2-1.3b").with_(dtype="float32")
    return jcfg, tcfg, params, tparams


@pytest.mark.parametrize("length", (40, 2))
def test_ssm_apply_matches_jax(length):
    """Prefill through the block: output, final SSD state and the raw conv
    tail (L = 2 is shorter than the conv window)."""
    jcfg, tcfg, params, tparams = _block_params()
    x = np.random.default_rng(length).standard_normal(
        (2, length, tcfg.d_model)).astype(np.float32)
    jout, jst, jtail = jax.jit(
        lambda p, v: j_ssm.apply(p, v, jcfg, impl="xla"))(params,
                                                          jnp.asarray(x))
    tout, tst, ttail = ssm.apply(tparams, torch.from_numpy(x), tcfg)
    _close(tout.numpy(), jout)
    _close(tst.numpy(), jst)
    _close(ttail.numpy(), jtail)


def test_ssm_apply_bf16_matches_jax_bit_for_bit():
    """A bfloat16 block's prefill output equals the jitted JAX block's bit
    for bit: silu rounds after each of its ops (`layers.silu`) and the
    gate's product reaches the norm unrounded, as XLA compiles them.  With
    ``F.silu`` and a rounded product ~30% of the outputs differed by a
    bf16 step, and a 6-layer hybrid's logits by ~5% of the largest."""
    jcfg, tcfg, params, _ = _block_params()
    jcfg, tcfg = jcfg.with_(dtype="bfloat16"), tcfg.with_(dtype="bfloat16")
    params = {k: v if k in ("a_log", "dt_bias", "d_skip")
              else v.astype(jnp.bfloat16) for k, v in params.items()}
    tparams = {k: convert.tensor(np.asarray(v), "cpu")
               for k, v in params.items()}
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, 40, tcfg.d_model)), jnp.bfloat16)
    jout, jst, _ = jax.jit(lambda p, v: j_ssm.apply(p, v, jcfg, impl="xla"))(
        params, x)
    tout, tst, _ = ssm.apply(tparams, convert.tensor(np.asarray(x), "cpu"),
                             tcfg)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_array_equal(tout.float().numpy(),
                                  np.asarray(jout, np.float32))
    _close(tst.numpy(), jst)


def test_ssm_decode_step_matches_jax_in_place():
    jcfg, tcfg, params, tparams = _block_params()
    rng = np.random.default_rng(9)
    _, n_heads, d_xbc = ssm.dims(tcfg)
    s = tcfg.ssm
    st = rng.standard_normal((2, n_heads, s.state, s.head_dim)).astype(
        np.float32)
    cv = rng.standard_normal((2, s.conv_width - 1, d_xbc)).astype(
        np.float32)
    jstep = jax.jit(lambda p, v, a, c: j_ssm.decode_step(p, v, a, c, jcfg))
    tst, tcv = torch.from_numpy(st.copy()), torch.from_numpy(cv.copy())
    for t in range(3):
        x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jout, st, cv = jstep(params, jnp.asarray(x), jnp.asarray(st),
                             jnp.asarray(cv))
        tout, got_st, got_cv = ssm.decode_step(tparams, torch.from_numpy(x),
                                               tst, tcv, tcfg)
        assert got_st is tst and got_cv is tcv     # written in place
        _close(tout.numpy(), jout)
        _close(tst.numpy(), st)
        _close(tcv.numpy(), cv)


def test_plans_match_jax():
    """The block's and the cache's plans have the JAX package's leaves."""
    jcfg, tcfg = j_get_smoke("mamba2-1.3b"), get_smoke("mamba2-1.3b")
    jplan = j_ssm.plan(jcfg, stack=3)
    tplan = ssm.plan(tcfg, stack=3)
    assert set(jplan) == set(tplan)
    for k, d in tplan.items():
        assert tuple(d.shape) == tuple(jplan[k].shape), k
        assert d.dtype == jplan[k].dtype and d.init == jplan[k].init, k
    jc, tc = j_ssm.plan_cache(jcfg, 2, 3), ssm.plan_cache(tcfg, 2, 3)
    for k in ("ssm", "conv"):
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        assert tc[k].dtype == jc[k].dtype
    assert dataclasses.asdict(tcfg.ssm) == dataclasses.asdict(jcfg.ssm)


# ---- the bf16 kernel's arithmetic (csrc/ssd.cu ssd_wgmma_kernel) --------

# (B, L, H, P, S, G): the model's head and the smoke config's, over a
# ragged 300; a = -8 makes the decay underflow inside a 64-row chunk
EMULATED = {"model": (2, 300, 4, 64, 128, 1), "smoke": (2, 300, 4, 16, 16, 1)}
UNDERFLOW = (-0.3, -1.0, -3.0, -8.0)
BF16_GATE = dict(rtol=2e-3, atol=2e-3)       # the state; y: one bf16 step


def _hi_lo(v, split=True):
    """v as bf16 hi + lo (or hi alone), each back in float32."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float() if split else torch.zeros_like(v)


def _emulate(x, dt, a, bmat, c, *, single=(), chunk=64):
    """The bf16 kernel's arithmetic in torch, per 64-row chunk (the ragged
    tail padded with zeros and dt = 0): lg = a cumsum(dt); C B^T of the
    bf16 inputs in float32; G = C B^T o 2^(lg_t log2(e) - lg_z log2(e)) o
    dt_z for z <= t; y^T = exp(lg_t) (state^T C^T) + x^T G^T and the transposed
    state's update exp(lg_end) state^T + (w o x)^T B, where G, the state
    and w o x enter as bf16 hi + lo (``single`` names those rounded once
    instead), every product summed in float32; y rounded once to bf16."""
    b, length, h, p = x.shape
    s = bmat.shape[-1]
    pad = (-length) % chunk

    def per_head(t):                         # (B, L, *, n) -> (B, H, L', n)
        return F.pad(ref.heads(t, h).float(), (0, 0, 0, 0, 0, pad)
                     ).permute(0, 2, 1, 3)
    xf, bf, cf = per_head(x), per_head(bmat), per_head(c)
    dtf = F.pad(dt, (0, 0, 0, pad)).permute(0, 2, 1)
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    st = torch.zeros(b, h, p, s)
    ys = []
    for t0 in range(0, length + pad, chunk):
        xs, dts, bs, cs = (t[:, :, t0:t0 + chunk] for t in (xf, dtf, bf, cf))
        lg = a[:, None] * torch.cumsum(dts, -1)
        lend = lg[..., -1:]
        lg2 = lg * np.float32(np.log2(np.e))
        diff = torch.where(tri, lg2[..., :, None] - lg2[..., None, :], 0.0)
        g = torch.where(tri, (cs @ bs.transpose(-1, -2)) * torch.exp2(diff)
                        * dts[..., None, :], 0.0)
        ghi, glo = _hi_lo(g, "g" not in single)
        shi, slo = _hi_lo(st, "state" not in single)
        ct, xt = cs.transpose(-1, -2), xs.transpose(-1, -2)
        yt = (shi @ ct + slo @ ct) * torch.exp(lg)[..., None, :]
        yt = yt + xt @ ghi.transpose(-1, -2) + xt @ glo.transpose(-1, -2)
        ys.append(yt.transpose(-1, -2))
        whi, wlo = _hi_lo(xs * (torch.exp(lend - lg) * dts)[..., None],
                          "wx" not in single)
        st = (st * torch.exp(lend)[..., None] + whi.transpose(-1, -2) @ bs
              + wlo.transpose(-1, -2) @ bs)
    y = torch.cat(ys, 2)[:, :, :length].permute(0, 2, 1, 3)
    return y.bfloat16(), st.transpose(-1, -2)


def _bf16_inputs(b, length, h, p, s, g, a, seed=0):
    """numpy-seeded x, B, C in bf16 (JAX's per head, the port's per
    group), dt and a float32."""
    x, dt, _, bm, cm = _inputs(b, length, h, p, s, groups=g, seed=seed)
    a = np.asarray(a, np.float32)
    jargs = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a),
             jnp.asarray(_per_head(bm, h), jnp.bfloat16),
             jnp.asarray(_per_head(cm, h), jnp.bfloat16)]
    targs = [torch.from_numpy(x).bfloat16(), torch.from_numpy(dt),
             torch.from_numpy(a), torch.from_numpy(bm).bfloat16(),
             torch.from_numpy(cm).bfloat16()]
    return jargs, targs


def _bf16_step(t):
    """One bfloat16 step at the largest |t|."""
    return 2.0 ** (np.floor(np.log2(np.abs(t).max())) - 7)


def _gate_errors(got, want):
    """(y's largest error in bf16 steps of the largest |y|, the share of
    state elements outside rtol = atol = 2e-3)."""
    (y, st), (wy, wst) = got, want
    wy, wst = np.asarray(wy, np.float32), np.asarray(wst, np.float32)
    assert y.shape == wy.shape and st.shape == wst.shape
    y_steps = np.abs(y.float().numpy() - wy).max() / _bf16_step(wy)
    outside = ~np.isclose(st.numpy(), wst, **BF16_GATE)
    return y_steps, outside.mean()


@pytest.mark.parametrize("impl", ("pallas", "xla"))
@pytest.mark.parametrize("head", sorted(EMULATED))
def test_bf16_kernel_emulation_matches_jax(head, impl):
    """The split arithmetic against JAX's TPU kernel in the interpreter and
    its chunked oracle, at the kernel's gate."""
    b, length, h, p, s, g = EMULATED[head]
    jargs, targs = _bf16_inputs(b, length, h, p, s, g, UNDERFLOW)
    # the last head's decay reaches 0 in float32 inside the first chunk
    first = np.cumsum(np.asarray(jargs[1])[:, :64, -1], axis=1)
    assert (np.exp(np.float32(UNDERFLOW[-1]) * first) == 0).any()
    y_steps, outside = _gate_errors(_emulate(*targs),
                                    _jax_ssd(impl, 64)(*jargs))
    assert y_steps <= 1.0 and outside == 0.0, (y_steps, outside)


def test_single_bf16_rounding_leaves_the_gate():
    """Why the kernel splits: with w o x rounded once to bf16 the state
    leaves rtol = atol = 2e-3, and with G or the state rounded once y's
    largest error doubles to the gate's edge of one bf16 step; slow decays
    carry the state across chunks."""
    b, length, h, p, s, g = EMULATED["model"]
    jargs, targs = _bf16_inputs(b, length, h, p, s, g,
                                (-0.01, -0.02, -0.05, -0.1), seed=1)
    want = _jax_ssd("pallas", 64)(*jargs)
    split_y, split_out = _gate_errors(_emulate(*targs), want)
    assert split_y <= 0.5 and split_out == 0.0, (split_y, split_out)
    _, outside = _gate_errors(_emulate(*targs, single=("wx",)), want)
    assert outside > 1e-2, outside
    for single in ("g", "state"):
        y_steps, _ = _gate_errors(_emulate(*targs, single=(single,)), want)
        assert y_steps >= 2 * split_y, (single, y_steps, split_y)


def test_bf16_kernel_copy_route_and_shared_memory():
    """Views TMA can read (16-byte aligned bases and strides, as the
    packed projection gives) take the TMA route, others cp.async; the
    wrapper's shared-memory counts are the C launcher's."""
    h, p, g, s = 4, 64, 1, 128
    packed = torch.zeros(2, 10, h * p + 2 * g * s + 8, dtype=torch.bfloat16)
    x = packed[..., :h * p].unflatten(-1, (h, p))
    bm = packed[..., h * p:h * p + g * s].unflatten(-1, (g, s))
    cm = packed[..., h * p + g * s:h * p + 2 * g * s].unflatten(-1, (g, s))
    assert TK.copy_route(x, bm, cm) == "tma"
    shifted = packed[..., 1:1 + h * p].unflatten(-1, (h, p))   # base + 2 B
    assert TK.copy_route(shifted, bm, cm) == "cp.async"
    odd = torch.zeros(2, 10, h * 36, dtype=torch.bfloat16).unflatten(
        -1, (h, 36))                                           # 72-byte heads
    assert TK.copy_route(odd, bm, cm) == "cp.async"
    assert TK.SMEM_BYTES == {torch.float32: 115456, torch.bfloat16: 110096}
