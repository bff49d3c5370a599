"""The flight recorder kernel's plan and arithmetic on the CPU
(``csrc/recorder.cu``, laid out by `obs.recorder.recorder_plan`).

The kernel runs only on the card (``tests/test_torch_cuda.py``); here:

* the plan at the fleet's 8-128-8 (B = 4096), the LM adapter's one 128 x
  128 and 512 x 512 layer (B = 8 and 4), the card test's 8-48-24-8
  (B = 37) and a layer whose rows break the copy engine's 16-byte rules,
  in float32, bfloat16 and int8: its CTAs copy in every byte of every
  layer exactly once, every slot lies in one tile or one cluster, and each
  span fits its region of a stage;
* a torch emulation of the kernel's float32 sum order (a lane's 16-byte
  words, or elements on the cp.async route, into four accumulators; a
  butterfly across the warp; on the cluster route the warps in warp order
  and the ranks in rank order) against `network_weight_norm` and jitted
  JAX ``repro.obs.recorder.network_weight_norm`` within rtol 1e-6;
* the int8 path's 32-bit arithmetic emulated byte for byte (a signed dp4a
  of each 4-byte word with a +-1 multiplier picked by its bytes' signs, a
  warp's lanes added in 32 bits, warps and ranks in 64), bit for bit the
  plain version on weights that include -128.
"""
import types

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.obs import recorder as JR
from repro_torch.obs import recorder as TR

SMS = 132
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}
# name: (B, layer sizes)
SHAPES = {"fleet": (4096, (8, 128, 8)),
          "adapter-128-b8": (8, (128, 128)),
          "adapter-128-b4": (4, (128, 128)),
          "adapter-512-b8": (8, (512, 512)),
          "adapter-512-b4": (4, (512, 512)),
          "8-48-24-8": (37, (8, 48, 24, 8)),
          "cp-async": (600, (8, 5, 3))}


def _nms(sizes):
    return [sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1)]


def _spans(plan, b, nms, e):
    """What each CTA of the plan's launch copies in, as the kernel reads
    the plan: ``(cta, layer, first byte, bytes)`` a span, counted from the
    layer's base.  Tiles: CTA t % ctas takes tile t, slots [t k, t k + k)
    of every layer; clusters: CTA slot * c + r takes elements [r share,
    r share + share) of the slot's layer."""
    out = []
    if plan["route"] == "tiles":
        k = plan["slots"]
        for t in range(plan["tiles"]):
            for l, nm in enumerate(nms):
                out.append((t % plan["ctas"], l, t * k * nm * e,
                            min(k, b - t * k) * nm * e))
        return out
    c = plan["cluster"]
    for slot in range(b):
        for r in range(c):
            for l, (nm, share) in enumerate(zip(nms, plan["shares"])):
                lo = min(nm, r * share)
                if min(nm - lo, share):
                    out.append((slot * c + r, l, (slot * nm + lo) * e,
                                min(nm - lo, share) * e))
    return out


def _regions(plan):
    """Bytes of each layer's region in a stage."""
    offs = list(plan["offsets"]) + [plan["stage_bytes"]]
    return [offs[i + 1] - offs[i] for i in range(len(plan["offsets"]))]


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("shape", tuple(SHAPES))
def test_recorder_plan_covers_every_slot_and_byte_once(shape, dtype):
    b, sizes = SHAPES[shape]
    dt = DTYPES[dtype]
    e = torch.empty((), dtype=dt).element_size()
    nms = _nms(sizes)
    plan = TR.recorder_plan(b, nms, dt, SMS)
    spans = _spans(plan, b, nms, e)
    regions = _regions(plan)
    assert plan["smem"] <= TR.REC_SMEM_MAX and plan["threads"] == 256
    assert all(0 <= cta < plan["ctas"] for cta, *_ in spans)
    for l, nm in enumerate(nms):
        mine = sorted((first, n) for _, ll, first, n in spans if ll == l)
        at = 0
        for first, n in mine:
            assert first == at and n > 0
            at += n
        assert at == b * nm * e
        # a span and its cp.async word offset fit the layer's region
        assert max(n for _, n in mine) + 3 <= regions[l]
        assert plan["loads"][l] == ("bulk" if nm * e % 16 == 0
                                    else "cp_async")
    if plan["route"] == "tiles":
        k = plan["slots"]
        assert plan["cluster"] == 1 and plan["tiles"] == -(-b // k)
        # every slot in one tile; a CTA's slots within its 64 detector
        # threads' groups of four
        assert -(-plan["tiles"] // plan["ctas"]) * k <= TR.REC_MAX_TILE
        per_slot = sum(nms) * e
        assert k * per_slot <= TR.REC_STAGE_TARGET or k == 1
    else:
        c = plan["cluster"]
        assert 2 <= c <= TR.REC_MAX_CLUSTER and plan["ctas"] == b * c
        assert plan["stages"] == 1
        for slot in range(b):         # a slot's ranks are its cluster's
            ctas = {cta for cta, l, first, n in spans
                    if first // (nms[l] * e) == slot}
            assert ctas <= set(range(slot * c, slot * c + c))
    if dt == torch.int8:              # no lane or warp partial overflows
        assert 128 * plan["stage_bytes"] < 2 ** 31


def test_recorder_plan_at_the_fleet_and_the_adapter():
    """The launches the card runs: the fleet's tiles (float32 through two
    stages on a persistent grid, three CTAs an SM), the adapter's slots on
    clusters of eight."""
    fleet = [1024, 1024]
    got = {d: TR.recorder_plan(4096, fleet, dt, SMS)
           for d, dt in DTYPES.items()}
    pick = ("route", "slots", "tiles", "stages", "ctas", "stage_bytes")
    assert {d: tuple(p[k] for k in pick) for d, p in got.items()} == {
        "float32": ("tiles", 4, 1024, 2, 396, 2 * 16400),
        "bfloat16": ("tiles", 8, 512, 1, 512, 2 * 16400),
        "int8": ("tiles", 16, 256, 1, 256, 2 * 16400)}
    for n, dt, share in ((128, torch.float32, 2048), (512, torch.float32,
                                                      32768),
                         (512, torch.int8, 32768)):
        p = TR.recorder_plan(8, [n * n], dt, SMS)
        assert (p["route"], p["cluster"], p["ctas"], p["shares"]) == (
            "cluster", 8, 64, (share,))
    # a base off 16 bytes takes the cp.async words
    p = TR.recorder_plan(4096, fleet, torch.float32, SMS,
                         aligned=(True, False))
    assert p["loads"] == ("bulk", "cp_async") and p["words"] == 2


@pytest.mark.parametrize("b, nms, dt", [
    (8, [1] * 9, torch.float32),              # more layers than the kernel
    (8, [2048 * 2048], torch.float32),        # a slot over 8 CTAs' memory
    (0, [64], torch.float32),
    (8, [64], torch.float16)])
def test_recorder_plan_refuses(b, nms, dt):
    with pytest.raises(ValueError):
        TR.recorder_plan(b, nms, dt, SMS)


# ---- the float32 sum order ---------------------------------------------------


def _lane_partials(x, lanes, vec):
    """(R, lanes) partials of R runs of |w| (R, count) float32: lane i adds
    its j-th word of `vec` elements (words i, i + lanes, ...) into
    accumulator j % 4, each word's elements in order; then (a0 + a1) +
    (a2 + a3).  Zero padding adds nothing to a float sum."""
    r, count = x.shape
    rounds = max(1, -(-count // (lanes * vec)))
    x = F.pad(x, (0, rounds * lanes * vec - count)).view(r, rounds, lanes,
                                                         vec)
    acc = torch.zeros(4, r, lanes)
    for j in range(rounds):
        for v in range(vec):
            acc[j % 4] = acc[j % 4] + x[:, j, :, v]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _butterfly(p):
    """A warp's xor butterfly over the last axis (32 lanes)."""
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., torch.arange(32) ^ o]
    return p[..., 0]


def _emulated_sums(plan, w, l):
    """(B,) float32 sum of |w| of layer l, in the kernel's order."""
    b, nm = w.shape[0], w.shape[1] * w.shape[2]
    x = w.reshape(b, nm).to(torch.float32).abs()
    vec = 16 // w.element_size() if plan["loads"][l] == "bulk" else 1
    if plan["route"] == "tiles":      # a warp a (slot, layer)
        return _butterfly(_lane_partials(x, 32, vec))
    share, tot = plan["shares"][l], None
    for r in range(plan["cluster"]):  # a CTA's 256 threads, its warps in
        lo = min(nm, r * share)       # order, the ranks in order
        part = _lane_partials(x[:, lo:lo + share], 256, vec)
        warps = _butterfly(part.view(b, 8, 32))
        s = warps[:, 0]
        for k in range(1, 8):
            s = s + warps[:, k]
        tot = s if tot is None else tot + s
    return tot


def _emulated_norm(plan, ws):
    tot = None
    for l, w in enumerate(ws):
        nm = w.shape[1] * w.shape[2]
        m = _emulated_sums(plan, w, l) / torch.tensor(float(nm))
        tot = m if tot is None else tot + m
    return tot


@pytest.mark.parametrize("shape, dtype", [
    ("fleet", "float32"), ("fleet", "bfloat16"),
    ("adapter-128-b8", "float32"), ("adapter-512-b4", "float32"),
    ("8-48-24-8", "float32"), ("8-48-24-8", "bfloat16"),
    ("cp-async", "float32")])
def test_float_sum_order_matches_plain_and_jax(shape, dtype):
    """The kernel's order of the weight norm's float32 sums, emulated,
    within rtol 1e-6 of the plain version and of jitted JAX (which sum in
    their own orders)."""
    b, sizes = SHAPES[shape]
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(5)
    ws = tuple(torch.randn(b, sizes[i], sizes[i + 1], generator=g).to(dt)
               for i in range(len(sizes) - 1))
    plan = TR.recorder_plan(b, [w.shape[1] * w.shape[2] for w in ws], dt,
                            SMS)
    got = _emulated_norm(plan, ws)
    plain = TR.network_weight_norm(types.SimpleNamespace(w=ws), False)
    jw = tuple(w.to(torch.float32).numpy() for w in ws)
    want = np.asarray(jax.jit(lambda w: JR.network_weight_norm(
        types.SimpleNamespace(w=w, w_scale=()), False))(jw))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---- int8 in 32 bits ---------------------------------------------------------


def _dp4a_abs(words):
    """Per 4-byte word (uint32, little-endian), the kernel's signed dp4a of
    its bytes with the multiplier 0x01010101 | (((q >> 7) & 0x01010101) *
    0xfe): +1 for a byte >= 0, -1 (0xff) for one below."""
    words = words.astype(np.uint32)
    neg = (words >> np.uint32(7)) & np.uint32(0x01010101)
    mult = (np.uint32(0x01010101) | (neg * np.uint32(0xFE))).astype(np.uint32)
    qb = words.view(np.uint8).reshape(*words.shape, 4).view(np.int8)
    mb = mult.view(np.uint8).reshape(*mult.shape, 4).view(np.int8)
    return (qb.astype(np.int32) * mb.astype(np.int32)).sum(-1)


def _emulated_q_sums(plan, w, l):
    """(B,) uint64 sums of |w| of an int8 layer in the kernel's arithmetic,
    and the largest lane and warp partials it forms."""
    b, nm = w.shape[0], w.shape[1] * w.shape[2]
    q = w.reshape(b, nm).numpy()
    vec = plan["loads"][l] == "bulk"
    lanes = 32 if plan["route"] == "tiles" else 256
    runs = ([(0, nm)] if plan["route"] == "tiles" else
            [(min(nm, r * plan["shares"][l]),
              min(nm, min(nm, r * plan["shares"][l]) + plan["shares"][l]))
             for r in range(plan["cluster"])])
    tot = np.zeros(b, np.uint64)
    big_lane = big_warp = 0
    for lo, hi in runs:
        x = q[:, lo:hi]
        if vec:                     # 16-byte words: four dp4a each
            x = np.ascontiguousarray(x).view(np.uint32)
            terms = _dp4a_abs(x).reshape(b, -1, 4).sum(-1)
        else:                       # element by element
            terms = np.abs(x.astype(np.int32))
        n = terms.shape[1]
        pad = -(-n // lanes) * lanes - n
        lane = np.pad(terms, ((0, 0), (0, pad))).reshape(b, -1, lanes) \
            .sum(1, dtype=np.int64)
        assert lane.max() < 2 ** 31
        warp = lane.reshape(b, -1, 32).sum(-1)
        assert warp.max() < 2 ** 32
        big_lane, big_warp = max(big_lane, lane.max()), max(big_warp,
                                                             warp.max())
        tot += warp.sum(-1).astype(np.uint64)
    return tot, big_lane, big_warp


@pytest.mark.parametrize("shape", ("fleet", "adapter-512-b4", "cp-async"))
def test_int8_partials_are_exact_in_32_bits(shape):
    """-128 counts 128 in the dp4a form; the 32-bit lane and warp partials
    add to the exact sum of |w|, and the norm from them (float(sum) / N M
    * scale, the layers in order) equals the plain version's bit for bit.
    The adapter's weights keep a slot's sum under 2^24, where the plain
    version's float32 sum is exact."""
    b, sizes = SHAPES[shape]
    rng = np.random.default_rng(9)
    lo, hi = (-40, 41) if shape.startswith("adapter") else (-128, 128)
    ws = []
    for i in range(len(sizes) - 1):
        w = rng.integers(lo, hi, (b, sizes[i], sizes[i + 1])).astype(np.int8)
        w.reshape(b, -1)[:, ::7] = -128
        ws.append(torch.from_numpy(w))
    scales = tuple(torch.from_numpy(rng.uniform(0.01, 0.1, b)
                                    .astype(np.float32)) for _ in ws)
    plan = TR.recorder_plan(b, [w.shape[1] * w.shape[2] for w in ws],
                            torch.int8, SMS)
    tot = None
    for l, w in enumerate(ws):
        sums, big_lane, _ = _emulated_q_sums(plan, w, l)
        exact = np.abs(w.numpy().reshape(b, -1).astype(np.int64)).sum(-1)
        assert np.array_equal(sums.astype(np.int64), exact)
        assert big_lane > 0
        nm = w.shape[1] * w.shape[2]
        m = torch.from_numpy(sums.astype(np.float64)).to(torch.float32) \
            / torch.tensor(float(nm)) * scales[l]
        tot = m if tot is None else tot + m
    plain = TR.network_weight_norm(
        types.SimpleNamespace(w=tuple(ws), w_scale=scales), True)
    assert torch.equal(tot, plain)
