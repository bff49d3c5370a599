"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and ``nvcc``, and skips elsewhere.  The
file imports neither JAX nor the JAX package (the plain versions are held
against JAX by the other ``test_torch_*`` files on the CPU), so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

int8 is held bit for bit; float32 within rtol = atol = 1e-5 (the kernels sum
the psum in fan-in order, the plain versions as a batched product).  The
attention kernel's bfloat16 output within rtol 2e-2, atol 2e-3: the kernel
multiplies on the tensor cores, Q K^T exactly in float32 and P V as two bf16
products P_hi V + P_lo V (P_hi = bf16(P), P_lo = bf16(P - P_hi)) summed in
float32, so P keeps ~16 bits where the plain version's float32 P V keeps 24;
both round the output to bf16 once.  The SSD scan walks the sequence
in other sub-blocks than the plain chunked form, so float32 is held within
rtol = atol = 2e-3 (the JAX package's bound between its chunked form and
the recurrence) and bfloat16 y within one bf16 step of the largest |y|;
its bf16 kernel multiplies on the tensor cores with G, the state and
w o x split into bf16 hi + lo (tests/test_torch_ssd.py emulates it).
The bfloat16 plasticity kernels compute in float32 and round each output
once, as their plain versions do: steps and one-step windows within 3e-2
(the JAX package's own bf16 tolerance, tests/test_fleet.py), longer
windows with at most 1e-3 of the elements outside it.  The attention
backward kernel and silu's backward are held like their forwards: float32
within 1e-5 of each gradient's largest |x| (sums in another order), bf16
within rtol 2e-2 / atol 2e-3, silu's bit for bit; the SSD scan's backward
float32 within 1e-5 of each gradient's largest |x|, its bf16 dx, dB, dC
within one bf16 step of the largest (a float32 sum rounded once).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as TE
from repro_torch.kernels.lif import kernel as TL
from repro_torch.kernels.plasticity import fused as TF
from repro_torch.kernels.plasticity import ref as TR
from repro_torch.kernels.plasticity import kernel as TK
from repro_torch.kernels.plasticity import quant as TQ

B = 6
ACTIVE = np.array([1, 0, 1, 1, 0, 1], np.int32)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _on(dev, **arrays):
    return {k: None if v is None else torch.from_numpy(np.array(v)).to(dev)
            for k, v in arrays.items()}


def _assert_match(got, want, quant):
    for a, b in zip(got, want):
        if quant:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# (B, N, M, spiking, teach, active): M = 200 is not a multiple of 128; the
# LM adapter's 128 x 128 at B = 4 takes 16 warps a stream and its rule
# through L2
STEP_CASES = [(B, 6, 2, True, None, False), (B, 8, 128, True, None, True),
              (B, 16, 200, True, "per-stream", False),
              (B, 128, 8, False, None, True),
              (B, 12, 5, False, "shared", True),
              (4, 128, 128, True, "per-stream", True)]


def _step_inputs(rng, b, n, m, quant, dev, teach=None):
    """One fleet step's state and rule: int8 with per-slot scales (1/32 and
    1/16; beyond B streams every third 0.03, no power of two) and seeds;
    float32 with uniform weights."""
    tshape = {"per-stream": (b, m), "shared": (m,)}.get(teach)
    if quant:
        pick = np.arange(b)
        return _on(dev,
                   x=rng.choice([0, 256], (b, n)).astype(np.int32),
                   w=rng.integers(-127, 128, (b, n, m)).astype(np.int8),
                   v=rng.integers(-600, 600, (b, m)).astype(np.int32),
                   tpre=rng.integers(0, 1200, (b, n)).astype(np.int32),
                   tpost=rng.integers(-300, 1200, (b, m)).astype(np.int32),
                   scale=np.where((pick % 3 == 0) & (b > B), 0.03,
                                  np.where(pick % 2 == 0, 1 / 32, 1 / 16))
                   .astype(np.float32),
                   seed=rng.integers(-2 ** 31, 2 ** 31, b).astype(np.int32),
                   teach=None if tshape is None else rng.integers(
                       -300, 300, tshape).astype(np.int32),
                   theta=(rng.standard_normal((4, n, m)) * 0.02
                          ).astype(np.float32))
    return _on(dev,
               x=(rng.random((b, n)) < 0.4).astype(np.float32),
               w=rng.uniform(-1, 1, (b, n, m)).astype(np.float32),
               v=rng.standard_normal((b, m)).astype(np.float32),
               tpre=(rng.random((b, n)) * 3).astype(np.float32),
               tpost=(rng.random((b, m)) * 3).astype(np.float32),
               teach=None if tshape is None else (
                   rng.standard_normal(tshape) * 0.5).astype(np.float32),
               theta=(rng.standard_normal((4, n, m)) * 0.02
                      ).astype(np.float32))


def _step_call(t, quant, **kw):
    """The kernel's and the plain version's outputs on the inputs ``t``."""
    if quant:
        args = (t["x"], t["w"], t["scale"], t["theta"], t["v"], t["tpre"],
                t["tpost"])
        kw.update(qcfg=TQ.QuantConfig(), seed=t["seed"])
        return TK.fleet_step_q(*args, **kw), TK.fleet_step_q_plain(*args,
                                                                    **kw)
    args = (t["x"], t["w"], t["theta"], t["v"], t["tpre"], t["tpost"])
    return TK.fleet_step(*args, **kw), TK.fleet_step_plain(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_fleet_step_kernels_match_plain_on_card(quant, cuda_device):
    rng = np.random.default_rng(11)
    wrapper = TK.fleet_step_q if quant else TK.fleet_step
    launches = wrapper.launches
    for b, n, m, spiking, teach, masked in STEP_CASES:
        t = _step_inputs(rng, b, n, m, quant, cuda_device, teach)
        active = (torch.from_numpy(_active(b)).to(cuda_device) if masked
                  else None)
        got, want = _step_call(t, quant, spiking=spiking, teach=t["teach"],
                               active=active)
        torch.cuda.synchronize()
        _assert_match(got, want, quant)
        if masked:
            off = active == 0
            assert torch.equal(got[3][off], t["w"][off])
    assert wrapper.launches == launches + len(STEP_CASES)


# Fleets whose streams the persistent grid walks: 2117 streams at 8->48 in
# one wave of 17-stream tiles, the last ragged (2117 = 124 * 17 + 9); 600
# streams of the adapter's 128 x 128, double-buffered, more than the grid
# holds at once.  int8 with every third scale 0.03 (divided by, not
# multiplied with a reciprocal).
WALK_STEPS = ((2117, 8, 48, True), (600, 128, 128, False))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("float32", "int8", "bfloat16"))
def test_fleet_step_kernels_walk_the_fleet_on_card(mode, cuda_device):
    """#1 and #2 over fleets larger than a tile of the grid, telemetry off
    and on, a slot mask and a teaching current: int8 bit for bit, float32
    within 1e-5, bf16 within 3e-2; state of the telemetry launch equal to
    the telemetry-off launch's; vacant slots frozen with zero rows."""
    rng = np.random.default_rng(12)
    quant = mode == "int8"
    for b, n, m, spiking in WALK_STEPS:
        t = _step_inputs(rng, b, n, m, quant, cuda_device, "per-stream")
        if mode == "bfloat16":
            t = {k: None if a is None else a.to(torch.bfloat16)
                 for k, a in t.items()}
        plan = TK.fleet_step_launch(
            cuda_device, b, n, m, True, kind=mode,
            theta_bf16=mode == "bfloat16")
        if n == 8:
            assert plan["buffers"] == "single" and b % plan["tile"], plan
        else:
            assert plan["buffers"] == "double", plan
            assert plan["ctas"] * plan["tile"] < b, plan
        active = torch.from_numpy(_active(b)).to(cuda_device)
        kw = dict(spiking=spiking, teach=t["teach"], active=active)
        off, want = _step_call(t, quant, **kw)
        got, want_tel = _step_call(t, quant, telemetry=True, **kw)
        torch.cuda.synchronize()
        if mode == "bfloat16":
            _assert_bf16(off, want)
        else:
            _assert_match(off, want, quant)
        for a, c in zip(got[:4], off):
            assert torch.equal(a, c)
        vacant = active == 0
        assert torch.equal(got[3][vacant], t["w"][vacant])
        assert (got[4][vacant] == 0).all()
        if quant:
            assert torch.equal(got[4], want_tel[4])


def _network(rng, sizes, quant, dev, b=B):
    """A random fleet state of ``b`` streams; int8 windows start 9 steps
    before the int32 wrap of the step counter, so seed + k wraps inside
    K = 16.  Beyond B streams every third int8 scale is 0.03, no power of
    two (the kernel divides by it; by 1/32 and 1/16 it multiplies)."""
    n_layers = len(sizes) - 1
    if quant:
        w = [rng.integers(-40, 41, (b, sizes[i], sizes[i + 1]))
             .astype(np.int8) for i in range(n_layers)]
        v = [rng.integers(-300, 300, (b, m)).astype(np.int32)
             for m in sizes[1:]]
        tr = [rng.integers(0, 900, (b, n)).astype(np.int32) for n in sizes]
        pick = np.arange(b)
        sc = [np.where((pick % 3 == 0) & (b > B), 0.03,
                       np.where(pick % 2 == 0, 1 / 32, 1 / 16))
              .astype(np.float32) for _ in range(n_layers)]
        t0 = 2 ** 31 - 9
    else:
        w = [np.round(rng.uniform(-0.5, 0.5, (b, sizes[i], sizes[i + 1]))
                      * 64).astype(np.float32) / 64 for i in range(n_layers)]
        v = [rng.uniform(-0.5, 0.9, (b, m)).astype(np.float32)
             for m in sizes[1:]]
        tr = [rng.uniform(0, 2, (b, n)).astype(np.float32) for n in sizes]
        sc, t0 = [], 0
    tup = lambda xs: tuple(torch.from_numpy(x).to(dev) for x in xs)
    return TE.NetworkState(w=tup(w), v=tup(v), trace=tup(tr),
                           t=torch.tensor(t0, dtype=torch.int32, device=dev),
                           w_scale=tup(sc))


# A three-layer net whose window walks more tiles than the persistent grid
# holds at once (132 SMs x 1-2 CTAs x 8 streams < 2117), the last one
# ragged (2117 = 264 * 8 + 5).  int8 runs K = 16, across the step counter's
# wrap; float32 K = 1, where its psums are exact and every value is held
# (one spike flipped by a last-bit psum difference somewhere among the
# 2117 streams would move a longer window's telemetry row by > 2e-4).
WALK_SIZES, WALK_B = (8, 48, 24, 8), 2117
WALK_K = {False: 1, True: 16}


def _active(b):
    """The slot mask: `ACTIVE` for B streams, else every fifth slot off."""
    return ACTIVE if b == B else (np.arange(b) % 5 != 2).astype(np.int32)


def _assert_walks(sizes, b, quant, dev, bf16=False):
    """The fleet kernel's grid holds fewer than ``b`` streams at once."""
    plan = TF.fleet_launch(dev, sizes, b, 8, [True] * (len(sizes) - 1),
                           quant=quant, bf16=bf16, theta_bf16=bf16)
    assert plan["ctas"] * plan["tile"] < b and b % plan["tile"], plan


# Tiles of 20 streams at 8-128-8: one warp a stream (more groups than
# named barriers), and in float32 and bf16 one state buffer a stream, the
# float32 rule read through L2 (the routes the plan takes where shared
# memory runs short).
LONE_B = 20


def _assert_lone(sizes, b, quant, bf16, dev):
    plan = TF.fleet_launch(dev, sizes, b, LONE_B, [True] * (len(sizes) - 1),
                           quant=quant, bf16=bf16, theta_bf16=bf16)
    assert plan["warps"] == 1, plan
    if not quant:
        assert plan["buffers"] == "single", plan
        assert plan["theta"] == ("smem" if bf16 else "l2"), plan


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_rollout_kernel_matches_plain_on_card(quant, cuda_device):
    """int8 bitwise at every K (the step counter wraps inside the window),
    float32 within 1e-5 at K = 1; the fleet kernel's routes: more tiles
    than its grid holds (`WALK_SIZES`), tiles of `LONE_B` streams."""
    rng = np.random.default_rng(21)
    qc = TQ.QuantConfig() if quant else None
    for k, sizes, teach, b, bb in ((1, (8, 32, 4), "per-step", B, 8),
                                   (4, (6, 4), "held", B, 8),
                                   (16, (8, 32, 4), None, B, 8),
                                   (WALK_K[quant], WALK_SIZES, "per-step",
                                    WALK_B, 8),
                                   (WALK_K[quant], (8, 128, 8), "held",
                                    WALK_B, LONE_B)):
        st = _network(rng, sizes, quant, cuda_device, b)
        theta = [torch.from_numpy((rng.standard_normal(
            (4, sizes[i], sizes[i + 1])) * 0.02).astype(np.float32))
            .to(cuda_device) for i in range(len(sizes) - 1)]
        if quant:
            drives = rng.integers(-512, 512, (k, b, sizes[0])).astype(np.int32)
            tch = rng.integers(-200, 200, (k, b, sizes[-1])).astype(np.int32)
        else:
            drives = (np.round(rng.standard_normal((k, b, sizes[0])) * 16)
                      / 16).astype(np.float32)
            tch = (rng.standard_normal((k, b, sizes[-1])) * 0.3
                   ).astype(np.float32)
        tch = {None: None, "per-step": tch, "held": tch[0]}[teach]
        t = _on(cuda_device, drives=drives, teach=tch, active=_active(b))
        if sizes == WALK_SIZES:
            _assert_walks(sizes, b, qc is not None, cuda_device)
        if bb == LONE_B:
            _assert_lone(sizes, b, qc is not None, False, cuda_device)
        params = [TE.EngineParams(
            spiking=i < len(sizes) - 2, quant=qc, tau_m=2.0,
            trace_decay=0.75 if quant else 0.8)
            for i in range(len(sizes) - 1)]
        kw = dict(params=params, teach=t["teach"], active=t["active"],
                  block_b=bb)
        launches = TF.rollout.launches
        got_st, got = TE.rollout(st, theta, t["drives"], **kw)
        assert TF.rollout.launches == launches + 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TF, "rollout", lambda *a, block_b=None, **k:
                       TF.rollout_plain(*a, **k))
            want_st, want = TE.rollout(st, theta, t["drives"], **kw)
        torch.cuda.synchronize()
        got_all = (*got_st.w, *got_st.v, *got_st.trace, got)
        want_all = (*want_st.w, *want_st.v, *want_st.trace, want)
        if quant or k == 1:
            _assert_match(got_all, want_all, quant)
        off = t["active"] == 0
        for w_new, w_old in zip(got_st.w, st.w):
            assert torch.equal(w_new[off], w_old[off])


SEARCH_SIZES = (11, 128, 2)      # the rule search's controller (position)


@pytest.mark.cuda
@pytest.mark.parametrize("plastic", (True, False),
                         ids=("plastic", "weight-trained"))
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_rollout_kernel_at_the_rule_search_width_on_card(quant, plastic,
                                                         cuda_device):
    """#3 fleet at 11-128-2, the rule search's shapes: B = 8 (one
    candidate's train tasks, one CTA), 72 (the eval tasks) and 384 (the
    weight-trained population, 48 CTAs), every layer plastic or none (no
    rule at all).  The 11-wide input rows (44 bytes) and 2-wide readout
    rows (8 bytes) take the per-element copy route.  int8 bit for bit over
    the control window (K = 4); float32 within 1e-5 at K = 1 (exact psums
    from grid-valued weights and drives) and at K = 4 for B = 8."""
    rng = np.random.default_rng(25)
    qc = TQ.QuantConfig() if quant else None
    flags = (plastic, plastic)
    cases = [(b, 4 if quant else 1) for b in (8, 72, 384)]
    if not quant:
        cases.append((8, 4))
    for b, k in cases:
        plan = TF.fleet_launch(cuda_device, SEARCH_SIZES, b, 8, flags,
                               quant=quant)
        assert plan["ctas"] == -(-b // 8) and plan["warps"] == 4, plan
        st = _network(rng, SEARCH_SIZES, quant, cuda_device, b)
        theta = [torch.from_numpy((rng.standard_normal(
            (4, SEARCH_SIZES[i], SEARCH_SIZES[i + 1])) * 0.02)
            .astype(np.float32)).to(cuda_device) if plastic else None
            for i in range(2)]
        if quant:
            drives = rng.integers(-512, 512, (k, b, 11)).astype(np.int32)
        else:
            drives = (np.round(rng.standard_normal((k, b, 11)) * 16)
                      / 16).astype(np.float32)
        drives = torch.from_numpy(drives).to(cuda_device)
        params = [TE.EngineParams(
            spiking=i == 0, plastic=plastic, quant=qc, tau_m=2.0,
            trace_decay=0.75 if quant else 0.8) for i in range(2)]
        launches = TF.rollout.launches
        got_st, got = TE.rollout(st, theta, drives, params=params,
                                 block_b=8)
        assert TF.rollout.launches == launches + 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TF, "rollout", lambda *a, block_b=None, **kw:
                       TF.rollout_plain(*a, **kw))
            want_st, want = TE.rollout(st, theta, drives, params=params,
                                       block_b=8)
        torch.cuda.synchronize()
        _assert_match((*got_st.w, *got_st.v, *got_st.trace, got),
                      (*want_st.w, *want_st.v, *want_st.trace, want), quant)
        if not plastic:
            for w_new, w_old in zip(got_st.w, st.w):
                assert torch.equal(w_new, w_old)


def _shared_inputs(rng, b, n, m, quant, dev, teach):
    """Spike-like events and grid-valued weights (exact float psums)."""
    if quant:
        t = _on(dev, x=rng.choice([0, 256], (b, n)).astype(np.int32),
                w=rng.integers(-127, 128, (n, m)).astype(np.int8),
                v=rng.integers(-600, 600, (b, m)).astype(np.int32),
                tpre=rng.integers(0, 1200, (b, n)).astype(np.int32),
                tpost=rng.integers(-300, 1200, (b, m)).astype(np.int32),
                teach=rng.integers(-300, 300, (b, m)).astype(np.int32)
                if teach else None)
    else:
        t = _on(dev, x=(rng.random((b, n)) < 0.4).astype(np.float32),
                w=(np.round(rng.uniform(-1, 1, (n, m)) * 64) / 64
                   ).astype(np.float32),
                v=rng.standard_normal((b, m)).astype(np.float32),
                tpre=(rng.random((b, n)) * 3).astype(np.float32),
                tpost=(rng.random((b, m)) * 3).astype(np.float32),
                teach=(rng.standard_normal((b, m)) * 0.5).astype(np.float32)
                if teach else None)
    t["theta"] = torch.from_numpy((rng.standard_normal((4, n, m)) * 0.02)
                                  .astype(np.float32)).to(dev)
    return t


@pytest.mark.cuda
def test_plain_shared_q_step_runs_on_card(cuda_device):
    """The plain fixed-point shared step (exact int32 broadcast-and-sum
    reductions) runs on CUDA tensors and gives the CPU's bits."""
    rng = np.random.default_rng(5)
    t = _shared_inputs(rng, 3, 40, 70, True, cuda_device, True)
    args = ("x", "w", None, "theta", "v", "tpre", "tpost")
    kw = dict(qcfg=TQ.QuantConfig(), seed=2 ** 31 - 3)
    scale = torch.tensor(1 / 32)

    def run(dev):
        a = [scale.to(dev) if k is None else t[k].to(dev) for k in args]
        return TR.dual_engine_step_q(*a, teach=t["teach"].to(dev), **kw)
    for g, c in zip(run(cuda_device), run("cpu")):
        assert torch.equal(g.cpu(), c)


# (B, N, M, spiking, teach, plastic): M = 257 and 130 are not multiples of
# a tile (257 bf16 or int8 rows take no copy engine); 784 -> 1024 and
# 1024 -> 10 are the MNIST layers; a fan-in of 1000 splits unevenly across
# an 8-CTA cluster (104 rows in the last CTA); 1000 int8 columns leave a
# ragged 8-byte edge of a 16-byte piece; 4096 rows stream the rule through
# a ring of chunks
SHARED_CASES = [(1, 8, 8, True, False, True), (3, 17, 257, True, True, True),
                (2, 100, 130, True, False, False),
                (1, 784, 1024, True, False, True),
                (8, 784, 1024, True, False, True),
                (1, 1024, 10, True, True, True),
                (4, 33, 12, False, True, True),
                (1, 1000, 10, True, True, True),
                (1, 784, 1000, True, False, True),
                (2, 4096, 1024, True, False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_shared_step_kernels_match_plain_on_card(quant, cuda_device):
    rng = np.random.default_rng(31)
    wrapper = TK.shared_step_q if quant else TK.shared_step
    launches = wrapper.launches
    for b, n, m, spiking, teach, plastic in SHARED_CASES:
        t = _shared_inputs(rng, b, n, m, quant, cuda_device, teach)
        kw = dict(spiking=spiking, teach=t["teach"], plastic=plastic)
        if quant:
            args = (t["x"], t["w"], torch.tensor(1 / 32, device=cuda_device),
                    t["theta"], t["v"], t["tpre"], t["tpost"])
            kw.update(qcfg=TQ.QuantConfig(), seed=int(rng.integers(2 ** 31)))
            got, want = TK.shared_step_q(*args, **kw), \
                TK.shared_step_q_plain(*args, **kw)
        else:
            args = (t["x"], t["w"], t["theta"], t["v"], t["tpre"], t["tpost"])
            got, want = TK.shared_step(*args, **kw), \
                TK.shared_step_plain(*args, **kw)
        torch.cuda.synchronize()
        _assert_match(got, want, quant)
    assert wrapper.launches == launches + len(SHARED_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_unbatched_layer_step_launches_shared_kernel(quant, cuda_device):
    """engine.layer_step promotes unbatched (N,) state to B = 1 for the
    kernel and squeezes it back."""
    rng = np.random.default_rng(32)
    t = _shared_inputs(rng, 1, 50, 40, quant, cuda_device, True)
    qc = TQ.QuantConfig() if quant else None
    params = TE.EngineParams(quant=qc, trace_decay=0.75 if quant else 0.8)
    layer = TE.LayerState(t["w"], t["v"][0], t["tpre"][0], t["tpost"][0],
                          t["theta"])
    wrapper = TK.shared_step_q if quant else TK.shared_step
    launches = wrapper.launches
    got_layer, got = TE.layer_step(layer, t["x"][0], params=params,
                                   teach=t["teach"][0], seed=7)
    assert wrapper.launches == launches + 1
    assert got.shape == (40,) and got_layer.v.shape == (40,)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TK, "shared_step_q" if quant else "shared_step",
                   TK.shared_step_q_plain if quant else TK.shared_step_plain)
        want_layer, want = TE.layer_step(layer, t["x"][0], params=params,
                                         teach=t["teach"][0], seed=7)
    _assert_match((got, got_layer.w, got_layer.v, got_layer.trace_post),
                  (want, want_layer.w, want_layer.v, want_layer.trace_post),
                  quant)


# (1, 1000, 10): a fan-in cut unevenly across an 8-CTA cluster (the last
# CTA 104 rows); (1, 784, 1001): rows of 1001 weights, a ragged 16-byte
# edge (float32 by 4-byte cp.async pieces, bf16 by plain loads)
LIF_SHAPES = [(2, 16, 16), (4, 200, 64), (1, 784, 1024), (8, 130, 250),
              (1, 1000, 10), (1, 784, 1001)]
LIF_BF16_SHAPES = [(8, 130, 250), (8, 784, 1024), (1, 1000, 10),
                   (1, 784, 1001)]


def _lif_inputs(rng, b, k, m, dev):
    return _on(dev, x=(rng.random((b, k)) < 0.5).astype(np.float32),
               w=(np.round(rng.standard_normal((k, m)) * 64) / 64
                  * k ** -0.5).astype(np.float32),
               v=(rng.standard_normal((b, m)) * 0.1).astype(np.float32),
               tr=rng.random((b, m)).astype(np.float32))


@pytest.mark.cuda
def test_lif_forward_kernel_matches_plain_on_card(cuda_device):
    """Each shape against the plain version, float32 and bf16; a second
    launch gives the same bits (the psum folds in one fixed order)."""
    rng = np.random.default_rng(41)
    launches = TL.lif_forward.launches
    for b, k, m in LIF_SHAPES:
        t = _lif_inputs(rng, b, k, m, cuda_device)
        args = (t["x"], t["w"], t["v"], t["tr"])
        got = TL.lif_forward(*args)
        want = TL.lif_forward_plain(*args)
        again = TL.lif_forward(*args)
        torch.cuda.synchronize()
        _assert_match(got, want, False)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert TL.lif_forward.launches == launches + 2 * len(LIF_SHAPES)
    bf16_launches = TL.lif_forward.bf16_launches
    for b, k, m in LIF_BF16_SHAPES:
        t = _lif_inputs(rng, b, k, m, cuda_device)
        bf16 = tuple(t[name].to(torch.bfloat16)
                     for name in ("x", "w", "v", "tr"))
        got = TL.lif_forward(*bf16)
        want = TL.lif_forward_plain(*bf16)
        torch.cuda.synchronize()
        _assert_bf16(got, want)
    assert TL.lif_forward.bf16_launches == bf16_launches \
        + len(LIF_BF16_SHAPES)
    args = (t["x"], t["w"], t["v"], t["tr"])
    with pytest.raises(ValueError):
        TL.lif_forward(*(a.to(torch.float16) for a in args))
    with pytest.raises(ValueError):
        TL.lif_forward(bf16[0], *args[1:])


def _assert_bf16(got, want, share=None):
    """bfloat16 outputs within 3e-2 of the plain version's; with ``share``,
    at most that share of the elements outside it."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bfloat16
        d = (a.double() - b.double()).abs()
        if share is None:
            assert float(d.max()) <= 3e-2
        else:
            assert float((d > 3e-2).double().mean()) <= share


def _shared_network(rng, sizes, b, quant, dev):
    n_layers = len(sizes) - 1
    bs = () if b is None else (b,)
    if quant:
        w = [rng.integers(-40, 41, (sizes[i], sizes[i + 1])).astype(np.int8)
             for i in range(n_layers)]
        v = [rng.integers(-300, 300, bs + (m,)).astype(np.int32)
             for m in sizes[1:]]
        tr = [rng.integers(0, 900, bs + (n,)).astype(np.int32)
              for n in sizes]
        sc = [np.float32(1 / 32 if i % 2 == 0 else 1 / 16)
              for i in range(n_layers)]
        t0 = 2 ** 31 - 9
    else:
        w = [(np.round(rng.uniform(-0.5, 0.5, (sizes[i], sizes[i + 1])) * 64)
              / 64).astype(np.float32) for i in range(n_layers)]
        v = [rng.uniform(-0.5, 0.9, bs + (m,)).astype(np.float32)
             for m in sizes[1:]]
        tr = [rng.uniform(0, 2, bs + (n,)).astype(np.float32) for n in sizes]
        sc, t0 = [], 0
    tup = lambda xs: tuple(torch.from_numpy(np.array(x)).to(dev) for x in xs)
    return TE.NetworkState(w=tup(w), v=tup(v), trace=tup(tr),
                           t=torch.tensor(t0, dtype=torch.int32, device=dev),
                           w_scale=tup(sc))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_shared_rollout_kernel_matches_plain_on_card(quant, cuda_device):
    """The pipelined shared-weight window: int8 bitwise at every K (the
    step counter wraps inside K = 16 and K = 33), float32 within 1e-5 at
    K = 1; batched and unbatched, with and without a teaching current; a
    three-layer net whose middle layer consumes and produces, every layer
    on the cp.async route, at B = 5 and K = 33 (more steps than the bus
    holds, so producers take credits); 784-1024-10 with layer 0 on TMA."""
    rng = np.random.default_rng(51)
    qc = TQ.QuantConfig() if quant else None
    three = (64, 96, 48, 10)
    plan = TF.shared_plan(three, 5, (True,) * 3, quant,
                          torch.cuda.get_device_properties(
                              cuda_device).multi_processor_count,
                          TK.smem_limit(cuda_device), 1 if quant else 4)
    assert all(r[0] != "tma" for r in plan["w"] + plan["theta"])
    assert plan["bus_depth"] < 33
    for k, sizes, b, teach in ((1, (8, 32, 4), 3, True),
                               (4, (40, 100, 10), None, True),
                               (16, (8, 32, 4), 2, False),
                               (8, (784, 1024, 10), None, True),
                               (1, three, 5, True),
                               (33, three, 5, True)):
        st = _shared_network(rng, sizes, b, quant, cuda_device)
        theta = [torch.from_numpy((rng.standard_normal(
            (4, sizes[i], sizes[i + 1])) * 0.02).astype(np.float32))
            .to(cuda_device) for i in range(len(sizes) - 1)]
        bs = () if b is None else (b,)
        if quant:
            drives = rng.choice([0, 256], (k,) + bs + (sizes[0],))
            tch = rng.integers(-200, 200, bs + (sizes[-1],))
            drives, tch = drives.astype(np.int32), tch.astype(np.int32)
        else:
            drives = (rng.random((k,) + bs + (sizes[0],)) < 0.4
                      ).astype(np.float32)
            tch = (rng.standard_normal(bs + (sizes[-1],)) * 0.3
                   ).astype(np.float32)
        t = _on(cuda_device, drives=drives, teach=tch if teach else None)
        params = [TE.EngineParams(
            spiking=True, quant=qc, tau_m=2.0,
            trace_decay=0.75 if quant else 0.8)
            for _ in range(len(sizes) - 1)]
        kw = dict(params=params, teach=t["teach"])
        launches = TF.rollout_shared.launches
        got_st, got = TE.rollout(st, theta, t["drives"], **kw)
        assert TF.rollout_shared.launches == launches + 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TF, "rollout", lambda *a, block_b=None, **k:
                       TF.rollout_plain(*a, **k))
            want_st, want = TE.rollout(st, theta, t["drives"], **kw)
        torch.cuda.synchronize()
        got_all = (*got_st.w, *got_st.v, *got_st.trace, got)
        want_all = (*want_st.w, *want_st.v, *want_st.trace, want)
        if quant or k == 1:
            _assert_match(got_all, want_all, quant)


# (B, Sq, Skv, H, HKV, D, causal, kv_len): the prefill shape, a ragged
# square, a decode-shaped query against a long cache, a kv_len mask, head
# width 64, and Sq > Skv (rows with no visible key); then the other head
# widths of the repo's configs: zamba2-7b's 112 at its prefill shape and a
# decode-shaped query, acausal with a kv_len, and the smoke configs' 16,
# 24 (5 heads) and 32, with GQA and a ragged kv_len
ATTN_CASES = [(4, 2048, 2048, 32, 8, 128, True, None),
              (2, 1000, 1000, 32, 8, 128, True, None),
              (4, 1, 2049, 32, 8, 128, True, None),
              (2, 300, 700, 8, 2, 128, True, 650),
              (1, 257, 257, 4, 2, 64, False, 200),
              (1, 80, 50, 4, 4, 64, True, None),
              (4, 2048, 2048, 32, 32, 112, True, None),
              (4, 1, 2049, 32, 32, 112, True, None),
              (2, 77, 150, 4, 4, 112, False, 120),
              (2, 300, 300, 4, 2, 16, True, None),
              (1, 50, 50, 5, 5, 24, True, None),
              (2, 200, 230, 8, 2, 32, True, 210)]
ATTN_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("float32", "bfloat16"))
def test_flash_attention_kernel_matches_plain_on_card(dtype, cuda_device):
    from repro_torch.kernels.attention import kernel as TA
    gen = torch.Generator(cuda_device).manual_seed(7)
    for b, sq, skv, h, hkv, d, causal, kv_len in ATTN_CASES:
        q = torch.randn(b, sq, h, d, generator=gen, device=cuda_device)
        k = torch.randn(b, skv, hkv, d, generator=gen, device=cuda_device)
        v = torch.randn(b, skv, hkv, d, generator=gen, device=cuda_device)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        launches = TA.flash_attention.launches
        got = TA.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        assert TA.flash_attention.launches == launches + 1
        want = TA.flash_attention_plain(q, k, v, causal=causal,
                                        kv_len=kv_len)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   **ATTN_TOL[dtype])
        if sq > skv and causal:          # no visible key: exactly zero
            assert (got[:, :sq - skv] == 0).all()
        del q, k, v, got, want


@pytest.mark.cuda
def test_flash_attention_bf16_large_values_on_card(cuda_device):
    """V at 8x unit scale: a single bf16 P would leave the tolerance here
    (tests/test_torch_attention.py); the split P holds it."""
    from repro_torch.kernels.attention import kernel as TA
    gen = torch.Generator(cuda_device).manual_seed(9)
    b, s, h, hkv, d = 2, 1000, 32, 8, 128
    q = torch.randn(b, s, h, d, generator=gen, device=cuda_device)
    k = torch.randn(b, s, hkv, d, generator=gen, device=cuda_device)
    v = 8 * torch.randn(b, s, hkv, d, generator=gen, device=cuda_device)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = TA.flash_attention(q, k, v)
    want = TA.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **ATTN_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_attention_refuses_other_head_widths(cuda_device):
    """A head width outside HEAD_DIMS raises in the wrapper, before any
    launch, and the C entry refuses it too."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as TA
    launches = TA.flash_attention.launches
    for d in (8, 48, 96, 256):
        q = torch.zeros(1, 16, 2, d, dtype=torch.bfloat16, device=cuda_device)
        with pytest.raises(ValueError, match="head_dim"):
            TA.flash_attention(q, q, q)
    assert TA.flash_attention.launches == launches
    q = torch.zeros(1, 16, 2, 48, dtype=torch.bfloat16, device=cuda_device)
    args = TA._AttnArgs(q.data_ptr(), q.data_ptr(), q.data_ptr(),
                        q.data_ptr(), *q.stride()[:3], *q.stride()[:3],
                        *q.stride()[:3], 1, 16, 16, 2, 2, 48, 1, 16, 0, 1,
                        48 ** -0.5)
    fn = _build.library("flash_attention.cu").flash_attention
    fn.argtypes = [ctypes.POINTER(TA._AttnArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    assert fn(ctypes.byref(args), None) != 0


@pytest.mark.cuda
def test_flash_attention_rejects_views_tma_cannot_read(cuda_device):
    """A bf16 view whose base is not 16-byte aligned, or whose token
    stride is not a whole 16 bytes, raises before any launch."""
    from repro_torch.kernels.attention import kernel as TA
    b, s, h, hkv, d = 1, 64, 4, 2, 64
    flat = torch.zeros(b * s * h * d + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    q_off = flat[1:1 + b * s * h * d].view(b, s, h, d)      # base + 2 bytes
    kv = torch.zeros(b, s, hkv, d, dtype=torch.bfloat16, device=cuda_device)
    wide = torch.zeros(b, s, h * d + 4, dtype=torch.bfloat16,
                       device=cuda_device)
    q_stride = wide[..., :h * d].view(b, s, h, d)          # 8-byte rows
    launches = TA.flash_attention.launches
    for q in (q_off, q_stride):
        with pytest.raises(ValueError, match="TMA"):
            TA.flash_attention(q, kv, kv)
    assert TA.flash_attention.launches == launches


@pytest.mark.cuda
def test_flash_attention_reads_through_strides_on_card(cuda_device):
    """q, k, v cut from one packed projection (no copies) give the same
    result as contiguous copies."""
    from repro_torch.kernels.attention import kernel as TA
    gen = torch.Generator(cuda_device).manual_seed(8)
    b, s, h, hkv, d = 2, 333, 16, 4, 128
    packed = torch.randn(b, s, h + 2 * hkv, d, generator=gen,
                         device=cuda_device).to(torch.bfloat16)
    q, k, v = packed[:, :, :h], packed[:, :, h:h + hkv], \
        packed[:, :, h + hkv:]
    got = TA.flash_attention(q, k, v)
    want = TA.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_lm_prefill_launches_attention_kernel_per_layer(cuda_device):
    """A smoke-size prefill on the card launches the attention kernel once
    per layer and matches the same prefill with the plain attention."""
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.models import attention as MA
    from repro_torch.models import factory
    model = factory.build("qwen3-4b", smoke=True, dtype="float32")
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(0, model.cfg.vocab, (2, 70), device=cuda_device)
    launches = TA.flash_attention.launches
    logits, cache = model.prefill(params, toks, 80)
    assert TA.flash_attention.launches == launches + model.cfg.n_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MA, "attn_op", TA.flash_attention_plain)
        want, want_cache = model.prefill(params, toks, 80)
    torch.cuda.synchronize()
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["segments"][0]["k"],
                               want_cache["segments"][0]["k"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_hybrid_prefill_launches_both_kernels_on_card(cuda_device):
    """zamba2-7b's SMOKE (heads of 16) at n_layers = 7 in float32: one
    prefill launches the attention kernel once per super-block and the SSD
    scan once per Mamba2 block, and matches the same prefill through the
    plain versions, its cache included; then a decode step."""
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.ssd import kernel as TS
    from repro_torch.models import attention as MA, factory, ssm as MS
    model = factory.build("zamba2-7b", smoke=True, dtype="float32",
                          n_layers=7)
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(0, model.cfg.vocab, (2, 70), device=cuda_device)
    attn, scans = TA.flash_attention.launches, TS.ssd_scan.launches
    logits, cache = model.prefill(params, toks, 80)
    assert TA.flash_attention.launches == attn + 2
    assert TS.ssd_scan.launches == scans + 5
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MA, "attn_op", TA.flash_attention_plain)
        mp.setattr(MS, "ssd_op", TS.ssd_scan_plain)
        want, want_cache = model.prefill(params, toks, 80)
    torch.cuda.synchronize()
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    for got_leaf, want_leaf in zip(
            (cache["segments"][0]["k"], cache["segments"][0]["ssm"]["ssm"],
             cache["segments"][1]["ssm"]),
            (want_cache["segments"][0]["k"],
             want_cache["segments"][0]["ssm"]["ssm"],
             want_cache["segments"][1]["ssm"])):
        torch.testing.assert_close(got_leaf, want_leaf, **SSD_TOL)
    tok = logits.argmax(-1)[:, None]
    got, _ = model.decode_step(params, cache, tok)
    want, _ = model.decode_step(params, want_cache, tok)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# (shape, x dtype, other dtype or None, out dtype, x's offset in a wider
# row or None): the SwiGLU gate times x @ up at qwen3-4b's width, the
# Mamba2 conv activation, its output gate in prefill (z cut from the
# projection, times bf16 y into float32) and in decode (times float32 y),
# float32 models, and views no 16-byte load can read (one element a thread)
SILU_CASES = [((2, 70, 9728), "bfloat16", "bfloat16", "bfloat16", None),
              ((2, 70, 4352), "bfloat16", None, "bfloat16", None),
              ((2, 70, 4096), "bfloat16", "bfloat16", "float32", 0),
              ((4, 1, 4096), "bfloat16", "float32", "float32", 0),
              ((2, 70, 640), "float32", "float32", "float32", None),
              ((2, 70, 160), "float32", None, "float32", 3),
              ((3, 5, 37), "bfloat16", "bfloat16", "bfloat16", 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SILU_CASES,
                         ids=lambda c: "x".join(map(str, c[0])) + f"-{c[1]}")
def test_silu_kernel_matches_plain_on_card(case, cuda_device):
    """`layers.silu` (csrc/silu.cu, one pass) equals its plain version, the
    five ops that round as ``jax.nn.silu`` is written, bit for bit."""
    from repro_torch.models import layers as ML
    shape, xd, od, yd, offset = case
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    gen = torch.Generator(cuda_device).manual_seed(5)
    wide = (4 * torch.randn(*shape[:-1], 2 * shape[-1] + 3, generator=gen,
                            device=cuda_device)).to(dt[xd])
    x = (wide[..., :shape[-1]].contiguous() if offset is None
         else wide[..., offset:offset + shape[-1]])
    other = None if od is None else torch.randn(
        shape, generator=gen, device=cuda_device).to(dt[od])
    n = ML.silu.launches
    got = ML.silu(x, other, dt[yd])
    assert ML.silu.launches == n + 1
    want = ML.silu_plain(x, other, dt[yd])
    torch.cuda.synchronize()
    assert got.dtype == dt[yd] and got.shape == x.shape
    assert torch.equal(got, want)


# (B, L, H, P, S, G): one token, a ragged 100 with G = 2, a ragged 300,
# mamba2-1.3b's head (P = 64, S = 128) over an exact 128 and over the
# prefill's 2048, the smoke config's small head (P = S = 16), heads of
# 36 (72-byte rows: no tensor map reads them, so bf16 takes the cp.async
# route) over a state of 64 with G = 2, and zamba2-7b's prefill (112 heads
# of 64 over a state of 64)
SSD_CASES = [(2, 1, 4, 64, 128, 1), (2, 100, 4, 64, 128, 2),
             (1, 300, 8, 64, 128, 1), (2, 128, 2, 64, 128, 1),
             (2, 2048, 4, 64, 128, 1), (3, 70, 4, 16, 16, 1),
             (2, 150, 4, 36, 64, 2), (4, 2048, 112, 64, 64, 1)]
SSD_TOL = dict(rtol=2e-3, atol=2e-3)


def _ssd_inputs(gen, b, length, h, p, s, g, dtype, dev):
    """x, B and C cut from one packed (B, L, H*P + 2*G*S) projection (x is
    not contiguous), as the Mamba2 block hands them to the kernel."""
    packed = torch.randn(b, length, h * p + 2 * g * s, generator=gen,
                         device=dev).to(dtype)
    x = packed[..., :h * p].unflatten(-1, (h, p))
    bm = packed[..., h * p:h * p + g * s].unflatten(-1, (g, s))
    cm = packed[..., h * p + g * s:].unflatten(-1, (g, s))
    dt = torch.nn.functional.softplus(
        torch.randn(b, length, h, generator=gen, device=dev))
    a = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))
    return x, dt, a, bm, cm


def _bf16_step(t):
    """One bfloat16 step at the largest |t|."""
    m = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("float32", "bfloat16"))
def test_ssd_kernel_matches_plain_on_card(dtype, cuda_device):
    """y and the final state against the plain chunked form (chunk 256, the
    model's, and 64); float32 y within 2e-3, bfloat16 y within one bf16
    step of the largest |y|; the state (float32) within 2e-3."""
    from repro_torch.kernels.ssd import kernel as TS
    gen = torch.Generator(cuda_device).manual_seed(9)
    launches = TS.ssd_scan.launches
    for b, length, h, p, s, g in SSD_CASES:
        args = _ssd_inputs(gen, b, length, h, p, s, g, dtype, cuda_device)
        y, st = TS.ssd_scan(*args)
        for chunk in (256, 64):
            want_y, want_st = TS.ssd_scan_plain(*args, chunk=chunk)
            torch.cuda.synchronize()
            assert y.dtype == dtype and y.shape == want_y.shape
            assert st.dtype == torch.float32 and st.shape == (b, h, s, p)
            if dtype == torch.float32:
                torch.testing.assert_close(y, want_y, **SSD_TOL)
            else:
                err = float((y.float() - want_y.float()).abs().max())
                assert err <= _bf16_step(want_y), (length, err)
            torch.testing.assert_close(st, want_st, **SSD_TOL)
    assert TS.ssd_scan.launches == launches + len(SSD_CASES)


@pytest.mark.cuda
def test_ssd_kernel_matches_the_recurrence_on_card(cuda_device):
    from repro_torch.kernels.ssd import kernel as TS, ref as TR
    gen = torch.Generator(cuda_device).manual_seed(10)
    args = _ssd_inputs(gen, 2, 150, 4, 64, 128, 2, torch.float32,
                       cuda_device)
    y, st = TS.ssd_scan(*args)
    want_y, want_st = TR.ssd_scan_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, **SSD_TOL)
    torch.testing.assert_close(st, want_st, **SSD_TOL)


@pytest.mark.cuda
def test_ssd_kernel_reads_through_strides_on_card(cuda_device):
    """x, B and C cut from the packed projection give the same bits as
    contiguous copies, through the TMA route and, for views shifted by one
    element (a base and a token stride off 16 bytes), the cp.async route."""
    from repro_torch.kernels.ssd import kernel as TS
    gen = torch.Generator(cuda_device).manual_seed(11)
    b, length, h, p, s, g = 2, 333, 8, 64, 128, 2
    args = _ssd_inputs(gen, b, length, h, p, s, g, torch.bfloat16,
                       cuda_device)
    want = TS.ssd_scan(*(t.contiguous() for t in args))
    assert TS.copy_route(args[0], args[3], args[4]) == "tma"
    packed = torch.cat([torch.zeros(b, length, 1, dtype=torch.bfloat16,
                                    device=cuda_device),
                        torch.cat([args[0].flatten(2), args[3].flatten(2),
                                   args[4].flatten(2)], -1)], -1)
    x = packed[..., 1:1 + h * p].unflatten(-1, (h, p))
    bm = packed[..., 1 + h * p:1 + h * p + g * s].unflatten(-1, (g, s))
    cm = packed[..., 1 + h * p + g * s:].unflatten(-1, (g, s))
    assert TS.copy_route(x, bm, cm) == "cp.async"
    for got in (TS.ssd_scan(*args),
                TS.ssd_scan(x, args[1], args[2], bm, cm)):
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.cuda
def test_mamba2_prefill_launches_ssd_kernel_per_layer(cuda_device):
    """A smoke-size mamba2 prefill on the card launches the SSD kernel once
    per layer and matches the same prefill through the plain version."""
    from repro_torch.kernels.ssd import kernel as TS
    from repro_torch.models import factory
    from repro_torch.models import ssm as MS
    model = factory.build("mamba2-1.3b", smoke=True, dtype="float32")
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(0, model.cfg.vocab, (2, 70), device=cuda_device)
    launches = TS.ssd_scan.launches
    logits, cache = model.prefill(params, toks, 80)
    assert TS.ssd_scan.launches == launches + model.cfg.n_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MS, "ssd_op", TS.ssd_scan_plain)
        want, want_cache = model.prefill(params, toks, 80)
    torch.cuda.synchronize()
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["segments"][0]["ssm"],
                               want_cache["segments"][0]["ssm"], **SSD_TOL)


# ---- the telemetry variants and session serving -------------------------------

def _tel_step_inputs(rng, n, m, quant, dev, b=B):
    """A telemetry step's inputs.  In float32 beyond 8192 synapses a stream
    the row's sum |dw| nears 1e3, where a float32 ulp is ~1e-4, so the
    traces are drawn on a grid of quarters and the rule on one of 2^-8:
    every partial sum of the row is then exact, and the 2e-4 tolerance
    compares the same number whatever order the kernel sums in."""
    if quant:
        return _on(dev, x=rng.choice([0, 256], (b, n)).astype(np.int32),
                   w=rng.integers(-127, 128, (b, n, m)).astype(np.int8),
                   v=rng.integers(-600, 600, (b, m)).astype(np.int32),
                   tpre=rng.integers(0, 1200, (b, n)).astype(np.int32),
                   tpost=rng.integers(-300, 1200, (b, m)).astype(np.int32),
                   scale=np.where(np.arange(b) % 2 == 0, 1 / 32,
                                  1 / 16).astype(np.float32),
                   seed=rng.integers(-2 ** 31, 2 ** 31, b).astype(np.int32),
                   teach=rng.integers(-300, 300, (b, m)).astype(np.int32),
                   theta=(rng.standard_normal((4, n, m)) * 0.02
                          ).astype(np.float32))
    grid = (lambda a, g: np.round(a * g) / g) if n * m > 8192 \
        else (lambda a, g: a)
    return _on(dev, x=(rng.random((b, n)) < 0.4).astype(np.float32),
               w=(np.round(rng.uniform(-1, 1, (b, n, m)) * 64) / 64
                  ).astype(np.float32),
               v=(rng.standard_normal((b, m)) * 0.8).astype(np.float32),
               tpre=grid(rng.random((b, n)) * 3, 4).astype(np.float32),
               tpost=grid(rng.random((b, m)) * 3, 4).astype(np.float32),
               teach=(rng.standard_normal((b, m)) * 0.5).astype(np.float32),
               theta=grid(rng.standard_normal((4, n, m)) * 0.02, 256
                          ).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_fleet_step_telemetry_variant_matches_plain_on_card(quant,
                                                           cuda_device):
    """The telemetry row against the plain version (int8 bit for bit,
    float32 within 2e-4), its state bit for bit against the same launch
    without telemetry, and zeros for vacant slots."""
    rng = np.random.default_rng(41)
    for b, n, m, spiking in ((B, 8, 128, True), (B, 128, 8, False),
                             (B, 7, 45, True), (B, 16, 200, False),
                             (4, 128, 128, True)):
        t = _tel_step_inputs(rng, n, m, quant, cuda_device, b)
        active = torch.from_numpy(_active(b)).to(cuda_device)
        kw = dict(spiking=spiking, teach=t["teach"], active=active)
        if quant:
            args = (t["x"], t["w"], t["scale"], t["theta"], t["v"],
                    t["tpre"], t["tpost"])
            kw.update(qcfg=TQ.QuantConfig(), seed=t["seed"])
            fn, plain = TK.fleet_step_q, TK.fleet_step_q_plain
        else:
            args = (t["x"], t["w"], t["theta"], t["v"], t["tpre"],
                    t["tpost"])
            fn, plain = TK.fleet_step, TK.fleet_step_plain
        got = fn(*args, telemetry=True, **kw)
        off = fn(*args, **kw)
        want = plain(*args, telemetry=True, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got[:4], off):
            assert torch.equal(a, b)
        _assert_match(got[:4], want[:4], quant)
        if quant:
            assert torch.equal(got[4], want[4])
        else:
            torch.testing.assert_close(got[4], want[4], rtol=0, atol=2e-4)
        assert (got[4][active == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_rollout_telemetry_variant_matches_plain_on_card(quant, cuda_device):
    rng = np.random.default_rng(43)
    qc = TQ.QuantConfig() if quant else None
    for k, sizes, b in ((1, (8, 128, 8), B), (4, (8, 128, 8), B),
                        (16, (8, 128, 8), B),
                        (WALK_K[quant], WALK_SIZES, WALK_B)):
        st = _network(rng, sizes, quant, cuda_device, b)
        theta = [torch.from_numpy((rng.standard_normal(
            (4, sizes[i], sizes[i + 1])) * 0.02).astype(np.float32))
            .to(cuda_device) for i in range(len(sizes) - 1)]
        if quant:
            drives = rng.integers(-512, 512, (k, b, sizes[0])).astype(np.int32)
            tch = rng.integers(-200, 200, (b, sizes[-1])).astype(np.int32)
        else:
            drives = (np.round(rng.standard_normal((k, b, sizes[0])) * 16)
                      / 16).astype(np.float32)
            tch = (rng.standard_normal((b, sizes[-1])) * 0.3
                   ).astype(np.float32)
        t = _on(cuda_device, drives=drives, teach=tch, active=_active(b))
        if b == WALK_B:
            _assert_walks(sizes, b, qc is not None, cuda_device)
        params = [TE.EngineParams(
            spiking=i < len(sizes) - 2, quant=qc, tau_m=2.0,
            trace_decay=0.75 if quant else 0.8)
            for i in range(len(sizes) - 1)]
        kw = dict(params=params, teach=t["teach"], active=t["active"])
        launches = (TF.rollout.launches, TF.rollout.telemetry_launches)
        got_st, got, tel = TE.rollout(st, theta, t["drives"], telemetry=True,
                                      **kw)
        off_st, off = TE.rollout(st, theta, t["drives"], **kw)
        assert (TF.rollout.launches, TF.rollout.telemetry_launches) == (
            launches[0] + 2, launches[1] + 1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TF, "rollout", lambda *a, block_b=None, **k:
                       TF.rollout_plain(*a, **k))
            want_st, want, want_tel = TE.rollout(st, theta, t["drives"],
                                                 telemetry=True, **kw)
        if quant and b == WALK_B:
            # PyTorch divides a CUDA tensor by a Python number as a product
            # with its reciprocal, one ulp off true division where the
            # divisor (M = 48 and 24, K * L = 48) is no power of two: hold
            # these rows against the plain version on the CPU, which
            # divides as the kernel and JAX do
            cpu = lambda xs: tuple(x.cpu() for x in xs)
            want_tel = TE.rollout(
                TE.NetworkState(w=cpu(st.w), v=cpu(st.v),
                                trace=cpu(st.trace), t=st.t.cpu(),
                                w_scale=cpu(st.w_scale)),
                cpu(theta), t["drives"].cpu(), telemetry=True,
                params=params, teach=t["teach"].cpu(),
                active=t["active"].cpu())[2]
        torch.cuda.synchronize()
        for a, b in zip((*got_st.w, *got_st.v, *got_st.trace, got),
                        (*off_st.w, *off_st.v, *off_st.trace, off)):
            assert torch.equal(a, b)
        for f in ("spike_rate", "mean_abs_dw", "sat_frac", "occupancy"):
            g, w = getattr(tel, f), getattr(want_tel, f).to(cuda_device)
            if quant:
                assert torch.equal(g, w), f
            else:
                torch.testing.assert_close(g, w, rtol=0, atol=2e-4)
            assert (g[t["active"] == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_scheduler_evict_readmit_bit_identical_on_card(quant, cuda_device,
                                                       tmp_path):
    """A 64-slot pool on the card: a probe evicted to disk and re-admitted
    into another slot continues exactly as without the interruption."""
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    from repro_torch.serving import FleetScheduler, SessionStore
    cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
           else firefly_snn.CONFIG)
    theta = snn.init_theta(cfg, torch.Generator(cuda_device).manual_seed(0),
                           scale=0.05)
    users = [f"u{i}" for i in range(63)]

    def drive(uid, t):
        return (np.sin(0.3 * t + len(uid) + np.arange(8)) * 1.5
                ).astype(np.float32)

    def run(interrupt):
        sched = FleetScheduler(
            cfg, theta, slots=64, device=cuda_device,
            store=SessionStore(root=str(tmp_path / str(interrupt))))
        assert sched.admit("probe") == 0
        for u in users:
            sched.admit(u)
        outs = []
        for t in range(8):
            if interrupt and t == 4:
                sched.evict("probe")
                sched.store._warm.clear()
                sched.evict("u5")
                sched.admit("rival")         # takes slot 0
                assert sched.admit("probe") == 6
            obs = {u: drive(u, t) for u in sched.active_users}
            if t % 2:
                out = sched.step(obs, telemetry=True)[0]
            else:
                out = sched.control_step(obs)
            outs.append(out["probe"].clone())
        sched.evict("probe")
        return outs, sched.store.checkout(
            "probe", lambda: snn.init_state(cfg, device=cuda_device),
            device=cuda_device)

    o1, (f1, s1) = run(False)
    o2, (f2, s2) = run(True)
    assert s1 == s2
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    for a, b in zip((*f1.w, *f1.v, *f1.trace), (*f2.w, *f2.v, *f2.trace)):
        assert torch.equal(a, b)


def _bf16(t, dev):
    return {k: None if v is None else
            torch.from_numpy(np.array(v)).to(dev).to(torch.bfloat16)
            for k, v in t.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("theta_dtype", (torch.bfloat16, torch.float32),
                         ids=("theta-bf16", "theta-f32"))
def test_bf16_fleet_step_kernel_matches_plain_on_card(theta_dtype,
                                                      cuda_device):
    """#1 in bfloat16, telemetry off and on: state within 3e-2 of the plain
    version, the telemetry launch's state bit for bit the telemetry-off
    launch's, rows within 3e-2 relative, inactive slots frozen; float16
    and mixed dtypes raise."""
    rng = np.random.default_rng(61)
    launches = TK.fleet_step.bf16_launches
    for b, n, m, spiking, teach, masked in STEP_CASES:
        active = torch.from_numpy(_active(b)).to(cuda_device)
        tshape = {"per-stream": (b, m), "shared": (m,)}.get(teach)
        t = _bf16(dict(
            x=(rng.random((b, n)) < 0.4).astype(np.float32),
            w=np.round(rng.uniform(-1, 1, (b, n, m)) * 64) / 64,
            v=rng.standard_normal((b, m)), tpre=rng.random((b, n)) * 3,
            tpost=rng.random((b, m)) * 3,
            teach=None if tshape is None else
            rng.standard_normal(tshape) * 0.5), cuda_device)
        theta = torch.from_numpy(rng.standard_normal((4, n, m)) * 0.02).to(
            cuda_device).to(theta_dtype)
        args = (t["x"], t["w"], theta, t["v"], t["tpre"], t["tpost"])
        kw = dict(spiking=spiking, teach=t["teach"],
                  active=active if masked else None)
        off = TK.fleet_step(*args, **kw)
        got = TK.fleet_step(*args, telemetry=True, **kw)
        want = TK.fleet_step_plain(*args, telemetry=True, **kw)
        torch.cuda.synchronize()
        _assert_bf16(off, want[:4])
        for a, b in zip(got[:4], off):
            assert torch.equal(a, b)
        d = (got[4].double() - want[4].double()).abs()
        assert float((d / (1 + want[4].double().abs())).max()) <= 3e-2
        if masked:
            assert torch.equal(got[3][active == 0], t["w"][active == 0])
            assert (got[4][active == 0] == 0).all()
    assert TK.fleet_step.bf16_launches == launches + 2 * len(STEP_CASES)
    with pytest.raises(ValueError):
        TK.fleet_step(*(a.to(torch.float16) for a in args))
    with pytest.raises(ValueError):
        TK.fleet_step(args[0].float(), *args[1:])


@pytest.mark.cuda
def test_bf16_shared_step_kernel_matches_plain_on_card(cuda_device):
    """#4 in bfloat16 at the MNIST layers and ragged shapes, the rule in
    bfloat16 or float32; float16 raises."""
    rng = np.random.default_rng(62)
    launches = TK.shared_step.bf16_launches
    for i, (b, n, m, spiking, teach, plastic) in enumerate(SHARED_CASES):
        t = _shared_inputs(rng, b, n, m, False, cuda_device, teach)
        th = t["theta"].to(torch.bfloat16) if i % 2 else t["theta"]
        args = tuple(a.to(torch.bfloat16) for a in (
            t["x"], t["w"])) + (th,) + tuple(a.to(torch.bfloat16) for a in (
                t["v"], t["tpre"], t["tpost"]))
        kw = dict(spiking=spiking, plastic=plastic,
                  teach=None if t["teach"] is None
                  else t["teach"].to(torch.bfloat16))
        got = TK.shared_step(*args, **kw)
        want = TK.shared_step_plain(*args, **kw)
        torch.cuda.synchronize()
        _assert_bf16(got, want)
    assert TK.shared_step.bf16_launches == launches + len(SHARED_CASES)
    with pytest.raises(ValueError):
        TK.shared_step(*(a.to(torch.float16) for a in args))


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", (True, False), ids=("fleet", "shared"))
def test_bf16_rollout_kernels_match_plain_on_card(fleet, cuda_device):
    """#3 in bfloat16, fleet (with telemetry at K = 4; also `WALK_SIZES`
    at B = 2117 and 8-128-8 in tiles of `LONE_B`, one buffer a stream) and
    shared-weight (also a three-layer net at B = 5, every layer on the
    cp.async route, K = 1 and 33): K = 1 within 3e-2, longer windows with
    at most 1e-3 of the elements outside it; inactive slots frozen;
    float16 raises."""
    rng = np.random.default_rng(63)
    counter = TF.rollout if fleet else TF.rollout_shared
    launches = counter.bf16_launches
    cases = [(1, (8, 32, 4), B, 8), (4, (8, 128, 8), B, 8),
             (16, (8, 32, 4), B, 8)]
    if fleet:     # three layers, more tiles than the grid holds; one buffer
        cases += [(16, WALK_SIZES, WALK_B, 8),
                  (16, (8, 128, 8), WALK_B, LONE_B)]
    else:         # a middle layer, every layer on cp.async, credits
        cases += [(1, (64, 96, 48, 10), 5, 8), (33, (64, 96, 48, 10), 5, 8)]
    for k, sizes, b, bb in cases:
        if not fleet and b != B:
            st = _shared_network(rng, sizes, b, False, cuda_device)
        else:
            st = _network(rng, sizes, False, cuda_device, b)
            if not fleet:
                st = TE.NetworkState(w=tuple(w[0] for w in st.w), v=st.v,
                                     trace=st.trace, t=st.t)
            elif sizes == WALK_SIZES:
                _assert_walks(sizes, b, False, cuda_device, bf16=True)
            elif bb == LONE_B:
                _assert_lone(sizes, b, False, True, cuda_device)
        bf = torch.bfloat16
        st = TE.NetworkState(w=tuple(w.to(bf) for w in st.w),
                             v=tuple(v.to(bf) for v in st.v),
                             trace=tuple(t.to(bf) for t in st.trace), t=st.t)
        theta = [torch.from_numpy(rng.standard_normal(
            (4, sizes[i], sizes[i + 1])) * 0.02).to(cuda_device).to(bf)
            for i in range(len(sizes) - 1)]
        drives = torch.from_numpy(np.round(rng.standard_normal(
            (k, b, sizes[0])) * 16) / 16).to(cuda_device).to(bf)
        tch = torch.from_numpy(rng.standard_normal((b, sizes[-1])) * 0.3
                               ).to(cuda_device).to(bf)
        params = [TE.EngineParams(spiking=i < len(sizes) - 2)
                  for i in range(len(sizes) - 1)]
        kw = dict(params=params, teach=tch, block_b=bb)
        if fleet:
            kw["active"] = torch.from_numpy(_active(b)).to(cuda_device)
        tel = fleet and k == 4
        got = TE.rollout(st, theta, drives, telemetry=tel, **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TF, "rollout", lambda *a, block_b=None, **kk:
                       TF.rollout_plain(*a, **kk))
            want = TE.rollout(st, theta, drives, telemetry=tel, **kw)
        torch.cuda.synchronize()
        flat = lambda r: (*r[0].w, *r[0].v, *r[0].trace, r[1])
        _assert_bf16(flat(got), flat(want), None if k == 1 else 1e-3)
        if tel:
            for f in ("spike_rate", "mean_abs_dw", "sat_frac"):
                torch.testing.assert_close(getattr(got[2], f),
                                           getattr(want[2], f), rtol=0,
                                           atol=2e-4)
        if fleet:
            off = kw["active"] == 0
            for x, y in zip(got[0].w + got[0].v, st.w + st.v):
                assert torch.equal(x[off], y[off])
    assert counter.bf16_launches == launches + len(cases)
    with pytest.raises(ValueError):
        TE.rollout(st, theta, drives.to(torch.float16), **kw)


# (B, layer sizes) a recorder case: the three-layer net with a CTA of
# warps left idle; the LM adapter's one 128 x 128 and 512 x 512 layer at
# B = 8 (a slot spans a cluster); a second layer of 15 weights, whose rows
# break the copy engine's 16-byte rules (the cp.async route); the fleet's
# 8-128-8 at B = 4096 (a persistent grid through two stages in float32)
RECORDER_CASES = {"8-48-24-8": (37, (8, 48, 24, 8)),
                  "adapter-128": (8, (128, 128)),
                  "adapter-512": (8, (512, 512)),
                  "cp-async": (600, (8, 5, 3)),
                  "fleet": (4096, (8, 128, 8))}


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", ("float32", "bfloat16", "int8"))
@pytest.mark.parametrize("case", tuple(RECORDER_CASES))
def test_recorder_kernel_matches_plain_on_card(case, wdtype, cuda_device):
    """`obs.recorder.record_step` (csrc/recorder.cu, one launch a step, laid
    out by `recorder_plan`) equals `record_step_plain` over 14 steps of each
    `RECORDER_CASES` fleet, W = 5 (the ring wraps), telemetry columns at
    stride 3, a partial bool mask and a planted stuck, dead and
    out-of-corridor slot: flags, streaks, steps and verdicts exact; int8
    every leaf bit for bit, with -128 among the weights; float ring,
    baselines and wnorm0 within rtol = atol = 1e-6 (the weight norm sums in
    another order, and the drift channel is a difference of two norms).  A
    second launch from the same state gives the same bits, and no kernel of
    the file uses local memory.  The adapters' int8 weights keep a slot's
    sum of |w| under 2^24, where the plain version's float32 sum is exact
    (above it the plain sum rounds in its own order; the kernel's is an
    exact integer, rounded once)."""
    from repro_torch.core.engine import NetworkState
    from repro_torch.checkpoint import manager as TM
    from repro_torch.obs import health as THl, recorder as TRec
    from repro_torch.obs.telemetry import FleetTelemetry
    dev = cuda_device
    b, sizes = RECORDER_CASES[case]
    steps = 14
    stuck, dead, bound = (3, 5, 8) if b > 8 else (1, 3, 6)
    quant = wdtype == "int8"
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}
    cfg = THl.HealthConfig(window=5, warmup=3, hysteresis=(2, 2, 3, 2),
                           dead_floor=1e-3)
    gen = torch.Generator(dev).manual_seed(23)
    active = torch.rand(b, generator=gen, device=dev) < 0.8
    active[[stuck, dead, bound]] = True
    shapes = [(b, sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)]
    nms = [n * m for _, n, m in shapes]
    plan = TRec.recorder_plan(
        b, nms, dt[wdtype],
        torch.cuda.get_device_properties(dev).multi_processor_count)
    wide = case.startswith("adapter")
    assert plan["route"] == "cluster" or not wide
    assert "cp_async" in plan["loads"] or case != "cp-async"

    def draw():
        if quant:
            lo, hi = (-40, 41) if wide else (-128, 128)
            out = [torch.randint(lo, hi, s, generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.int8)
                   for s in shapes]
            for w in out:                       # -128 in every slot
                w.view(b, -1)[:, ::97] = -128
            return out
        return [torch.randn(s, generator=gen, device=dev).to(dt[wdtype])
                for s in shapes]
    w = draw()
    scales = tuple(torch.rand(b, generator=gen, device=dev) / 8 + 0.01
                   for _ in w) if quant else ()
    kern = TRec.init_recorder(cfg, b, device=dev)
    plain = TRec.init_recorder(cfg, b, device=dev)
    raw = None
    for t in range(steps):
        move = torch.rand(b, generator=gen, device=dev) < 0.5
        move[stuck] = False
        w = [torch.where(move[:, None, None], n, o) for n, o in zip(draw(), w)]
        st = NetworkState(w=tuple(w), v=(), trace=(),
                          t=torch.zeros((), dtype=torch.int32, device=dev),
                          w_scale=scales)
        new = torch.rand(b, 3, generator=gen, device=dev)
        if raw is not None:
            new[stuck] = raw[stuck]
        new[dead, 0] = 0.0
        new[bound, 2] = 1.5
        raw = new
        tel = FleetTelemetry(raw[:, 0], raw[:, 1], raw[:, 2], active.float())
        if t == steps - 1:          # the last step twice from one state
            twin = TM.tree_map(torch.clone, kern)
            _, tv = TRec.record_step(cfg, twin, st, tel, t, active, quant)
        n = TRec.record_step.launches
        kern, kv = TRec.record_step(cfg, kern, st, tel, t, active, quant)
        assert TRec.record_step.launches == n + 1
        plain, pv = TRec.record_step_plain(cfg, plain, st, tel, t, active,
                                           quant)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv)
        for i, (x, y) in enumerate(zip(TM.flatten(kern)[1],
                                       TM.flatten(plain)[1])):
            if i >= 5 or quant:
                assert torch.equal(x, y), (t, i)
            else:
                np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                           rtol=1e-6, atol=1e-6)
    assert torch.equal(tv, kv)
    assert all(torch.equal(x, y) for x, y in zip(TM.flatten(twin)[1],
                                                 TM.flatten(kern)[1]))
    flags = kern.health.flagged.cpu()
    assert flags[stuck, 2] and flags[dead, 3] and flags[bound, 1]
    assert not kern.ring[~active].any()
    usage = TRec.recorder_attrs()
    assert all(u["local_bytes"] == 0 for u in usage.values()), usage


def _adapter_state(rng, quant, b, n, dev):
    """An adapter cache of ``b`` streams at width ``n`` (the
    `models.plastic.plan_cache` schema): int8 weights with per-slot scales
    and step counters 2 before the int32 wrap, so a K = 4 window's seeds
    wrap; float32 weights on a grid."""
    if quant:
        st = dict(w_fast=rng.integers(-40, 41, (b, n, n)).astype(np.int8),
                  v2=rng.integers(-300, 300, (b, n)).astype(np.int32),
                  tr1=rng.integers(0, 900, (b, n)).astype(np.int32),
                  tr2=rng.integers(0, 900, (b, n)).astype(np.int32),
                  w_scale=np.where(np.arange(b) % 2, 1 / 16, 1 / 32)
                  .astype(np.float32))
    else:
        st = dict(w_fast=(np.round(rng.uniform(-0.5, 0.5, (b, n, n)) * 64)
                          / 64).astype(np.float32),
                  v2=rng.uniform(-0.5, 0.9, (b, n)).astype(np.float32),
                  tr1=rng.uniform(0, 2, (b, n)).astype(np.float32),
                  tr2=rng.uniform(0, 2, (b, n)).astype(np.float32))
    st.update(v1=rng.uniform(-0.5, 0.9, (b, n)).astype(np.float32),
              t=np.full((b,), 2 ** 31 - 2, np.int32))
    return _on(dev, **st)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_rollout_kernel_at_the_adapter_width_on_card(quant, cuda_device):
    """#3 fleet through `plastic.decode_rollout` at the LM adapter's one
    128 -> 128 layer, B = 8 pool slots, K = 4, slot 5 vacant: one launch at
    the tile the plan picks (float32 3 streams a CTA, int8 8), against the
    plain window on the same inputs and against 4 plain steps; int8 bit
    for bit across the step counter's int32 wrap, float32 within 1e-4 over
    the window."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import plastic
    rng = np.random.default_rng(27)
    b, n, d, k = 8, 128, 64, 4
    cfg = get_smoke("qwen3-4b").with_(
        d_model=d, dtype="float32", plastic_adapter=True,
        adapter_neurons=n, adapter_quant=quant)
    params = _on(cuda_device,
                 p_in=rng.normal(0, 0.6, (d, n)).astype(np.float32),
                 p_out=rng.normal(0, 0.3, (n, d)).astype(np.float32),
                 theta=rng.normal(0, 0.02, (4, n, n)).astype(np.float32),
                 scale=np.float32(0.5))
    state = _adapter_state(rng, quant, b, n, cuda_device)
    h = torch.from_numpy(rng.normal(0, 1, (b, k, d)).astype(np.float32)
                         ).to(cuda_device)
    active = torch.ones(b, dtype=torch.bool, device=cuda_device)
    active[5] = False
    launches = TF.rollout.launches
    got_h, got = plastic.decode_rollout(params, state, h, cfg, active=active)
    torch.cuda.synchronize()
    assert TF.rollout.launches == launches + 1
    assert TF.rollout.last_plan["tile"] == (8 if quant else 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TF, "rollout", lambda *a, block_b=None, **kw:
                   TF.rollout_plain(*a, **kw))
        want_h, want = plastic.decode_rollout(params, state, h, cfg,
                                              active=active)
        mp.setattr(TK, "fleet_step", TK.fleet_step_plain)
        mp.setattr(TK, "fleet_step_q", TK.fleet_step_q_plain)
        s, outs = state, []
        for i in range(k):
            o, s = plastic.decode_step(params, s, h[:, i:i + 1], cfg,
                                       active=active)
            outs.append(o)
    for ref_h, ref in ((want_h, want), (torch.cat(outs, 1), s)):
        for key in ref:
            if quant and key != "v1":
                assert torch.equal(got[key], ref[key]), key
            else:
                torch.testing.assert_close(got[key], ref[key], rtol=1e-4,
                                           atol=1e-4)
            assert torch.equal(got[key][5], state[key][5]), key
        torch.testing.assert_close(got_h, ref_h, rtol=1e-4, atol=1e-4)
    wrapped = 2 ** 31 - 2 + k - 2 ** 32             # int32 arithmetic
    assert got["t"].tolist() == [2 ** 31 - 2 if i == 5 else wrapped
                                 for i in range(b)]


@pytest.mark.cuda
def test_lm_pool_on_card(cuda_device):
    """A smoke `LMScheduler` on the card with an int8 adapter: a vacant
    slot's row stays bit-frozen over steps and a window, the window (one
    rollout launch) equals as many steps (one fleet-step launch each) in
    tokens and session bit for bit."""
    from repro_torch.checkpoint import manager as TM
    from repro_torch.models import factory
    from repro_torch.serving import LMScheduler
    model = factory.build("qwen3-4b", smoke=True, plastic_adapter=True,
                          adapter_neurons=8, adapter_quant=True)
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    params["adapter"]["scale"].fill_(0.5)
    rng = np.random.default_rng(3)
    prompts = {u: rng.integers(0, model.cfg.vocab, n)
               for u, n in (("a", 6), ("b", 4), ("c", 5))}

    def pool():
        s = LMScheduler(model, params, slots=3, max_len=32)
        for u in "abc":
            s.admit_prompt(u, prompts[u])
        s.evict("b")
        return s

    a, b = pool(), pool()
    frozen = a._take(a.pool, 1)
    first = {u: a.pending(u) for u in "ac"}
    steps = TK.fleet_step_q.launches
    seq = [a.step() for _ in range(3)]
    assert TK.fleet_step_q.launches == steps + 3
    windows = {u: np.array([first[u]] + [t[u] for t in seq[:-1]])
               for u in "ac"}
    launches = TF.rollout.launches
    out = b.decode_window(windows)
    assert TF.rollout.launches == launches + 1
    for u in "ac":
        assert out[u].argmax(-1).tolist() == [t[u] for t in seq]
        for x, y in zip(TM.flatten(a.session_view(u))[1],
                        TM.flatten(b.session_view(u))[1]):
            assert torch.equal(x, y)
    for s in (a, b):
        for x, y in zip(TM.flatten(frozen)[1],
                        TM.flatten(s._take(s.pool, 1))[1]):
            assert torch.equal(x, y)


def _moe_smoke(arch, dev, dtype="float32", **over):
    """A MoE smoke model (deepseek-moe-16b: a dense first layer, then
    routed and shared experts; grok-1-314b: 4 experts top-2) and its
    parameters drawn on ``dev`` from seed 0."""
    from repro_torch.models import factory
    model = factory.build(arch, smoke=True, dtype=dtype, **over)
    return model, model.init(torch.Generator(dev).manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("deepseek-moe-16b", "grok-1-314b"))
def test_moe_on_card(cuda_device, arch):
    """A MoE smoke LM's prefill and 4 decode steps in float32 on the card
    against the same code on the CPU (the same parameters and tokens):
    every layer's expert choices and kept assignments equal, the logits
    within 1e-4 of the largest; the prefill launches the attention kernel
    once a layer and silu once an MLP or routed-expert FFN and once more
    for shared experts."""
    from repro_torch.checkpoint import manager as TM
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.models import layers as ML, moe as MoE
    model, params = _moe_smoke(arch, cuda_device)
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (3, 24))).to(cuda_device)

    def run(p, t):
        routes, real = [], MoE.route
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(MoE, "route", lambda *a, **kw: routes.append(
                real(*a, **kw)) or routes[-1])
            logits, cache = model.prefill(p, t[:, :20], 24)
            outs = [logits]
            for i in range(20, 24):
                logits, cache = model.decode_step(p, cache, t[:, i:i + 1])
                outs.append(logits)
        return outs, routes

    attn, silu = TA.flash_attention.launches, ML.silu.launches
    got, got_r = run(params, toks)
    torch.cuda.synchronize()
    n_moe = cfg.n_layers - cfg.moe.first_dense
    assert TA.flash_attention.launches == attn + cfg.n_layers
    per_step = cfg.moe.first_dense + n_moe * (2 if cfg.moe.n_shared else 1)
    assert ML.silu.launches == silu + 5 * per_step
    want, want_r = run(TM.tree_map(lambda t: t.cpu(), params), toks.cpu())
    assert len(got_r) == len(want_r) == 5 * n_moe
    for a, b in zip(got_r, want_r):
        for name in ("expert_idx", "keep", "row", "tok"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_moe_block_is_deterministic_on_card(cuda_device, dtype):
    """Two runs of a MoE FFN on the card at 64 experts top-6 over 2048
    tokens (drops at the default capacity) give the same bits: the
    combine sums each token's contributions in a fixed order, with no
    atomics."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MoE
    from repro_torch.models.layers import init_from_plan, rms_norm
    full = get_config("deepseek-moe-16b")
    cfg = full.with_(d_model=256, dtype=str(dtype).split(".")[1],
                     moe=dataclasses.replace(full.moe, d_expert=128))
    params = init_from_plan(MoE.plan(cfg),
                            torch.Generator(cuda_device).manual_seed(0))
    x = torch.randn(2, 1024, 256, generator=torch.Generator(
        cuda_device).manual_seed(1), device=cuda_device).to(dtype)
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    runs = [MoE.apply(params, x, h, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    r = MoE.route(h, params["router"], cfg)
    assert not bool(r.keep.all())
    assert torch.equal(runs[0].view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                       runs[1].view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32))


@pytest.mark.cuda
def test_moe_pool_vacant_slot_on_card(cuda_device):
    """deepseek-moe-16b's smoke `LMScheduler` on the card at the default
    capacity with an int8 adapter, slot 0 vacant: whatever token it holds,
    the active streams' tokens and sessions are bit for bit the same and
    the vacant row stays frozen."""
    from repro_torch.checkpoint import manager as TM
    from repro_torch.serving import LMScheduler
    model, params = _moe_smoke("deepseek-moe-16b", cuda_device,
                               plastic_adapter=True, adapter_neurons=8,
                               adapter_quant=True)
    params["adapter"]["scale"].fill_(0.5)
    rng = np.random.default_rng(3)
    prompts = {u: rng.integers(0, model.cfg.vocab, 6)
               for u in ("gone", "a", "b")}

    def run(vacant_tok):
        s = LMScheduler(model, params, slots=3, max_len=24)
        for u in ("gone", "a", "b"):
            s.admit_prompt(u, prompts[u])
        s.evict("gone")
        s.pool["tok"][0] = vacant_tok
        frozen = s._take(s.pool, 0)
        toks = [s.step() for _ in range(3)]
        for x, y in zip(TM.flatten(frozen)[1],
                        TM.flatten(s._take(s.pool, 0))[1]):
            assert torch.equal(x, y)
        return toks, [TM.flatten(s.session_view(u))[1] for u in "ab"]

    base_toks, base = run(0)
    for tok in (1, 300, 511):
        toks, sessions = run(tok)
        assert toks == base_toks
        for got, want in zip(sessions, base):
            assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("qwen3-4b", "deepseek-moe-16b",
                                  "zamba2-7b"))
def test_kv_quant_on_card(cuda_device, arch):
    """The int8 KV cache (``kv_quant``) of a smoke LM in float32 on the
    card against the same code on the CPU (the same parameters and
    tokens): a prefill and 4 decode steps give the same greedy tokens,
    logits within 5e-4 of the largest (a code that rounds the other way
    at a tie moves them by ~1e-4 of it), the cache's codes equal but at
    most 1e-3 of them, each off by one, and its scales within 1e-5; the
    prefill launches the attention kernel once an attention block."""
    import dataclasses
    from repro_torch.checkpoint import manager as TM
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.models import factory
    from repro_torch.models.transformer import segments
    model = factory.build(arch, smoke=True, dtype="float32", kv_quant=True)
    cfg = model.cfg
    if cfg.moe is not None:
        model = factory.build(cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts))))
        cfg = model.cfg
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 24))).to(cuda_device)

    def run(p, t):
        logits, cache = model.prefill(p, t[:, :20], 24)
        outs = [logits]
        for i in range(20, 24):
            logits, cache = model.decode_step(p, cache, t[:, i:i + 1])
            outs.append(logits)
        return outs, cache

    attn = TA.flash_attention.launches
    got, gcache = run(params, toks)
    torch.cuda.synchronize()
    assert TA.flash_attention.launches == attn + sum(
        n for kind, n in segments(cfg) if kind != "ssm")
    want, wcache = run(TM.tree_map(lambda t: t.cpu(), params), toks.cpu())
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 5e-4 * scale
        assert torch.equal(g.cpu().argmax(-1), w.argmax(-1))
    differ = total = 0
    for gs, ws in zip(gcache["segments"], wcache["segments"]):
        if "k" not in gs:
            continue
        for name in ("k", "v"):
            a, b = gs[name].cpu(), ws[name]
            assert a.dtype == torch.int8
            differ += int((a != b).sum())
            total += a.numel()
            assert int((a.int() - b.int()).abs().max()) <= 1
            torch.testing.assert_close(gs[f"{name}_scale"].cpu(),
                                       ws[f"{name}_scale"], rtol=1e-5,
                                       atol=0)
    assert differ <= 1e-3 * total


@pytest.mark.cuda
def test_int8_cache_session_round_trip_on_card(cuda_device, tmp_path):
    """An int8-cache LM session on the card (zamba2-7b's smoke layout:
    int8 K/V with scale planes beside SSM states) leaves a pool through a
    disk `SessionStore` and comes back bit for bit into another slot,
    decodes on, and a vacant slot's codes and scales stay frozen."""
    from repro_torch.checkpoint import manager as TM
    from repro_torch.models import factory
    from repro_torch.serving import LMScheduler, SessionStore
    model = factory.build("zamba2-7b", smoke=True, kv_quant=True,
                          plastic_adapter=True, adapter_neurons=8,
                          adapter_quant=True)
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    params["adapter"]["scale"].fill_(0.5)
    rng = np.random.default_rng(4)
    prompts = {u: rng.integers(0, model.cfg.vocab, 6) for u in "abc"}
    s = LMScheduler(model, params, slots=4, max_len=24,
                    store=SessionStore(root=str(tmp_path)))
    for u in "abc":
        s.admit_prompt(u, prompts[u])
    frozen = s._take(s.pool, 3)
    for _ in range(2):
        s.step()
    before = s.session_view("a")
    assert before["cache"]["segments"][0]["k"].dtype == torch.int8
    s.evict("a")
    s.evict("b")
    s.store._warm.clear()
    s.admit_prompt("b", prompts["b"])              # back into slot 0
    slot = s.admit_prompt("a", prompts["a"])
    assert slot == 1 and s.store.restores == 2
    for x, y in zip(TM.flatten(before)[1],
                    TM.flatten(s.session_view("a"))[1]):
        assert x.device.type == cuda_device.type and torch.equal(x, y)
    s.step()
    for x, y in zip(TM.flatten(frozen)[1], TM.flatten(s._take(s.pool,
                                                              3))[1]):
        assert torch.equal(x, y)


# ---- training: the backward kernels and a train step ------------------------

# (B, Sq, Skv, H, HKV, D, kv_len, packed): ragged lengths, GQA 4:1, the
# padded widths (D = 112 runs at 128, 16-32 at 64), queries at the last Sq
# of more keys; keys hidden from kv_len on; q, k, v cut as strided views of
# one packed (B, S, H + 2 HKV, D) projection; and at D = 128 an Sq that is
# no multiple of the bf16 kernels' 64- and 128-row tiles
ATTN_BWD_CASES = [(2, 70, 70, 4, 2, 16, None, False),
                  (1, 50, 50, 5, 5, 24, None, False),
                  (2, 90, 90, 8, 2, 32, None, False),
                  (1, 40, 100, 4, 2, 64, None, False),
                  (1, 130, 130, 4, 4, 112, None, False),
                  (1, 300, 300, 8, 2, 128, None, False),
                  (2, 260, 260, 8, 2, 128, 190, False),
                  (1, 200, 200, 8, 2, 128, None, True),
                  (1, 333, 333, 4, 1, 128, None, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain_on_card(case, dtype,
                                                          cuda_device):
    """`flash_attention_bwd` (csrc/flash_attention_bwd.cu) against
    `flash_attention_bwd_plain` on the same q, k, v, o, lse and dO (the
    forward kernel's o and lse): float32 within 1e-5 of each gradient's
    largest |x|, bf16 within rtol 2e-2 / atol 2e-3; a second launch gives
    the same bits (no atomics).  The forward kernel's lse is the plain
    one's within 1e-4."""
    from repro_torch.kernels.attention import kernel as TA
    b, sq, skv, h, hkv, d, kv_len, packed = case
    gen = torch.Generator(cuda_device).manual_seed(sq + d)
    if packed:
        qkv = torch.randn(b, sq, h + 2 * hkv, d, generator=gen,
                          device=cuda_device).to(dtype)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
        assert not q.is_contiguous() and not k.is_contiguous()
    else:
        q = torch.randn(b, sq, h, d, generator=gen,
                        device=cuda_device).to(dtype)
        k, v = (torch.randn(b, skv, hkv, d, generator=gen,
                            device=cuda_device).to(dtype) for _ in range(2))
    do = torch.randn(b, sq, h, d, generator=gen, device=cuda_device
                     ).to(dtype)
    o, lse = TA._forward(q, k, v, True, None, kv_len, with_lse=True)
    _, lse_plain = TA._ref.mha_lse(q, k, v, causal=True, kv_len=kv_len)
    torch.testing.assert_close(lse, lse_plain, rtol=1e-4, atol=1e-4)
    n = TA.flash_attention.bwd_launches
    got = TA.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                 kv_len=kv_len)
    again = TA.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                   kv_len=kv_len)
    assert TA.flash_attention.bwd_launches == n + 2
    want = TA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                        kv_len=kv_len)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        if dtype == torch.float32:
            assert (g - w).abs().max() <= 1e-5 * w.abs().max()
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-3)


@pytest.mark.cuda
def test_flash_attention_autograd_on_card(cuda_device):
    """Under autograd the wrapper launches the forward (with lse) and,
    on backward, the backward kernel: one launch each."""
    from repro_torch.kernels.attention import kernel as TA
    gen = torch.Generator(cuda_device).manual_seed(3)
    q, k, v = (torch.randn(1, 64, 4, 64, generator=gen, device=cuda_device,
                           dtype=torch.float32).requires_grad_()
               for _ in range(3))
    n, nb = TA.flash_attention.launches, TA.flash_attention.bwd_launches
    TA.flash_attention(q, k, v).square().sum().backward()
    assert (TA.flash_attention.launches, TA.flash_attention.bwd_launches) \
        == (n + 1, nb + 1)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    TA.flash_attention_plain(*leaves).square().sum().backward()
    for a, w in zip((q, k, v), leaves):
        assert (a.grad - w.grad).abs().max() <= 1e-5 * w.grad.abs().max()


# (shape, dtype, column offset of a strided view or None): the vector
# path, a ragged width on the scalar path, rows at a stride
SILU_BWD_CASES = [((4, 96, 256), "bfloat16", None),
                  ((4, 96, 256), "float32", None),
                  ((3, 77), "bfloat16", 5),
                  ((3, 77), "float32", None),
                  ((2, 33, 130), "bfloat16", 2),
                  ((4096, 9728), "bfloat16", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SILU_BWD_CASES)
def test_silu_bwd_kernel_matches_plain_on_card(case, cuda_device):
    """`layers.silu_bwd` (csrc/silu.cu's second entry) equals
    `silu_bwd_plain` bit for bit, and the autograd Function around `silu`
    launches the forward and backward kernels once each."""
    from repro_torch.models import layers as ML
    shape, dt, offset = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(cuda_device).manual_seed(7)
    wide = (4 * torch.randn(*shape[:-1], 2 * shape[-1] + 7, generator=gen,
                            device=cuda_device)).to(dtype)
    g = (wide[..., :shape[-1]].contiguous() if offset is None
         else wide[..., offset:offset + shape[-1]])
    u = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    n = ML.silu.bwd_launches
    got = ML.silu_bwd(g, u, dy)
    assert ML.silu.bwd_launches == n + 1
    want = ML.silu_bwd_plain(g, u, dy)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    xg = g.detach().clone().requires_grad_()
    xu = u.detach().clone().requires_grad_()
    f, b = ML.silu.launches, ML.silu.bwd_launches
    ML.silu(xg, xu).backward(dy)
    assert (ML.silu.launches, ML.silu.bwd_launches) == (f + 1, b + 1)
    assert torch.equal(xg.grad, want[0])
    assert torch.equal(xu.grad, want[1])


@pytest.mark.cuda
def test_silu_mamba2_backward_forms_on_card(cuda_device):
    """silu's two Mamba2 forms under autograd on the card: the conv's
    ``silu(x)`` (float32 and bf16) and the gate's ``silu(z, y, float32)``
    (bf16): one forward and one backward launch each, the gradients bit
    for bit `silu_bwd_plain`'s (the gate's float32 output gradient rounded
    to bf16 first)."""
    from repro_torch.models import layers as ML
    gen = torch.Generator(cuda_device).manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        x, u, dy = (torch.randn(300, 96, generator=gen, device=cuda_device)
                    .mul_(s).to(dtype) for s in (4, 1, 0.5))
        xg = x.clone().requires_grad_()
        f, b = ML.silu.launches, ML.silu.bwd_launches
        ML.silu(xg).backward(dy)
        assert (ML.silu.launches, ML.silu.bwd_launches) == (f + 1, b + 1)
        dx, du = ML.silu_bwd_plain(x, None, dy)
        assert du is None and torch.equal(xg.grad, dx)
        if dtype != torch.bfloat16:
            continue
        xg, ug = (t.clone().requires_grad_() for t in (x, u))
        d32 = torch.randn(300, 96, generator=gen, device=cuda_device)
        ML.silu(xg, ug, torch.float32).backward(d32)
        want = ML.silu_bwd_plain(x, u, d32.to(dtype))
        assert torch.equal(xg.grad, want[0]) and torch.equal(ug.grad, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_train_step_on_card_matches_plain(cuda_device, arch):
    """The smoke config (qwen3-4b: 2 dense layers; deepseek-moe-16b: a
    dense layer, then 2 MoE layers) with remat on: in float32 the loss and
    every gradient leaf with the kernels against the plain path (the plain
    attention and silu, and the MoE dispatch and combine as indexing,
    differentiated by autograd), loss within 1e-5 relative and each leaf
    within 1e-4 of its largest |g|; #7 twice a layer (the forward and its
    recompute) and its backward once, silu twice a SwiGLU (the dense MLPs,
    each MoE layer's routed and shared experts) and its backward once.
    For the MoE layout, in bf16 the backward run twice gives the same bits
    (the dispatch's and combine's backwards use no atomics)."""
    from unittest import mock
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.launch import steps
    from repro_torch.models import attention as MA, factory, layers as ML
    from repro_torch.models import moe as MoE

    dtypes = ("float32", "bfloat16") if arch == "deepseek-moe-16b" else (
        "float32",)
    for dtype in dtypes:
        cfg = get_smoke(arch).with_(dtype=dtype, remat=True)
        params = factory.build(cfg).init(
            torch.Generator(cuda_device).manual_seed(0))
        gen = torch.Generator(cuda_device).manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (2, 48), generator=gen,
                             device=cuda_device)
        batch = {"inputs": toks, "labels": torch.roll(toks, -1, 1)}

        def run():
            tree, slots = steps._layer_leaves(params)
            loss = steps.make_loss_fn(cfg)(tree, batch)
            loss.backward()
            return loss.detach(), [t.grad for t, _ in slots]

        counts = lambda: (TA.flash_attention.launches,  # noqa: E731
                          TA.flash_attention.bwd_launches, ML.silu.launches,
                          ML.silu.bwd_launches)
        before = counts()
        loss, grads = run()
        after = counts()
        n = cfg.n_layers
        mlps = n
        if cfg.moe is not None and cfg.moe.n_shared:
            mlps += n - cfg.moe.first_dense
        assert tuple(a - b for a, b in zip(after, before)) == (
            2 * n, n, 2 * mlps, mlps)
        if dtype == "bfloat16":
            again, grads2 = run()
            assert torch.equal(loss, again)
            assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
            continue
        with mock.patch.object(MA, "attn_op", TA.flash_attention_plain), \
                mock.patch.object(ML, "silu", ML.silu_plain), \
                mock.patch.object(MoE, "dispatch", MoE.dispatch_plain), \
                mock.patch.object(MoE, "combine", MoE.combine_plain):
            loss_p, grads_p = run()
        assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
        for g, w in zip(grads, grads_p):
            assert (g - w).abs().max() <= 1e-4 * w.abs().max()


SSD_BWD_CASES = [(1, 4096, 64, 64, 128, 1), (1, 1000, 112, 64, 64, 1),
                 (2, 100, 4, 64, 128, 2), (3, 70, 4, 16, 16, 1),
                 (2, 150, 4, 36, 64, 2), (1, 1, 2, 64, 128, 1),
                 (1, 1300, 14, 36, 128, 2), (1, 1500, 14, 64, 128, 2)]


def _bf16_step(t):
    m = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_matches_plain_on_card(dtype, cuda_device):
    """#8's backward (``csrc/ssd_bwd.cu``) on x, B and C cut from a packed
    projection, every `SSD_BWD_CASES` shape (mamba2-1.3b's and zamba2-7b's
    training heads, G = 2, ragged L, a 36-wide head, L = 1, and 7 heads a
    group in slabs of 3 and of 4, whose last slab they do not fill: the
    bf16 plan at 132 SMs), with and
    without a final-state gradient: a second launch the same bits; against
    `ssd_scan_bwd_plain` float32 dx, dB, dC within 1e-5 of each one's
    largest |g|, bf16 within one bf16 step; ddt and da (float32 in both)
    within 1e-4: each ends in a float32 sum over many terms that the
    kernel adds in another order (da over B x L; each ddt through its
    chunk's <S_in, dS_out> over S x P), measured 1.7e-5 of the largest
    |da| at B = 2, L = 100 on the card.  The bf16 kernels spill nothing."""
    from repro_torch.kernels.ssd import kernel as TS
    gen = torch.Generator(cuda_device).manual_seed(12)
    if dtype == torch.bfloat16:
        sms = TS._sms(cuda_device)
        assert any((h // g) % TS.bwd_plan(b, length, h, g, p, s,
                                          sms=sms)["heads_a_cta"]
                   for b, length, h, p, s, g in SSD_BWD_CASES)
    for k, (b, length, h, p, s, g) in enumerate(SSD_BWD_CASES):
        x, dt, a, bm, cm = _ssd_inputs(gen, b, length, h, p, s, g, dtype,
                                       cuda_device)
        dy = torch.randn(b, length, h, p, generator=gen,
                         device=cuda_device).to(dtype)
        ds = (torch.randn(b, h, s, p, generator=gen, device=cuda_device)
              if k % 2 else None)
        n = TS.ssd_scan.bwd_launches
        got = TS.ssd_scan_bwd(x, dt, a, bm, cm, dy, ds)
        again = TS.ssd_scan_bwd(x, dt, a, bm, cm, dy, ds)
        assert TS.ssd_scan.bwd_launches == n + 2
        want = TS.ssd_scan_bwd_plain(x, dt, a, bm, cm, dy, ds)
        torch.cuda.synchronize()
        for name, u, v, w in zip(("dx", "ddt", "da", "dB", "dC"), got,
                                 again, want):
            assert torch.equal(u, v), name
            assert u.dtype == w.dtype and u.shape == w.shape, name
            err = float((u.double() - w.double()).abs().max())
            tol = (_bf16_step(w) if u.dtype == torch.bfloat16
                   else (1e-4 if name in ("ddt", "da") else 1e-5)
                   * float(w.abs().max()))
            assert err <= tol, f"{name} at {(b, length, h, p, s, g)}: " \
                f"{err} > {tol}"
    if dtype == torch.bfloat16:
        usage = TS.ssd_scan_bwd_attrs()
        assert set(usage) == set(TS.BWD_KERNELS)
        assert all(u["local_bytes"] == 0 for u in usage.values()), usage


@pytest.mark.cuda
def test_ssd_autograd_launches_the_backward_on_card(cuda_device):
    """Under autograd `ssd_scan` on the card launches the forward kernel
    once and the backward kernel once, and its gradients are the
    backward kernel's bits."""
    from repro_torch.kernels.ssd import kernel as TS
    gen = torch.Generator(cuda_device).manual_seed(13)
    x, dt, a, bm, cm = _ssd_inputs(gen, 1, 200, 4, 64, 128, 1,
                                   torch.bfloat16, cuda_device)
    dy = torch.randn(x.shape, generator=gen, device=cuda_device).to(x.dtype)
    ins = [t.detach().clone().requires_grad_() for t in (x, dt, a, bm, cm)]
    f, b = TS.ssd_scan.launches, TS.ssd_scan.bwd_launches
    y, _ = TS.ssd_scan(*ins)
    y.backward(dy)
    assert (TS.ssd_scan.launches, TS.ssd_scan.bwd_launches) == (f + 1, b + 1)
    want = TS.ssd_scan_bwd(*(t.detach() for t in ins), dy)
    for t, w in zip(ins, want):
        assert torch.equal(t.grad, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_ssm_train_step_on_card_matches_plain(arch, cuda_device):
    """The smoke config (2 Mamba2 layers; zamba2's: 2 super-blocks of the
    shared block and 2 Mamba2 blocks) in float32, remat on: the loss and
    every gradient leaf with the kernels against the plain path (the
    plain SSD scan, attention and silu, differentiated by autograd), loss
    within 1e-5 relative and each leaf within 1e-4 of its largest |g|;
    each Mamba2 block launches #8 twice (the forward and its recompute)
    and its backward once, silu 4 times and its backward twice."""
    from unittest import mock
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.launch import steps
    from repro_torch.models import attention as MA, factory, layers as ML
    from repro_torch.models import ssm as MS
    from repro_torch.kernels.ssd import kernel as TS
    cfg = get_smoke(arch).with_(dtype="float32", remat=True)
    params = factory.build(cfg).init(
        torch.Generator(cuda_device).manual_seed(0))
    gen = torch.Generator(cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=gen,
                         device=cuda_device)
    batch = {"inputs": toks, "labels": torch.roll(toks, -1, 1)}

    def run():
        tree, slots = steps._layer_leaves(params)
        loss = steps.make_loss_fn(cfg)(tree, batch)
        loss.backward()
        return loss.detach(), [t.grad for t, _ in slots]

    def counts():
        return (TS.ssd_scan.launches, TS.ssd_scan.bwd_launches,
                ML.silu.launches, ML.silu.bwd_launches)

    before = counts()
    loss, grads = run()
    got = tuple(x - y for x, y in zip(counts(), before))
    n_mlp = 0 if cfg.layout == "ssm" else cfg.n_layers // cfg.ssm.attn_every
    n_ssm = cfg.n_layers - n_mlp
    assert got == (2 * n_ssm, n_ssm, 4 * n_ssm + 2 * n_mlp,
                   2 * n_ssm + n_mlp)
    with mock.patch.object(MA, "attn_op", TA.flash_attention_plain), \
            mock.patch.object(MS, "ssd_op", TS.ssd_scan_plain), \
            mock.patch.object(MS, "silu", ML.silu_plain), \
            mock.patch.object(ML, "silu", ML.silu_plain):
        loss_p, grads_p = run()
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for g, w in zip(grads, grads_p):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


# (elements, param dtype, grad dtype, moment dtype, master copy, clipped,
# weight decay): a ragged length on each dtype mix, the step's own mix
# (bf16 params, float32 grads and moments) at a leaf's size
ADAMW_CASES = [(1000003, "bfloat16", "float32", "float32", False, True,
                0.1),
               (4097, "float32", "float32", "float32", True, False, 0.0),
               (777, "bfloat16", "bfloat16", "bfloat16", True, True, 0.1),
               (5, "float32", "bfloat16", "bfloat16", False, False, 0.1),
               (2560 * 9728, "bfloat16", "float32", "float32", False, True,
                0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ADAMW_CASES)
def test_adamw_kernel_matches_plain_on_card(case, cuda_device):
    """`adamw_leaf` (csrc/adamw.cu) equals `adamw_leaf_plain` bit for bit
    on the parameter, both moments and the master copy, two steps in a
    row, one launch each."""
    from repro_torch.optim import optimizers as O
    n, pdt, gdt, mdt, master, clipped, wd = case
    gen = torch.Generator(cuda_device).manual_seed(n)

    def rand(dt, s=1.0):
        return (s * torch.randn(n, generator=gen, device=cuda_device)).to(
            getattr(torch, dt))

    p = rand(pdt)
    w = p.float().clone() if master else None
    m, v = rand(mdt, 1e-2), rand(mdt, 1e-2).square()
    states = [[t.clone() if t is not None else None for t in (p, m, v, w)]
              for _ in range(2)]
    for step in (1, 2):
        g = rand(gdt, 3e-3)
        st = torch.full((), step, dtype=torch.float32, device=cuda_device)
        kw = dict(scale=(torch.rand((), generator=gen, device=cuda_device)
                         if clipped else None),
                  bc1=1 - 0.9 ** st, bc2=1 - 0.95 ** st,
                  lr=torch.full((), 3e-4 * step, device=cuda_device),
                  b1=0.9, b2=0.95, eps=1e-8, wd=wd)
        launches = O.adamw_leaf.launches
        O.adamw_leaf(states[0][0], g, *states[0][1:], **kw)
        assert O.adamw_leaf.launches == launches + 1
        O.adamw_leaf_plain(states[1][0], g, *states[1][1:], **kw)
        torch.cuda.synchronize()
        for a, b in zip(*states):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_adamw_update_launches_once_per_leaf_on_card(cuda_device):
    """`adamw.update` on a tree on the card: one kernel launch a leaf, and
    the tree the plain update makes, bit for bit."""
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.optim import optimizers as O
    gen = torch.Generator(cuda_device).manual_seed(3)
    shapes = {"a": (33, 17), "b": {"c": (4, 8, 16), "d": (7,)}}

    def tree(dt, s=1.0):
        def make(sh):
            if isinstance(sh, dict):
                return {k: make(x) for k, x in sh.items()}
            return (s * torch.randn(sh, generator=gen,
                                    device=cuda_device)).to(dt)
        return make(shapes)

    params = tree(torch.bfloat16)
    opt = adamw(lr=warmup_cosine(1e-3, 1, 4))
    state = opt.init(params)
    twin = O.flatten(params)
    plain_p = O.unflatten(params, [t.clone() for t in twin[1]])
    plain_s = opt.init(plain_p)
    for _ in range(2):
        grads = tree(torch.float32, 1e-2)
        n = O.adamw_leaf.launches
        params, state = opt.update(grads, state, params)
        assert O.adamw_leaf.launches == n + 3
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(O, "adamw_leaf", O.adamw_leaf_plain)
            plain_p, plain_s = opt.update(grads, plain_s, plain_p)
    for a, b in zip(O.flatten((params, state.mu, state.nu))[1],
                    O.flatten((plain_p, plain_s.mu, plain_s.nu))[1]):
        assert torch.equal(a, b)
