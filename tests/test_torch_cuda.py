"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and ``nvcc``, and skips elsewhere.  The
file imports neither JAX nor the JAX package (the plain versions are held
against JAX by the other ``test_torch_*`` files on the CPU), so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

int8 is held bit for bit; float32 within rtol = atol = 1e-5 (the kernels sum
the psum in fan-in order, the plain versions as a batched product).  The
attention kernel's bfloat16 output within rtol 2e-2, atol 2e-3: both compute
in float32 and round once, so they differ by at most a bf16 step where the
float32 sums straddle a rounding boundary.  The SSD scan walks the sequence
in other sub-blocks than the plain chunked form, so float32 is held within
rtol = atol = 2e-3 (the JAX package's bound between its chunked form and
the recurrence) and bfloat16 y within one bf16 step of the largest |y|.
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


# (N, M, spiking, teach, active): M = 200 is not a multiple of 128
STEP_CASES = [(6, 2, True, None, False), (8, 128, True, None, True),
              (16, 200, True, "per-stream", False),
              (128, 8, False, None, True), (12, 5, False, "shared", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_fleet_step_kernels_match_plain_on_card(quant, cuda_device):
    rng = np.random.default_rng(11)
    wrapper = TK.fleet_step_q if quant else TK.fleet_step
    launches = wrapper.launches
    for n, m, spiking, teach, masked in STEP_CASES:
        tshape = {"per-stream": (B, m), "shared": (m,)}.get(teach)
        if quant:
            t = _on(cuda_device,
                    x=rng.choice([0, 256], (B, n)).astype(np.int32),
                    w=rng.integers(-127, 128, (B, n, m)).astype(np.int8),
                    v=rng.integers(-600, 600, (B, m)).astype(np.int32),
                    tpre=rng.integers(0, 1200, (B, n)).astype(np.int32),
                    tpost=rng.integers(-300, 1200, (B, m)).astype(np.int32),
                    scale=np.where(np.arange(B) % 2 == 0, 1 / 32,
                                   1 / 16).astype(np.float32),
                    seed=rng.integers(-2 ** 31, 2 ** 31, B).astype(np.int32),
                    teach=None if tshape is None else rng.integers(
                        -300, 300, tshape).astype(np.int32))
        else:
            t = _on(cuda_device,
                    x=(rng.random((B, n)) < 0.4).astype(np.float32),
                    w=rng.uniform(-1, 1, (B, n, m)).astype(np.float32),
                    v=rng.standard_normal((B, m)).astype(np.float32),
                    tpre=(rng.random((B, n)) * 3).astype(np.float32),
                    tpost=(rng.random((B, m)) * 3).astype(np.float32),
                    teach=None if tshape is None else (
                        rng.standard_normal(tshape) * 0.5).astype(np.float32))
        theta = torch.from_numpy((rng.standard_normal((4, n, m)) * 0.02)
                                 .astype(np.float32)).to(cuda_device)
        active = (torch.from_numpy(ACTIVE).to(cuda_device) if masked
                  else None)
        kw = dict(spiking=spiking, teach=t["teach"], active=active)
        if quant:
            args = (t["x"], t["w"], t["scale"], theta, t["v"], t["tpre"],
                    t["tpost"])
            kw.update(qcfg=TQ.QuantConfig(), seed=t["seed"])
            got, want = TK.fleet_step_q(*args, **kw), \
                TK.fleet_step_q_plain(*args, **kw)
        else:
            args = (t["x"], t["w"], theta, t["v"], t["tpre"], t["tpost"])
            got, want = TK.fleet_step(*args, **kw), \
                TK.fleet_step_plain(*args, **kw)
        torch.cuda.synchronize()
        _assert_match(got, want, quant)
        if masked:
            off = active == 0
            assert torch.equal(got[3][off], t["w"][off])
    assert wrapper.launches == launches + len(STEP_CASES)


def _network(rng, sizes, quant, dev):
    """A random fleet state; int8 windows start 9 steps before the int32
    wrap of the step counter, so seed + k wraps inside K = 16."""
    n_layers = len(sizes) - 1
    if quant:
        w = [rng.integers(-40, 41, (B, sizes[i], sizes[i + 1]))
             .astype(np.int8) for i in range(n_layers)]
        v = [rng.integers(-300, 300, (B, m)).astype(np.int32)
             for m in sizes[1:]]
        tr = [rng.integers(0, 900, (B, n)).astype(np.int32) for n in sizes]
        sc = [np.where(np.arange(B) % 2 == 0, 1 / 32, 1 / 16)
              .astype(np.float32) for _ in range(n_layers)]
        t0 = 2 ** 31 - 9
    else:
        w = [np.round(rng.uniform(-0.5, 0.5, (B, sizes[i], sizes[i + 1]))
                      * 64).astype(np.float32) / 64 for i in range(n_layers)]
        v = [rng.uniform(-0.5, 0.9, (B, m)).astype(np.float32)
             for m in sizes[1:]]
        tr = [rng.uniform(0, 2, (B, n)).astype(np.float32) for n in sizes]
        sc, t0 = [], 0
    tup = lambda xs: tuple(torch.from_numpy(x).to(dev) for x in xs)
    return TE.NetworkState(w=tup(w), v=tup(v), trace=tup(tr),
                           t=torch.tensor(t0, dtype=torch.int32, device=dev),
                           w_scale=tup(sc))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_rollout_kernel_matches_plain_on_card(quant, cuda_device):
    """int8 bitwise at every K (the step counter wraps inside the window),
    float32 within 1e-5 at K = 1."""
    rng = np.random.default_rng(21)
    qc = TQ.QuantConfig() if quant else None
    for k, sizes, teach in ((1, (8, 32, 4), "per-step"), (4, (6, 4), "held"),
                            (16, (8, 32, 4), None)):
        st = _network(rng, sizes, quant, cuda_device)
        theta = [torch.from_numpy((rng.standard_normal(
            (4, sizes[i], sizes[i + 1])) * 0.02).astype(np.float32))
            .to(cuda_device) for i in range(len(sizes) - 1)]
        if quant:
            drives = rng.integers(-512, 512, (k, B, sizes[0])).astype(np.int32)
            tch = rng.integers(-200, 200, (k, B, sizes[-1])).astype(np.int32)
        else:
            drives = (np.round(rng.standard_normal((k, B, sizes[0])) * 16)
                      / 16).astype(np.float32)
            tch = (rng.standard_normal((k, B, sizes[-1])) * 0.3
                   ).astype(np.float32)
        tch = {None: None, "per-step": tch, "held": tch[0]}[teach]
        t = _on(cuda_device, drives=drives, teach=tch, active=ACTIVE)
        params = [TE.EngineParams(
            spiking=i < len(sizes) - 2, quant=qc, tau_m=2.0,
            trace_decay=0.75 if quant else 0.8)
            for i in range(len(sizes) - 1)]
        kw = dict(params=params, teach=t["teach"], active=t["active"])
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
# the 8-column tile; 784 -> 1024 and 1024 -> 10 are the MNIST layers
SHARED_CASES = [(1, 8, 8, True, False, True), (3, 17, 257, True, True, True),
                (2, 100, 130, True, False, False),
                (1, 784, 1024, True, False, True),
                (8, 784, 1024, True, False, True),
                (1, 1024, 10, True, True, True),
                (4, 33, 12, False, True, True)]


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


LIF_SHAPES = [(2, 16, 16), (4, 200, 64), (1, 784, 1024), (8, 130, 250)]


@pytest.mark.cuda
def test_lif_forward_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(41)
    launches = TL.lif_forward.launches
    for b, k, m in LIF_SHAPES:
        t = _on(cuda_device, x=(rng.random((b, k)) < 0.5).astype(np.float32),
                w=(np.round(rng.standard_normal((k, m)) * 64) / 64
                   * k ** -0.5).astype(np.float32),
                v=(rng.standard_normal((b, m)) * 0.1).astype(np.float32),
                tr=rng.random((b, m)).astype(np.float32))
        args = (t["x"], t["w"], t["v"], t["tr"])
        got = TL.lif_forward(*args)
        want = TL.lif_forward_plain(*args)
        torch.cuda.synchronize()
        _assert_match(got, want, False)
    assert TL.lif_forward.launches == launches + len(LIF_SHAPES)
    with pytest.raises(ValueError):
        TL.lif_forward(*(a.to(torch.bfloat16) for a in args))


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
    """The cooperative shared-weight window: int8 bitwise at every K (the
    step counter wraps inside K = 16), float32 within 1e-5 at K = 1;
    batched and unbatched, with and without a teaching current."""
    rng = np.random.default_rng(51)
    qc = TQ.QuantConfig() if quant else None
    for k, sizes, b, teach in ((1, (8, 32, 4), 3, True),
                               (4, (40, 100, 10), None, True),
                               (16, (8, 32, 4), 2, False),
                               (8, (784, 1024, 10), None, True)):
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
# width 64, and Sq > Skv (rows with no visible key)
ATTN_CASES = [(4, 2048, 2048, 32, 8, 128, True, None),
              (2, 1000, 1000, 32, 8, 128, True, None),
              (4, 1, 2049, 32, 8, 128, True, None),
              (2, 300, 700, 8, 2, 128, True, 650),
              (1, 257, 257, 4, 2, 64, False, 200),
              (1, 80, 50, 4, 4, 64, True, None)]
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


# (B, L, H, P, S, G): one token, a ragged 100 with G = 2, a ragged 300,
# mamba2-1.3b's head (P = 64, S = 128) over an exact 128, and the smoke
# config's small head (P = S = 16)
SSD_CASES = [(2, 1, 4, 64, 128, 1), (2, 100, 4, 64, 128, 2),
             (1, 300, 8, 64, 128, 1), (2, 128, 2, 64, 128, 1),
             (3, 70, 4, 16, 16, 1)]
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
    contiguous copies."""
    from repro_torch.kernels.ssd import kernel as TS
    gen = torch.Generator(cuda_device).manual_seed(11)
    args = _ssd_inputs(gen, 2, 333, 8, 64, 128, 2, torch.bfloat16,
                       cuda_device)
    got = TS.ssd_scan(*args)
    want = TS.ssd_scan(*(t.contiguous() for t in args))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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

def _tel_step_inputs(rng, n, m, quant, dev):
    if quant:
        return _on(dev, x=rng.choice([0, 256], (B, n)).astype(np.int32),
                   w=rng.integers(-127, 128, (B, n, m)).astype(np.int8),
                   v=rng.integers(-600, 600, (B, m)).astype(np.int32),
                   tpre=rng.integers(0, 1200, (B, n)).astype(np.int32),
                   tpost=rng.integers(-300, 1200, (B, m)).astype(np.int32),
                   scale=np.where(np.arange(B) % 2 == 0, 1 / 32,
                                  1 / 16).astype(np.float32),
                   seed=rng.integers(-2 ** 31, 2 ** 31, B).astype(np.int32),
                   teach=rng.integers(-300, 300, (B, m)).astype(np.int32),
                   theta=(rng.standard_normal((4, n, m)) * 0.02
                          ).astype(np.float32))
    return _on(dev, x=(rng.random((B, n)) < 0.4).astype(np.float32),
               w=(np.round(rng.uniform(-1, 1, (B, n, m)) * 64) / 64
                  ).astype(np.float32),
               v=(rng.standard_normal((B, m)) * 0.8).astype(np.float32),
               tpre=(rng.random((B, n)) * 3).astype(np.float32),
               tpost=(rng.random((B, m)) * 3).astype(np.float32),
               teach=(rng.standard_normal((B, m)) * 0.5).astype(np.float32),
               theta=(rng.standard_normal((4, n, m)) * 0.02
                      ).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_fleet_step_telemetry_variant_matches_plain_on_card(quant,
                                                           cuda_device):
    """The telemetry row against the plain version (int8 bit for bit,
    float32 within 2e-4), its state bit for bit against the same launch
    without telemetry, and zeros for vacant slots."""
    rng = np.random.default_rng(41)
    active = torch.from_numpy(ACTIVE).to(cuda_device)
    for n, m, spiking in ((8, 128, True), (128, 8, False), (7, 45, True),
                          (16, 200, False)):
        t = _tel_step_inputs(rng, n, m, quant, cuda_device)
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
    sizes = (8, 128, 8)
    for k in (1, 4, 16):
        st = _network(rng, sizes, quant, cuda_device)
        theta = [torch.from_numpy((rng.standard_normal(
            (4, sizes[i], sizes[i + 1])) * 0.02).astype(np.float32))
            .to(cuda_device) for i in range(len(sizes) - 1)]
        if quant:
            drives = rng.integers(-512, 512, (k, B, sizes[0])).astype(np.int32)
            tch = rng.integers(-200, 200, (B, sizes[-1])).astype(np.int32)
        else:
            drives = (np.round(rng.standard_normal((k, B, sizes[0])) * 16)
                      / 16).astype(np.float32)
            tch = (rng.standard_normal((B, sizes[-1])) * 0.3
                   ).astype(np.float32)
        t = _on(cuda_device, drives=drives, teach=tch, active=ACTIVE)
        params = [TE.EngineParams(
            spiking=i < len(sizes) - 2, quant=qc, tau_m=2.0,
            trace_decay=0.75 if quant else 0.8)
            for i in range(len(sizes) - 1)]
        kw = dict(params=params, teach=t["teach"], active=t["active"])
        got_st, got, tel = TE.rollout(st, theta, t["drives"], telemetry=True,
                                      **kw)
        off_st, off = TE.rollout(st, theta, t["drives"], **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TF, "rollout", lambda *a, block_b=None, **k:
                       TF.rollout_plain(*a, **k))
            want_st, want, want_tel = TE.rollout(st, theta, t["drives"],
                                                 telemetry=True, **kw)
        torch.cuda.synchronize()
        for a, b in zip((*got_st.w, *got_st.v, *got_st.trace, got),
                        (*off_st.w, *off_st.v, *off_st.trace, off)):
            assert torch.equal(a, b)
        for f in ("spike_rate", "mean_abs_dw", "sat_frac", "occupancy"):
            g, w = getattr(tel, f), getattr(want_tel, f)
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
