"""The port's Forward Engine (`kernels.lif.lif_forward`) against the JAX
reference.

On CPU tensors the wrapper takes its plain version; the JAX side runs the
TPU kernel `lif_forward_pallas` in the Pallas interpreter under
``jax.jit``, at the shapes of ``tests/test_kernels.py``.  float32 within
rtol = atol = 1e-5; a bfloat16 input takes the plain version on the CPU and
comes back in bfloat16.

The kernel's host plan (`lif_forward_plan`) is pinned at the online
learner's layers and at ragged shapes, with its refusals, and the call is
shown to run no device op beside its outputs' allocation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lif_forward as j_lif_forward
from repro_torch.kernels import lif_forward
from repro_torch.kernels.lif import kernel as TL
from repro_torch.kernels.plasticity import kernel as TK

SHAPES = [(2, 16, 16), (4, 200, 64), (1, 784, 1024), (8, 130, 250)]


def _inputs(b, k, m):
    rng = np.random.default_rng(k + m)
    return ((rng.random((b, k)) < 0.5).astype(np.float32),
            (rng.standard_normal((k, m)) * k ** -0.5).astype(np.float32),
            (rng.standard_normal((b, m)) * 0.1).astype(np.float32),
            rng.random((b, m)).astype(np.float32))


@pytest.mark.parametrize("b,k,m", SHAPES)
def test_lif_forward_matches_jax(b, k, m):
    arrays = _inputs(b, k, m)
    want = jax.jit(lambda *a: j_lif_forward(
        *a, impl="pallas", interpret=True, block_m=128, block_k=128))(
        *arrays)
    launches = TL.lif_forward.launches
    got = lif_forward(*(torch.from_numpy(a) for a in arrays))
    assert TL.lif_forward.launches == launches        # CPU: no launch
    for a, g, name in zip(want, got, ("spikes", "v", "trace")):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_lif_forward_bfloat16_on_cpu():
    arrays = _inputs(4, 200, 64)
    want = jax.jit(lambda *a: j_lif_forward(*a, impl="xla"))(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    got = lif_forward(*(torch.from_numpy(a).to(torch.bfloat16)
                        for a in arrays))
    for a, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(a, np.float32), rtol=3e-2,
                                   atol=3e-2)


# (B, K, M, dtype) -> (cols, vec, split, ctas, threads, w route, stage_x,
# smem): the frozen shared step's grid, threads for about 16
# multiply-adds of a pass each.  784 -> 1024 takes 128 CTAs of 8 columns
# (a 16-byte piece of 4 float32 or 8 bf16 weights, or two) and 512
# threads, w by TMA; the readout (rows of 10 weights, not in 16-byte
# pieces) takes one tile of the whole row and cuts its fan-in across an
# 8-CTA cluster, w one bulk copy a CTA, 128 threads at B = 1 and 512 at
# B = 8; the ragged shapes split small fans in over clusters, rows of 250
# weights by cp.async pieces.
LIF_PLANS = [
    ((1, 784, 1024, "float32"), (8, 4, 1, 128, 512, "tma", True, 32496)),
    ((8, 784, 1024, "float32"), (8, 4, 1, 128, 512, "tma", True, 54672)),
    ((1, 1024, 10, "float32"), (16, 1, 8, 8, 128, "bulk", True, 7888)),
    ((8, 1024, 10, "float32"), (16, 1, 8, 8, 512, "bulk", True, 18064)),
    ((2, 16, 16, "float32"), (4, 4, 2, 8, 128, "tma", True, 880)),
    ((4, 200, 64, "float32"), (4, 4, 7, 112, 128, "tma", True, 1744)),
    ((8, 130, 250, "float32"), (4, 1, 2, 126, 256, "cp.async", True, 4752)),
    ((1, 784, 1024, "bfloat16"), (8, 8, 1, 128, 512, "tma", True, 18384)),
    ((8, 784, 1024, "bfloat16"), (8, 8, 1, 128, 512, "tma", True, 29584)),
    ((1, 1024, 10, "bfloat16"), (16, 1, 8, 8, 128, "bulk", True, 5072)),
    ((8, 1024, 10, "bfloat16"), (16, 1, 8, 8, 512, "bulk", True, 13456)),
    ((2, 16, 16, "bfloat16"), (8, 8, 2, 4, 128, "tma", True, 1392)),
    ((4, 200, 64, "bfloat16"), (8, 8, 7, 56, 128, "tma", True, 2064)),
    ((8, 130, 250, "bfloat16"), (8, 1, 4, 128, 256, "cp.async", True, 3728)),
]


@pytest.mark.parametrize("case,want", LIF_PLANS,
                         ids=["-".join(map(str, c)) for c, _ in LIF_PLANS])
def test_lif_forward_plan_pins_the_launch(case, want):
    b, k, m, dtype = case
    plan = TL.lif_forward_plan(b, k, m, dtype, sms=132, occupancy=1)
    assert (plan["cols"], plan["vec"], plan["split"], plan["ctas"],
            plan["threads"], plan["w"][0], plan["stage_x"],
            plan["smem"]) == want
    # the frozen shared step's grid, one pass of at most 8 batch rows
    step = TK.shared_step_plan(min(b, 8), k, m, False, dtype, sms=132)
    assert all(plan[key] == step[key] for key in (
        "vec", "cols", "tiles", "split", "rows", "ctas", "chunk_rows",
        "chunks", "w"))
    assert plan["threads"] & (plan["threads"] - 1) == 0 \
        and 128 <= plan["threads"] <= 512
    assert plan["ctas"] == plan["tiles"] * plan["split"] <= 132
    assert (plan["split"] - 1) * plan["rows"] < k <= plan["split"] \
        * plan["rows"]
    # the layout csrc/lif_forward.cu checks: its own, within the step's
    e = 2 if dtype == "bfloat16" else 4
    roles = plan["role_smem"]
    assert roles["ps"] == -(-min(b, 8) * plan["cols"] * 4 // 16) * 16
    assert roles["staged_x"] == (-(-b * plan["rows"] * e // 16) * 16
                                 if plan["stage_x"] else 0)
    assert roles["red"] == plan["threads"] // 32 * 8 * plan["cols"] * 4
    assert plan["smem"] == sum(roles.values()) + 128 \
        <= TK.DEFAULT_SMEM_LIMIT
    assert plan["ctas_per_sm"] == 1


def test_lif_forward_plan_takes_any_batch_and_refuses_what_fits_nothing():
    """A batch of any size runs 8 rows a pass (its events read through L2
    where they do not fit beside the slab); the plan raises for a dtype
    with no kernel, an empty operand and a slab that does not fit even
    across the largest cluster — nothing falls back."""
    plan = TL.lif_forward_plan(4096, 784, 1024, "float32", sms=132)
    assert (plan["ctas"], plan["stage_x"], plan["role_smem"]["ps"]) == (
        128, False, 8 * 8 * 4)
    assert plan["smem"] <= TK.DEFAULT_SMEM_LIMIT
    # where its warps' partials do not fit, the frozen step's warps do
    plan = TL.lif_forward_plan(8, 130, 250, "float32", sms=132, smem=2100)
    assert (plan["threads"], plan["stage_x"]) == (128, False)
    assert plan["smem"] <= 2100
    for dtype in ("float16", "int8"):
        with pytest.raises(ValueError, match="no kernel"):
            TL.lif_forward_plan(1, 784, 1024, dtype, sms=132)
    for b, k, m in ((0, 784, 1024), (1, 0, 1024), (1, 784, 0)):
        with pytest.raises(ValueError, match="empty"):
            TL.lif_forward_plan(b, k, m, "float32", sms=132)
    with pytest.raises(ValueError, match="shared memory"):
        TL.lif_forward_plan(1, 200_000, 1024, "float32", sms=132)


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """Every ATen op a block of code runs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_lif_forward_call_needs_no_device_op(monkeypatch, dtype):
    """The wrapper checks its operands, allocates the three outputs and
    launches one kernel on the plan: no other op, the plan's fields in the
    argument struct, the entry's types set once, one launch counted."""
    x, w, v, tr = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(8, 130, 250))
    kind = "bfloat16" if dtype == torch.bfloat16 else "float32"
    plan = TL.lif_forward_plan(8, 130, 250, kind, sms=132)
    calls = []
    monkeypatch.setattr(TL, "lif_forward_launch", lambda *a: plan)
    monkeypatch.setattr(TL, "_entry", lambda name: lambda args, stream: (
        calls.append((name, args._obj)) or 0))
    monkeypatch.setattr(TL, "stream_of", lambda t: 0)
    launches = TL.lif_forward.launches
    bf16_launches = TL.lif_forward.bf16_launches
    with _Ops() as seen:
        out = TL._launch(x, w, v, tr, TK.f_params(2.0, 1.0, 0.0, 0.8))
    assert set(seen.ops) <= {"aten.empty", "aten.empty_like"}, seen.ops
    assert [o.shape for o in out] == [(8, 250)] * 3
    assert all(o.dtype == dtype for o in out)
    (name, a), = calls
    assert name == ("lif_forward_bf16" if kind == "bfloat16"
                    else "lif_forward_f32")
    assert (a.x, a.w, a.spikes) == (x.data_ptr(), w.data_ptr(),
                                    out[0].data_ptr())
    assert (a.batch, a.k, a.m) == (8, 130, 250)
    assert (a.cols, a.split, a.rows, a.threads, a.vec, a.chunk_rows,
            a.stage_x, a.smem) == (
        plan["cols"], plan["split"], plan["rows"], plan["threads"],
        plan["vec"], plan["chunk_rows"], int(plan["stage_x"]), plan["smem"])
    assert (a.w_route, a.w_width) == (TK.STEP_ROUTES["cp.async"],
                                      plan["w"][1])
    assert TL.lif_forward.launches == launches + 1
    assert TL.lif_forward.bf16_launches == bf16_launches + int(
        kind == "bfloat16")
    # an empty batch: the outputs, and no launch
    TL._launch(x[:0], w, v[:0], tr[:0], TK.f_params(2.0, 1.0, 0.0, 0.8))
    assert len(calls) == 1 and TL.lif_forward.launches == launches + 1
