"""The port's Forward Engine (`kernels.lif.lif_forward`) against the JAX
reference.

On CPU tensors the wrapper takes its plain version; the JAX side runs the
TPU kernel `lif_forward_pallas` in the Pallas interpreter under
``jax.jit``, at the shapes of ``tests/test_kernels.py``.  float32 within
rtol = atol = 1e-5; a bfloat16 input takes the plain version on the CPU and
comes back in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lif_forward as j_lif_forward
from repro_torch.kernels import lif_forward
from repro_torch.kernels.lif import kernel as TL

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
