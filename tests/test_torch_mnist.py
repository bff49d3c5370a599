"""The port's procedural digits against the JAX reference.

Random draws cannot match across the two frameworks, so the JAX side's
jitter and uniforms are drawn exactly as `repro.data.mnist` draws them and
handed to the port's deterministic halves (`render`, `spikes_from_uniform`).
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import mnist as JM
from repro_torch.data import (mnist_batch, render, render_digit,
                              spike_encode, spikes_from_uniform)


def _jax_jitter(key, size=28):
    """The (shift, scale, noise) that `repro.data.mnist.render_digit` draws
    from ``key``."""
    k_shift, k_scale, k_noise = jax.random.split(key, 3)
    shift = jax.random.uniform(k_shift, (2,), minval=-0.08, maxval=0.08)
    scale = jax.random.uniform(k_scale, (), minval=0.85, maxval=1.1)
    noise = 0.05 * jax.random.uniform(k_noise, (size, size))
    return (np.array(a) for a in (shift, scale, noise))


@pytest.mark.parametrize("label", range(10))
def test_render_matches_jax_on_the_same_jitter(label):
    key = jax.random.PRNGKey(100 + label)
    want = np.asarray(jax.jit(JM.render_digit, static_argnums=2)(
        key, label, 28))
    shift, scale, noise = _jax_jitter(key)
    got = render(torch.tensor([label]), torch.from_numpy(shift)[None],
                 torch.from_numpy(np.array(scale))[None],
                 torch.from_numpy(noise)[None])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_spike_encode_matches_jax_on_the_same_uniforms():
    key = jax.random.PRNGKey(5)
    img = JM.render_digit(key, 3)
    want = np.asarray(jax.jit(JM.spike_encode, static_argnums=2)(
        key, img, 8))
    u = np.array(jax.random.uniform(key, (8, 784)))
    got = spikes_from_uniform(torch.from_numpy(np.array(img)),
                              torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mnist_batch_shapes_and_labels():
    gen = torch.Generator().manual_seed(0)
    imgs, labels = mnist_batch(gen, 64)
    assert imgs.shape == (64, 28, 28) and imgs.dtype == torch.float32
    assert labels.shape == (64,) and labels.dtype == torch.int64
    assert int(labels.min()) >= 0 and int(labels.max()) <= 9
    assert len(set(labels.tolist())) > 5
    assert float(imgs.min()) >= 0 and float(imgs.max()) <= 1
    one = render_digit(torch.Generator().manual_seed(1), 8)
    assert one.shape == (28, 28)
    sp = spike_encode(torch.Generator().manual_seed(2), one, 6)
    assert sp.shape == (6, 784) and set(sp.unique().tolist()) <= {0.0, 1.0}
    # the same seed draws the same batch
    again, _ = mnist_batch(torch.Generator().manual_seed(0), 64)
    assert torch.equal(imgs, again)
