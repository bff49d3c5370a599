"""Procedural MNIST-like digits and Poisson spike encoding (the Table II
protocol's stand-in data; nothing is downloaded).

Seven-segment digits on a 28x28 grid with a random shift, scale and pixel
noise.  Each generator is split into a DRAW (`draw_jitter`, `torch.rand`
on a `torch.Generator`) and a deterministic function of what was drawn
(`render`, `spikes_from_uniform`), so a test can hand the port the very
jitter and uniforms another implementation drew.
"""
from __future__ import annotations

import torch

from repro_torch.core.plasticity import fma32

# seven-segment layout: (x0, y0, x1, y1) in a 0..1 box, per segment
_SEGS = ((0.2, 0.1, 0.8, 0.1),   # top
         (0.8, 0.1, 0.8, 0.5),   # top-right
         (0.8, 0.5, 0.8, 0.9),   # bottom-right
         (0.2, 0.9, 0.8, 0.9),   # bottom
         (0.2, 0.5, 0.2, 0.9),   # bottom-left
         (0.2, 0.1, 0.2, 0.5),   # top-left
         (0.2, 0.5, 0.8, 0.5))   # middle
# digit -> active segments
_DIGIT_SEGS = ((1, 1, 1, 1, 1, 1, 0), (0, 1, 1, 0, 0, 0, 0),
               (1, 1, 0, 1, 1, 0, 1), (1, 1, 1, 1, 0, 0, 1),
               (0, 1, 1, 0, 0, 1, 1), (1, 0, 1, 1, 0, 1, 1),
               (1, 0, 1, 1, 1, 1, 1), (1, 1, 1, 0, 0, 0, 0),
               (1, 1, 1, 1, 1, 1, 1), (1, 1, 1, 1, 0, 1, 1))


def draw_jitter(generator: torch.Generator, batch: int, size: int = 28):
    """``(shift (B, 2) in [-0.08, 0.08), scale (B,) in [0.85, 1.1),
    noise (B, size, size) in [0, 0.05))`` on the generator's device."""
    def u(*shape):
        return torch.rand(*shape, generator=generator,
                          device=generator.device)
    return (u(batch, 2) * 0.16 - 0.08, u(batch) * 0.25 + 0.85,
            0.05 * u(batch, size, size))


def render(labels: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
           noise: torch.Tensor) -> torch.Tensor:
    """Images ``(B, size, size)`` in [0, 1] of digits ``labels (B,)`` under
    the given jitter (shapes as `draw_jitter`).

    The grid is ``i * fp32(1 / (size - 1))`` and the segment scaling one
    fused multiply-add: the forms the reference takes under ``jax.jit``.
    """
    dev, size = labels.device, noise.shape[-1]
    lin = (torch.arange(size, dtype=torch.float32, device=dev)
           * torch.tensor(1.0 / (size - 1), device=dev))
    ys, xs = torch.meshgrid(lin, lin, indexing="ij")
    pts = torch.stack([xs, ys], -1)                        # (S, S, 2)
    segs = torch.tensor(_SEGS, device=dev).reshape(1, 7, 2, 2) - 0.5
    b = labels.shape[0]
    segs = fma32(scale[:, None, None, None].expand(b, 7, 2, 2),
                 segs.expand(b, 7, 2, 2), torch.full_like(segs, 0.5)
                 ) + shift[:, None, None, :]               # (B, 7, 2, 2)
    a, ab = segs[:, :, 0], segs[:, :, 1] - segs[:, :, 0]   # (B, 7, 2)
    a4, ab4 = a[:, :, None, None, :], ab[:, :, None, None, :]
    tt = torch.clamp((pts - a4).mul(ab4).sum(-1)
                     / torch.clamp((ab * ab).sum(-1), min=1e-6)[..., None,
                                                                 None],
                     0, 1)                                 # (B, 7, S, S)
    dists = torch.linalg.norm(pts - (a4 + tt[..., None] * ab4), dim=-1)
    strokes = torch.exp(-(dists / 0.04) ** 2)
    active = torch.tensor(_DIGIT_SEGS, dtype=torch.float32,
                          device=dev)[labels.long()][:, :, None, None]
    img = torch.clamp((strokes * active).amax(1), 0, 1)
    return torch.clamp(img + noise, 0, 1)


def render_digit(generator: torch.Generator, label: int,
                 size: int = 28) -> torch.Tensor:
    """One ``(size, size)`` image of ``label`` with random jitter."""
    labels = torch.tensor([label], device=generator.device)
    return render(labels, *draw_jitter(generator, 1, size))[0]


def spikes_from_uniform(img: torch.Tensor, u: torch.Tensor,
                        max_rate: float = 0.8) -> torch.Tensor:
    """Spike trains ``(T, pixels)``: a pixel fires where ``u < img * rate``."""
    p = (img.reshape(-1) * max_rate)[None, :]
    return (u < p).float()


def spike_encode(generator: torch.Generator, img: torch.Tensor,
                 timesteps: int, max_rate: float = 0.8) -> torch.Tensor:
    """Poisson-rate spike trains ``(timesteps, pixels)`` in {0, 1}."""
    u = torch.rand(timesteps, img.numel(), generator=generator,
                   device=generator.device)
    return spikes_from_uniform(img, u, max_rate)


def mnist_batch(generator: torch.Generator, batch: int, size: int = 28):
    """``(images (B, size, size) float32, labels (B,) int64)`` on the
    generator's device."""
    labels = torch.randint(0, 10, (batch,), generator=generator,
                           device=generator.device)
    return render(labels, *draw_jitter(generator, batch, size)), labels
