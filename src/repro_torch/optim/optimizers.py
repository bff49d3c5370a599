"""AdamW and SGD over trees of tensors, float32 arithmetic as in the JAX
package.

`adamw` and `sgd` keep the JAX package's factories: ``opt.init(params)``
gives an `OptState`, ``opt.update(grads, state, params)`` returns
``(params, state)``.  Every leaf's arithmetic is the JAX package's, op by
op in float32: the moments are stored in ``moment_dtype``, the bias
corrections are ``1 - b ** step`` in float32, and the new weights are
``p32 - lr * (mhat / (sqrt(vhat) + eps) + wd * p32)``, taken from the
float32 master copy when ``master_weights`` is on and from the parameters
upcast when it is off.

The arithmetic is the one the JAX package's update compiles to under
``jax.jit`` on the CPU, where the tests hold it bit for bit: XLA folds
``(m / bc1) / (sqrt(v / bc2) + eps)`` into ``m / (bc1 * (sqrt(v / bc2) +
eps))`` and LLVM contracts three multiply-adds into fused ones,
``mu = fma(m, b1, (1 - b1) g)``, ``nu = fma(v, b2, (1 - b2) g^2)`` and
``p - lr * (q + wd p) = fma(-lr, fma(p, wd, q), p)`` (`_fma`, through
float64); the same for SGD's momentum and step.  The global norm's sum
runs in another order than XLA's, so a clipped update may differ in the
last bits of the clip scale.

The update runs IN PLACE: the moments, the master copy and the
parameters are written where they lie, and the tensors handed back are
those that came in (at qwen3-4b's width the float32 moments alone are
33 GiB, and a functional copy beside them does not fit one card).  The
grads are read, never written.  Leaves go in the order of
`checkpoint.manager.flatten` (dict keys sorted, as JAX flattens them).

AdamW updates each leaf with `adamw_leaf`: on a CUDA tensor one launch of
``csrc/adamw.cu`` (the leaf read and written once, the fused multiply-adds
in double there too, so its bits are the plain update's), on a CPU tensor
`adamw_leaf_plain`, which walks the leaf in flat pieces of 2^26 elements
so that its float32 temporaries stay a quarter of a GiB whatever the
leaf's size (the arithmetic is elementwise, so the pieces change no bit).
The float64 detour of `_fma` and `_sqrt` is there for the bits of the JAX
package's CPU update; the kernel pays nothing for it.  SGD runs its plain
update on either device.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.checkpoint.manager import flatten, unflatten
from repro_torch.kernels import _build
from repro_torch.kernels.plasticity.kernel import on_card, stream_of
from repro_torch.models.config import torch_dtype

_PIECE = 1 << 26


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # first moment (params-shaped)
    nu: Any                  # second moment (params-shaped)
    master: Any = None       # optional float32 master weights


def _leaves(tree) -> list:
    return flatten(tree)[1]


def _flat(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError(f"the optimizer updates contiguous leaves in "
                         f"place; got strides {t.stride()} for shape "
                         f"{tuple(t.shape)}")
    return t.view(-1)


def _pieces(*ts):
    """Matching flat pieces of same-shaped tensors (None stays None)."""
    flats = [None if t is None else _flat(t) for t in ts]
    n = flats[0].numel()
    for i in range(0, n, _PIECE):
        yield [None if f is None else f[i:i + _PIECE] for f in flats]


def _sumsq(t: torch.Tensor) -> torch.Tensor:
    parts = [torch.sum(torch.square(p.float())) for (p,) in _pieces(t)]
    return parts[0] if len(parts) == 1 else torch.stack(parts).sum()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in float32."""
    total = None
    for leaf in _leaves(tree):
        s = _sumsq(leaf)
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(tree, max_norm: float):
    norm = global_norm(tree)
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0), norm


def clip_by_global_norm(tree, max_norm: float):
    """Returns (clipped tree, pre-clip norm); new leaves, the tree is
    read only."""
    scale, norm = _clip_scale(tree, max_norm)
    return unflatten(tree, [(g.float() * scale).to(g.dtype)
                            for g in _leaves(tree)]), norm


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64, and so the sum
    rounds there first (off by one float32 ulp only at a float64 tie,
    ~2^-29 of the elements); ``a`` may be a Python float or a 0-d tensor,
    rounded to float32 first as JAX's weak typing rounds it."""
    a = torch.as_tensor(a, dtype=torch.float32, device=c.device)
    return (a.double() * b.double() + c.double()).float()


def _sqrt(x):
    """Correctly rounded float32 sqrt (through float64, which is exact for
    it): PyTorch's float32 sqrt on the CPU is off by one ulp on a few
    elements in 10^4."""
    return torch.sqrt(x.double()).float()


def _lr_of(lr, step):
    if callable(lr):
        return lr(step)
    return torch.full((), lr, dtype=torch.float32, device=step.device)


def _clipped(g, scale):
    """A grad piece as float32, clipped as the JAX package clips it (the
    product rounded to the grad's dtype)."""
    g32 = g.float()
    return g32 if scale is None else (g32 * scale).to(g.dtype).float()


def adamw_leaf_plain(p, g, m, v, w, *, scale, bc1, bc2, lr, b1, b2, eps,
                     wd):
    """`adamw_leaf`'s plain version, in place, piece by piece."""
    for pp, gp, mp, vp, wp in _pieces(p, g, m, v, w):
        g32 = _clipped(gp, scale)
        mp.copy_(_fma(b1, mp.float(), (1 - b1) * g32).to(mp.dtype))
        vp.copy_(_fma(b2, vp.float(), (1 - b2) * torch.square(g32))
                 .to(vp.dtype))
        q = mp.float() / (bc1 * (_sqrt(vp.float() / bc2) + eps))
        p32 = wp if wp is not None else pp.float()
        if wd:
            q = _fma(wd, p32, q)
        new = _fma(-lr, q, p32)
        if wp is not None:
            wp.copy_(new)
        pp.copy_(new.to(pp.dtype))


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def adamw_leaf(p, g, m, v, w, *, scale, bc1, bc2, lr, b1, b2, eps, wd):
    """One leaf's AdamW update in place: the parameter ``p``, its grad
    ``g``, the moments ``m`` and ``v`` and the float32 master copy ``w``
    (or None), all contiguous and of one shape (p, g and the moments
    float32 or bfloat16, the moments of one dtype); ``scale`` (the clip
    scale, or None), ``bc1``, ``bc2`` and ``lr`` 0-d float32 tensors.  A
    CPU tensor takes `adamw_leaf_plain`; a CUDA tensor launches
    ``csrc/adamw.cu`` once, which reads the scalars where they lie, and
    counts it in ``adamw_leaf.launches``."""
    kw = dict(scale=scale, bc1=bc1, bc2=bc2, lr=lr, b1=b1, b2=b2, eps=eps,
              wd=wd)
    if not on_card(p):
        return adamw_leaf_plain(p, g, m, v, w, **kw)
    for name, t, dtypes in (("g", g, _DTYPE_CODE), ("m", m, _DTYPE_CODE),
                            ("v", v, (m.dtype,)),
                            ("w", w, (torch.float32,))):
        if t is not None and (t.shape != p.shape or t.device != p.device
                              or t.dtype not in dtypes
                              or not t.is_contiguous()):
            raise ValueError(f"adamw_leaf: {name} must be contiguous, of "
                             f"p's shape {tuple(p.shape)} on {p.device}, "
                             f"in {[str(d) for d in dtypes]}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if p.dtype not in _DTYPE_CODE or not p.is_contiguous():
        raise ValueError(f"adamw_leaf: p must be contiguous float32 or "
                         f"bfloat16; got {p.dtype}, strides {p.stride()}")
    scalars = [None if t is None else
               torch.as_tensor(t, dtype=torch.float32,
                               device=p.device).reshape(())
               for t in (scale, bc1, bc2, lr)]
    fn = _build.library("adamw.cu").adamw_update
    fn.argtypes = [_P, _I, _P, _I, _P, _P, _I, _P, _L, _P, _P, _P, _P, _F,
                   _F, _F, _F, _F, _F, _I, _P]
    fn.restype = _I
    _build.check(fn(p.data_ptr(), _DTYPE_CODE[p.dtype], g.data_ptr(),
                    _DTYPE_CODE[g.dtype], m.data_ptr(), v.data_ptr(),
                    _DTYPE_CODE[m.dtype],
                    None if w is None else w.data_ptr(), p.numel(),
                    *(None if t is None else t.data_ptr() for t in scalars),
                    b1, 1 - b1, b2, 1 - b2, eps, wd, int(bool(wd)),
                    stream_of(p)), "adamw_update")
    adamw_leaf.launches += 1


adamw_leaf.launches = 0


@dataclasses.dataclass(frozen=True)
class adamw:
    """AdamW factory: opt = adamw(lr); state = opt.init(params);
    params, state = opt.update(grads, state, params)."""

    lr: Union[Callable, float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    master_weights: bool = False   # float32 master copy
    moment_dtype: str = "float32"  # "bfloat16" halves the moments' memory

    def init(self, params) -> OptState:
        mdt = torch_dtype(self.moment_dtype)
        leaves = _leaves(params)
        zeros = [torch.zeros(p.shape, dtype=mdt, device=p.device)
                 for p in leaves]
        master = (unflatten(params, [p.detach().float().clone()
                                     for p in leaves])
                  if self.master_weights else None)
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=leaves[0].device),
                        mu=unflatten(params, zeros),
                        nu=unflatten(params, [z.clone() for z in zeros]),
                        master=master)

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        scale = (_clip_scale(grads, self.grad_clip)[0]
                 if self.grad_clip is not None else None)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = _lr_of(self.lr, step)
        masters = (_leaves(state.master) if self.master_weights
                   else [None] * len(_leaves(params)))
        for p, g, m, v, w in zip(_leaves(params), _leaves(grads),
                                 _leaves(state.mu), _leaves(state.nu),
                                 masters):
            adamw_leaf(p, g, m, v, w, scale=scale, bc1=bc1, bc2=bc2, lr=lr,
                       b1=b1, b2=b2, eps=self.eps, wd=self.weight_decay)
        return params, state._replace(step=step)


@dataclasses.dataclass(frozen=True)
class sgd:
    """SGD with optional momentum (stored in OptState.mu; nu unused)."""

    lr: Union[Callable, float] = 1e-2
    momentum: float = 0.9
    nesterov: bool = False
    grad_clip: Optional[float] = None

    def init(self, params) -> OptState:
        leaves = _leaves(params)
        dev = leaves[0].device
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu=unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                                  for p in leaves]),
            nu=unflatten(params, [torch.zeros((), dtype=torch.float32,
                                              device=p.device)
                                  for p in leaves]))

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        scale = (_clip_scale(grads, self.grad_clip)[0]
                 if self.grad_clip is not None else None)
        step = state.step + 1
        lr = _lr_of(self.lr, step)
        for p, g, m in zip(_leaves(params), _leaves(grads),
                           _leaves(state.mu)):
            for pp, gp, mp in _pieces(p, g, m):
                g32 = _clipped(gp, scale)
                mp.copy_(_fma(self.momentum, mp, g32))
                eff = _fma(self.momentum, mp, g32) if self.nesterov else mp
                pp.copy_(_fma(-lr, eff, pp.float()).to(pp.dtype))
        return params, state._replace(step=step)
