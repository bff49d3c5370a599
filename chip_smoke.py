#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold every kernel against its
plain version.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from ``src/repro_torch/csrc`` (parallel nvcc);
  2. compare every kernel with its plain PyTorch version on the card: the
     fleet kernels at the shapes of the paper's 8-128-8 controller with
     B = 4096 streams; the shared-weight step, the shared-weight rollout
     window and the LIF forward kernel at the 784-1024-10 MNIST network;
 2c. the flash-attention kernel against its plain version at qwen3-4b's
     prefill shape (B = 4, S = 2048, H = 32, HKV = 8, D = 128), a ragged
     S = 1000, a decode-shaped query against 2049 keys, a kv_len mask and
     the serve CLI's 32-token prompts, bfloat16 and float32;
  3. the recovery gate on the card: both gate scenarios x {float32, int8},
     plastic recovers >= 1/2 of the return drop, frozen <= 1/4;
  4. the controller path at full width: `firefly_snn.CONFIG` (8-128-8,
     T = 4) in the closed loop on `direction` with B = 4096 controllers for
     260 steps (one rollout-kernel launch per control step), then the
     per-event path (`snn.timestep`, one fleet-step launch per layer per
     timestep), in float32 and int8; the int8 closed loop is repeated
     through the plain rollout and must give the same bits;
  5. time each kernel and its plain version with CUDA events, the L2 cache
     flushed before each call;
  6. the online-learning path at full width: `firefly_snn.MNIST`
     (784-1024-10, T = 8, B = 1) on 120 procedural digits, predict then
     learn (one shared-weight rollout launch per `classify_window`), then
     one digit per event (`snn.timestep`, one shared-step launch per layer
     per timestep) and through the Table II baselines (`lif_forward` per
     layer, then `apply_plasticity`), in float32 and int8; the int8 stream
     is repeated through the plain versions and must give the same bits;
  7. the Table II timings on the card (per timestep at B = 1: fused,
     forward-only, sequential, windowed) and each new kernel's time with
     the L2 cache flushed between repetitions;
 7b. the attention kernel's time at the prefill shape beside its bound,
     its plain version and `scaled_dot_product_attention` (the yardstick);
  8. LM serving at full width: random-init qwen3-4b (36 layers, bf16)
     serves 4 prompts of 2048 tokens and 32 greedy tokens through
     `launch.serve.generate`, plastic adapter in float32 and int8, each
     datapath once untimed and then timed: 36 attention launches per
     prefill, 32 fleet-step launches per decode, each of those fleet-step
     launches against the plain step on its own inputs (int8 bit for bit,
     float32 within 1e-5), and the int8 adapter state after the timed run
     bit for bit against the plain fleet steps fed the same hidden states;
     the kernel path against the plain path at full depth in bf16
     (printed, not gated) and a profile of 8 decode steps; 8b. at full
     width with 2 layers in float32 the kernel path's logits equal the
     plain path's within 1e-4 of the largest logit and the greedy tokens
     are the same; 8c. the serve CLI at its defaults (4 x 32 + 16), each
     attention and fleet-step launch against its plain version on its own
     inputs;
 2d. the SSD-scan kernel against its plain version at mamba2-1.3b's
     prefill shape (B = 4, L = 2048, H = 64, P = 64, S = 128), ragged
     L = 1, 100 and 300, G = 2 groups by index, x, B and C cut from one
     packed projection, bfloat16 and float32; and against the literal
     recurrence at a small size;
 7c. the SSD-scan kernel's time at the prefill shape beside its bound and
     its plain version;
  9. phase 8 on random-init mamba2-1.3b (48 SSM layers, bf16): 48 SSD-scan
     launches per prefill, 32 fleet-step launches per decode, the adapter
     checks of phase 8, the bf16 full-depth comparison (beside two plain
     paths that differ only in the SSD chunk, i.e. in summation order) and
     the profile;
     9b. at full width with 2 layers in float32 the kernel path's logits
     equal the plain path's within 1e-4 of the largest logit with the same
     greedy tokens, and the SSM state prefilled from a 300-token prompt
     (a ragged last chunk) through the kernel equals the same prompt fed
     token by token through the decode step within 2e-3; 9c. the serve CLI
     at its defaults with ``--arch mamba2-1.3b``, each SSD-scan launch
     against its plain version on its own inputs;
 2e. the telemetry variants of the fleet-step and rollout kernels against
     their plain versions at 8-128-8, B = 4096, 3/4 of the slots active and
     a teaching signal: the fleet steps at 8->128 and 128->8, the rollout
     at K = 4 and 16, float32 and int8; each launch's state equals the same
     launch without telemetry bit for bit, its row equals the plain
     version's bit for bit (int8) or within 2e-4 (float32), vacant rows 0;
     phase 5 also times each variant beside its telemetry-off twin;
 10. session serving at full width: `FleetScheduler` on 8-128-8 with 4096
     slots and a `SessionStore` on disk, float32 and int8: 4096 sessions
     admitted from 8192 users, 24 windows under churn (2% of the residents
     leave before each, as many arrive; one rollout launch per window, the
     telemetry variant on every 4th), then 16 per-event telemetry steps;
     a probe moved through disk into another slot continues bit for bit
     as without the move, 256 vacant slots stay frozen over 8 windows,
     the static signatures and loaded libraries stay constant after
     warm-up, 8 windows are profiled, and the int8 run repeated through
     the plain versions gives the same final pool and persisted sessions.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, when there is no CUDA device or the package is not beside it.
Each phase prints its seconds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM scalar fp32 (non-tensor) peak
B = 4096                         # fleet streams at full width
STEPS = 260                      # closed-loop env steps (a gate episode)
SEED = 0

MNIST_DIGITS = 120               # the Table II stream (mnist_throughput.py)
TEACH = 2.0                      # teaching-current amplitude
# the hand-set rule of mnist_throughput.online_accuracy: (a, b, g, d)
MNIST_RULE = ((0.010, 0.004, -0.0030, -0.0010),
              (0.050, -0.002, -0.0050, -0.0005))
FLUSH_BYTES = 1 << 30            # > the 50 MB L2: zeroed between timed reps

CSRC = "src/repro_torch/csrc/"
SOURCES = {"fleet_step": CSRC + "fleet_step.cu",
           "fleet_step_q": CSRC + "fleet_step.cu",
           "rollout": CSRC + "rollout.cu",
           "rollout_shared": CSRC + "rollout_shared.cu",
           "shared_step": CSRC + "shared_step.cu",
           "shared_step_q": CSRC + "shared_step.cu",
           "lif_forward": CSRC + "lif_forward.cu",
           "flash_attention": CSRC + "flash_attention.cu",
           "ssd_scan": CSRC + "ssd.cu",
           "fleet_step_telemetry": CSRC + "fleet_step.cu",
           "fleet_step_q_telemetry": CSRC + "fleet_step.cu",
           "rollout_telemetry": CSRC + "rollout.cu"}
REPLACES = {"fleet_step": "src/repro/kernels/plasticity/kernel.py:256",
            "fleet_step_q": "src/repro/kernels/plasticity/kernel.py:559",
            "rollout": "src/repro/kernels/plasticity/fused.py:304",
            "rollout_shared": "src/repro/kernels/plasticity/fused.py:304",
            "shared_step": "src/repro/kernels/plasticity/kernel.py:132",
            "shared_step_q": "src/repro/kernels/plasticity/kernel.py:431",
            "lif_forward": "src/repro/kernels/lif/kernel.py:47",
            "flash_attention": "src/repro/kernels/attention/kernel.py:79",
            "ssd_scan": "src/repro/kernels/ssd/kernel.py:65",
            "fleet_step_telemetry": "src/repro/kernels/plasticity/kernel.py:239",
            "fleet_step_q_telemetry":
                "src/repro/kernels/plasticity/kernel.py:538",
            "rollout_telemetry": "src/repro/kernels/plasticity/fused.py:230"}


def log(*a):
    print(*a, flush=True)


class Check(Exception):
    pass


def require(cond, what):
    if not cond:
        raise Check(what)


# ---- timing and bounds -------------------------------------------------------

_flush_buf = []


def device_ms(fn, reps=20, warmup=3):
    """Median device time of one call: CUDA events around each call, with
    the L2 cache flushed before it by zeroing a 1 GB buffer.  Nothing
    synchronises inside the loop, and the zeroing (~0.3 ms of device work)
    keeps the card behind the host, so the events time the call's kernels
    and not the host's dispatch."""
    import torch
    if not _flush_buf:
        _flush_buf.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                      device="cuda"))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        _flush_buf[0].zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def latency_ms(fn, reps=50, warmup=3):
    """Median latency of one call as its caller sees it: CUDA events around
    each call with the card idle before it, so the host's dispatch counts."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, ops):
    """Least time (ms) for the bytes moved and the scalar operations done."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# Scalar operations per synapse and step, counted from the CUDA sources:
# psum (mul, add), four-term update (2 mul, 2 fma = 4, add), add, clip (2)
# in float; the fixed-point path adds the integer product, 3 conversions and
# 2 scalings, a division, floor, subtract, the 12-operation hash, compare,
# add, convert and the integer clip.
OPS_F32, OPS_Q = 11, 35


def step_bytes(b, n, m, wb, sb=4, fleet=True):
    """One step launch: every input read once, every output written once
    (x, w, theta, v, traces in; events, v, trace, w out); a fleet has one
    weight set per stream, a shared-weight step one."""
    syn = (b if fleet else 1) * n * m
    return (b * n * sb + 2 * syn * wb + 16 * n * m + 2 * b * m * sb
            + b * n * sb + 3 * b * m * sb)


def window_bytes(b, sizes, k, wb, sb=4, fleet=True):
    """One rollout launch: drives and outputs once per step, the weights,
    theta, membranes and traces once per window each way (theta in)."""
    syn = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    return (k * b * sizes[0] * sb + k * b * sizes[-1] * sb
            + 2 * (b if fleet else 1) * syn * wb + 16 * syn
            + 2 * b * sum(sizes[1:]) * sb + 2 * b * sum(sizes) * sb)


# ---- phase 2: kernels against their plain versions --------------------------

def rand_fleet_inputs(gen, b, n, m, quant, dev):
    """Spike-like events and grid-valued weights: float psums are exact in
    any summation order, so float differences come only from elementwise
    arithmetic."""
    import torch
    r = lambda *s: torch.rand(*s, generator=gen, device=dev)
    if quant:
        x = (r(b, n) < 0.4).int() * 256
        w = torch.randint(-100, 101, (b, n, m), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        v = torch.randint(-600, 600, (b, m), generator=gen, device=dev,
                          dtype=torch.int32)
        tpre = torch.randint(0, 1200, (b, n), generator=gen, device=dev,
                             dtype=torch.int32)
        tpost = torch.randint(-300, 1200, (b, m), generator=gen, device=dev,
                              dtype=torch.int32)
    else:
        x = (r(b, n) < 0.4).float()
        w = torch.round((r(b, n, m) * 2 - 1) * 64) / 64
        v = r(b, m) * 2 - 0.5
        tpre = r(b, n) * 3
        tpost = r(b, m) * 3
    theta = 0.02 * torch.randn(4, n, m, generator=gen, device=dev)
    return x, w, theta, v, tpre, tpost


def held(name, got, want, quant, results, what, tol=1e-5):
    """Hold a kernel's outputs against its plain version's: bitwise in int8,
    within ``tol`` in float32; record the largest difference."""
    import torch
    torch.cuda.synchronize()
    err = max(float((g.double() - h.double()).abs().max())
              for g, h in zip(got, want))
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    if quant:
        require(all(torch.equal(g, h) for g, h in zip(got, want)),
                f"{name} {what}: not bitwise equal to plain (max err {err})")
    else:
        require(all(torch.allclose(g, h, rtol=tol, atol=tol)
                    for g, h in zip(got, want)),
                f"{name} {what}: max err {err} > {tol}")
    log(f"  {name:14s} {what}: max |err| {err:.3g}")
    return err


def drift(got, want):
    """Largest difference and the share of elements outside 1e-4 (float
    windows of more than one step drift by ULPs and are not gated)."""
    import torch
    torch.cuda.synchronize()
    err = max(float((a.double() - c.double()).abs().max())
              for a, c in zip(got, want))
    outside = sum(int((~torch.isclose(a.double(), c.double(), rtol=1e-4,
                                      atol=1e-4)).sum())
                  for a, c in zip(got, want))
    return err, outside / sum(a.numel() for a in got)


def compare_fleet_steps(dev, results):
    import torch
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.kernels.plasticity.quant import QuantConfig
    gen = torch.Generator(dev).manual_seed(SEED)
    qc = QuantConfig()
    cases = [(8, 128, True, None), (128, 8, False, None), (40, 77, True, "mask")]
    for n, m, spiking, mask in cases:
        active = None
        if mask:
            active = (torch.rand(B, generator=gen, device=dev) < 0.7)
        for quant in (False, True):
            x, w, theta, v, tpre, tpost = rand_fleet_inputs(
                gen, B, n, m, quant, dev)
            if quant:
                scale = torch.where(torch.arange(B, device=dev) % 2 == 0,
                                    1 / 32, 1 / 16).float()
                seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,),
                                     generator=gen, device=dev,
                                     dtype=torch.int64).int()
                kw = dict(qcfg=qc, v_th=1.0, v_reset=0.0, w_clip=4.0,
                          plastic=True, spiking=spiking, seed=seed,
                          active=active)
                got = K.fleet_step_q(x, w, scale, theta, v, tpre, tpost, **kw)
                want = K.fleet_step_q_plain(x, w, scale, theta, v, tpre,
                                            tpost, **kw)
                name = "fleet_step_q"
            else:
                kw = dict(tau_m=2.0, v_th=1.0, v_reset=0.0, trace_decay=0.8,
                          w_clip=4.0, plastic=True, spiking=spiking,
                          active=active)
                got = K.fleet_step(x, w, theta, v, tpre, tpost, **kw)
                want = K.fleet_step_plain(x, w, theta, v, tpre, tpost, **kw)
                name = "fleet_step"
            held(name, got, want, quant, results,
                 f"N={n} M={m} spiking={spiking} "
                 f"active={'mask' if mask else 'all'}")
            if active is not None:
                off = ~active
                require(torch.equal(got[3][off], w[off])
                        and not got[0][off].any(),
                        f"{name}: inactive slots not frozen")


def net_inputs(gen, cfg, k, dev):
    """A random fleet state, rule and drive window for the rollout check
    (grid-valued float weights and drives: exact psums at the first step)."""
    import torch
    from repro_torch.core import snn
    from repro_torch.kernels.plasticity import quant as Q
    st = snn.init_state(cfg, batch=B, fleet=True, device=dev)
    sizes = cfg.layer_sizes
    if cfg.quant is not None:
        w = tuple(torch.randint(-40, 41, (B, sizes[i], sizes[i + 1]),
                                generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
                  for i in range(cfg.num_layers))
        scales = tuple(torch.where(torch.arange(B, device=dev) % 3 == 0,
                                   1 / 16, 1 / 32).float()
                       for _ in range(cfg.num_layers))
        # a clock near the int32 limit: seed + k wraps inside K = 32
        st = dataclasses.replace(
            st, w=w, w_scale=scales,
            t=torch.tensor(2 ** 31 - 9, dtype=torch.int32, device=dev))
        drives = Q.to_fixed(torch.round(torch.randn(
            k, B, sizes[0], generator=gen, device=dev) * 16) / 16, cfg.quant)
    else:
        w = tuple(torch.round((torch.rand(B, sizes[i], sizes[i + 1],
                                          generator=gen, device=dev) * 2 - 1)
                              * 32) / 64 for i in range(cfg.num_layers))
        st = dataclasses.replace(st, w=w)
        drives = torch.round(torch.randn(k, B, sizes[0], generator=gen,
                                         device=dev) * 16) / 16
    theta = snn.init_theta(cfg, gen, scale=0.02)
    return st, theta, drives


def plain_rollout(*args, block_b=None, **kw):
    """`fused.rollout` with the plain version in place of the kernel."""
    from repro_torch.kernels.plasticity import fused
    return fused.rollout_plain(*args, **kw)


def compare_rollouts(dev, results):
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.core import engine, snn
    from repro_torch.kernels.plasticity import fused
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    for quant in (False, True):
        cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
               else firefly_snn.CONFIG)
        params = [cfg.engine_params(i) for i in range(cfg.num_layers)]
        for k in (1, 4, 32):
            st, theta, drives = net_inputs(gen, cfg, k, dev)
            active = torch.rand(B, generator=gen, device=dev) < 0.9
            got = engine.rollout(st, theta, drives, params=params,
                                 active=active, block_b=cfg.block_b)
            with mock.patch.object(fused, "rollout", plain_rollout):
                want = engine.rollout(st, theta, drives, params=params,
                                      active=active, block_b=cfg.block_b)
            g = [got[1]] + list(got[0].w) + list(got[0].v) + list(got[0].trace)
            h = ([want[1]] + list(want[0].w) + list(want[0].v)
                 + list(want[0].trace))
            err, share = drift(g, h)
            results["rollout"]["max_abs_err"] = max(
                results["rollout"]["max_abs_err"], err)
            mode = "int8" if quant else "float32"
            log(f"  rollout {mode:7s} K={k:2d}: max |err| {err:.3g}, share "
                f"outside 1e-4 {share:.2e}")
            if quant:
                require(all(torch.equal(a, c) for a, c in zip(g, h)),
                        f"rollout int8 K={k}: not bitwise equal to plain")
            elif k == 1:
                require(all(torch.allclose(a, c, rtol=1e-5, atol=1e-5)
                            for a, c in zip(g, h)),
                        f"rollout float32 K=1: max err {err} > 1e-5")
            elif k == 4:
                require(share <= 1e-3,
                        f"rollout float32 K=4: {share:.2e} of elements "
                        f"outside 1e-4 (limit 1e-3)")
            require(torch.equal(got[0].w[0][~active], st.w[0][~active]),
                    f"rollout {mode} K={k}: inactive slots not frozen")


# ---- phase 2 (shared weights): the MNIST network's kernels -----------------

def shared_inputs(gen, b, n, m, quant, dev):
    """Shared-step operands: spike events, grid-valued weights (exact float
    psums), a teaching current."""
    import torch
    x, w, theta, v, tpre, tpost = rand_fleet_inputs(gen, b, n, m, quant, dev)
    if quant:
        teach = torch.randint(-300, 300, (b, m), generator=gen, device=dev,
                              dtype=torch.int32)
    else:
        teach = 0.5 * torch.randn(b, m, generator=gen, device=dev)
    return x, w[0].contiguous(), theta, v, tpre, tpost, teach


def compare_shared_steps(dev, results):
    """784 -> 1024 (spiking) and 1024 -> 10 (spiking readout, taught) at
    B = 1, B = 8 and unbatched (through engine.layer_step), and one
    non-plastic step."""
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.core import engine
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.kernels.plasticity.quant import QuantConfig
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    sizes = firefly_snn.MNIST.layer_sizes
    cases = [(sizes[i], sizes[i + 1], b, i == 1, True)
             for i in range(2) for b in (1, 8, None)]
    cases.append((sizes[0], sizes[1], 1, False, False))
    for quant in (False, True):
        name = "shared_step_q" if quant else "shared_step"
        qc = QuantConfig() if quant else None
        for n, m, b, teach, plastic in cases:
            x, w, theta, v, tpre, tpost, tch = shared_inputs(
                gen, b or 1, n, m, quant, dev)
            tch = tch if teach else None
            what = (f"{n}->{m} B={b or 'unbatched'} teach={teach} "
                    f"plastic={plastic}")
            if b is None:
                p = engine.EngineParams(quant=qc, plastic=plastic,
                                        trace_decay=0.75 if quant else 0.8)
                layer = engine.LayerState(w, v[0], tpre[0], tpost[0], theta)
                t1 = None if tch is None else tch[0]
                ls, out = engine.layer_step(layer, x[0], params=p, teach=t1,
                                            seed=2 ** 31 - 1)
                got = (out, ls.w, ls.v, ls.trace_post)
                with mock.patch.object(K, name, getattr(K, name + "_plain")):
                    ls, out = engine.layer_step(layer, x[0], params=p,
                                                teach=t1, seed=2 ** 31 - 1)
                want = (out, ls.w, ls.v, ls.trace_post)
            elif quant:
                args = (x, w, torch.tensor(1 / 32, device=dev), theta, v,
                        tpre, tpost)
                kw = dict(qcfg=qc, teach=tch, plastic=plastic,
                          seed=2 ** 31 - 1)
                got = K.shared_step_q(*args, **kw)
                want = K.shared_step_q_plain(*args, **kw)
            else:
                args = (x, w, theta, v, tpre, tpost)
                kw = dict(teach=tch, plastic=plastic)
                got = K.shared_step(*args, **kw)
                want = K.shared_step_plain(*args, **kw)
            held(name, got, want, quant, results, what)


def mnist_cfg(quant):
    """`firefly_snn.MNIST` with the online protocol's clip (w_clip = 1)."""
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    cfg = dataclasses.replace(firefly_snn.MNIST, w_clip=1.0)
    return snn.quant_config(cfg) if quant else cfg


def compare_shared_rollouts(dev, results):
    """The shared-weight window at 784-1024-10, unbatched, with a held
    teaching current, K = 1, 8, 32; int8 from t = 2**31 - 9 (seed + k wraps
    inside K = 32)."""
    import torch
    from repro_torch.core import engine, snn
    from repro_torch.kernels.plasticity import fused
    from repro_torch.kernels.plasticity import quant as Q
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    for quant in (False, True):
        cfg = mnist_cfg(quant)
        sizes = cfg.layer_sizes
        params = [cfg.engine_params(i) for i in range(cfg.num_layers)]
        for k in (1, 8, 32):
            st = snn.init_state(cfg, device=dev)
            tr = tuple(torch.rand(n, generator=gen, device=dev) * 2
                       for n in sizes)
            if quant:
                w = tuple(torch.randint(-40, 41, (sizes[i], sizes[i + 1]),
                                        generator=gen, device=dev,
                                        dtype=torch.int32).to(torch.int8)
                          for i in range(cfg.num_layers))
                st = dataclasses.replace(
                    st, w=w, trace=tuple(Q.to_fixed(t, cfg.quant)
                                         for t in tr),
                    t=torch.tensor(2 ** 31 - 9, dtype=torch.int32,
                                   device=dev))
            else:
                w = tuple(torch.round((torch.rand(
                    sizes[i], sizes[i + 1], generator=gen, device=dev) * 2
                    - 1) * 16) / 64 for i in range(cfg.num_layers))
                st = dataclasses.replace(st, w=w, trace=tr)
            drives = (torch.rand(k, sizes[0], generator=gen, device=dev)
                      < 0.3).float()
            teach = 0.5 * torch.randn(sizes[-1], generator=gen, device=dev)
            if quant:
                drives = Q.to_fixed(drives, cfg.quant)
                teach = Q.to_fixed(teach, cfg.quant)
            theta = snn.init_theta(cfg, gen, scale=0.02)
            got = engine.rollout(st, theta, drives, params=params,
                                 teach=teach)
            with mock.patch.object(fused, "rollout", plain_rollout):
                want = engine.rollout(st, theta, drives, params=params,
                                      teach=teach)
            g = [got[1], *got[0].w, *got[0].v, *got[0].trace]
            h = [want[1], *want[0].w, *want[0].v, *want[0].trace]
            mode = "int8" if quant else "float32"
            if quant or k == 1:
                held("rollout_shared", g, h, quant, results,
                     f"{mode} K={k}")
            else:
                err, share = drift(g, h)
                log(f"  rollout_shared {mode} K={k}: max |err| {err:.3g}, "
                    f"share outside 1e-4 {share:.2e} (not gated)")


def compare_lif(dev, results):
    import torch
    from repro_torch.kernels.lif import kernel as L
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    for b, k, m in ((1, 784, 1024), (8, 130, 250)):
        x = (torch.rand(b, k, generator=gen, device=dev) < 0.5).float()
        w = torch.round(torch.randn(k, m, generator=gen, device=dev)
                        * 8) / 64
        v = 0.1 * torch.randn(b, m, generator=gen, device=dev)
        tr = torch.rand(b, m, generator=gen, device=dev)
        held("lif_forward", L.lif_forward(x, w, v, tr),
             L.lif_forward_plain(x, w, v, tr), False, results,
             f"B={b} K={k} M={m}")


# ---- phase 3: recovery gate ----------------------------------------------------

def recovery_gate(dev):
    import torch
    from repro_torch import scenarios as S
    for name in S.GATE_SCENARIOS:
        spec = S.SCENARIOS[name]
        env = spec.make_env()
        for quant in (False, True):
            scfg = S.controller_config(env, quant=quant)
            theta = S.reference_rule(spec.env_name, scfg)
            prog = S.make_closed_loop(env, scfg, batch=spec.batch,
                                      steps=spec.steps)
            sched = S.compile_schedule(
                env, spec.perturbations,
                torch.Generator(dev).manual_seed(123), spec.batch)
            rp = prog.run(theta, 7, tasks=spec.tasks, schedule=sched,
                          device=dev)
            rf = prog.run(theta, 7, tasks=spec.tasks, schedule=sched,
                          freeze_at=spec.onset, device=dev)
            mp = S.adaptation_metrics(rp.rewards, spec.onset, spec.window)
            mf = S.adaptation_metrics(rf.rewards, spec.onset, spec.window)
            mode = "int8" if quant else "float32"
            log(f"  {name:16s} {mode:7s}: drop {mp['drop']:.4f}, plastic "
                f"recovers {mp['recovery_frac']:.3f} (ttr "
                f"{mp['time_to_recover']}), frozen {mf['recovery_frac']:.3f}")
            require(mp["drop"] >= 0.02 and mp["recovery_frac"] >= 0.5
                    and mf["recovery_frac"] <= 0.25
                    and mp["time_to_recover"] > 0,
                    f"recovery gate failed on {name} {mode}: {mp} {mf}")


# ---- phase 4: the main path at full width ----------------------------------

def main_path(dev, counters, every):
    """Closed loop (rollout kernel) and per-event steps (fleet-step kernels)
    of the 8-128-8 controller for B = 4096 streams, float32 and int8.
    Every counter is set to 0 first; those of this path are read after."""
    import torch
    from repro_torch import envs, scenarios as S
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    env = envs.make("direction", episode_len=STEPS)
    out = {}
    for c in every:
        c.launches = 0
    for quant in (False, True):
        cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
               else firefly_snn.CONFIG)
        theta = snn.init_theta(cfg, torch.Generator(dev).manual_seed(SEED),
                               scale=0.01)
        prog = S.make_closed_loop(env, cfg, batch=B, steps=STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prog.run(theta, SEED, tasks="train", device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        mode = "int8" if quant else "float32"
        r, a = res.rewards, res.actions
        require(tuple(r.shape) == (STEPS, B) and torch.isfinite(r).all()
                and torch.isfinite(a).all() and (a.abs() <= 1).all(),
                f"closed loop {mode}: bad rewards or actions")
        rate = STEPS * B / dt
        log(f"  closed loop {mode:7s}: {STEPS} steps x {B} controllers in "
            f"{dt:.3f} s = {rate:.4g} control-steps/s, mean reward "
            f"{float(r.mean()):.4f}")
        # per-event path: timestep by timestep through the fleet-step
        # kernels, then the same window through one rollout launch
        obs = prog.venv.observe(res.env_state)
        net = res.net
        for _ in range(cfg.timesteps):
            net, _ = snn.timestep(cfg, net, theta, obs)
        fused_net, _ = snn.rollout_window(
            cfg, res.net, theta, snn.encode_window(cfg, obs))
        torch.cuda.synchronize()
        for x, y in zip(net.w + net.v + net.trace,
                        fused_net.w + fused_net.v + fused_net.trace):
            if quant:
                require(torch.equal(x, y), "int8 per-event path differs "
                        "from the fused window")
            else:
                require(torch.allclose(x, y, rtol=1e-4, atol=1e-4),
                        "float per-event path differs from the fused "
                        "window beyond 1e-4")
        out[mode] = dict(result=res, theta=theta, prog=prog, rate=rate,
                         seconds=dt)
    launches = {c.__name__: c.launches for c in counters}
    log(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    return out, launches


def plain_closed_loop_matches(dev, main):
    """The int8 closed loop through the plain rollout gives the same bits."""
    import torch
    from repro_torch.kernels.plasticity import fused
    m = main["int8"]
    with mock.patch.object(fused, "rollout", plain_rollout):
        t0 = time.perf_counter()
        plain = m["prog"].run(m["theta"], SEED, tasks="train", device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    require(torch.equal(plain.rewards, m["result"].rewards),
            "int8 closed loop: plain rollout gives other rewards")
    for x, y in zip(plain.net.w, m["result"].net.w):
        require(torch.equal(x, y),
                "int8 closed loop: plain rollout gives other weights")
    log(f"  int8 closed loop through the plain rollout: bitwise equal "
        f"rewards and weights ({dt:.2f} s)")


def profile_window(fn, steps):
    """Device busy time, idle share and device time by kernel over one call
    of ``fn`` (torch.profiler, CUPTI), against its wall time.  Ranges
    annotated with `record_function` (the serving phases) are not kernels:
    their host time is reported apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    annotated = lambda e: getattr(e, "is_user_annotation", False)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not annotated(e)]
    ranges = {e.key: {"host_ms": e.cpu_time_total / 1e3, "count": e.count}
              for e in events if annotated(e)
              and e.device_type == torch.autograd.DeviceType.CPU}
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
           "kernel_launches_per_step": launches / steps,
           "top": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3,
                    "count": e.count} for e in top]}
    if ranges:
        out["annotated_host_ms"] = ranges
    log(f"    {steps} steps in {wall_ms:.1f} ms wall, device busy "
        f"{busy_ms:.2f} ms ({launches / steps:.0f} kernel launches per "
        f"step)" if busy_ms else
        "    profiler saw no device time (not measured)")
    for t in out["top"]:
        log(f"      {t['ms']:8.3f} ms  x{t['count']:<5d} {t['name']}")
    for name, r in sorted(ranges.items()):
        log(f"      host {r['host_ms']:8.3f} ms  x{r['count']:<5d} {name}")
    return out


def profile_closed_loop(dev, main, steps=20):
    """Where the time goes over `steps` control steps of the full-width
    closed loop."""
    out = {}
    for mode, m in main.items():
        short = dataclasses.replace(m["prog"], steps=steps)
        short.run(m["theta"], SEED, tasks="train", device=dev)   # warm
        log(f"  {mode}:")
        out[mode] = profile_window(
            lambda: short.run(m["theta"], SEED, tasks="train", device=dev),
            steps)
    return out


# ---- phase 5: timing ---------------------------------------------------------

def time_kernels(dev, results):
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    from repro_torch.kernels.plasticity import fused, kernel as K
    from repro_torch.kernels.plasticity.quant import QuantConfig
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    qc = QuantConfig()
    sizes = firefly_snn.CONFIG.layer_sizes
    # fleet steps: the mean over the controller's two layer shapes
    for name, quant in (("fleet_step", False), ("fleet_step_q", True)):
        ms, pms, bms, kinds = [], [], [], []
        for i in range(len(sizes) - 1):
            n, m = sizes[i], sizes[i + 1]
            spiking = i < len(sizes) - 2
            x, w, theta, v, tpre, tpost = rand_fleet_inputs(
                gen, B, n, m, quant, dev)
            if quant:
                sc = torch.full((B,), 1 / 32, device=dev)
                sd = torch.arange(B, dtype=torch.int32, device=dev)
                kw = dict(qcfg=qc, spiking=spiking, seed=sd)
                run = lambda: K.fleet_step_q(x, w, sc, theta, v, tpre, tpost,
                                             **kw)
                plain = lambda: K.fleet_step_q_plain(x, w, sc, theta, v, tpre,
                                                     tpost, **kw)
            else:
                kw = dict(spiking=spiking)
                run = lambda: K.fleet_step(x, w, theta, v, tpre, tpost, **kw)
                plain = lambda: K.fleet_step_plain(x, w, theta, v, tpre,
                                                   tpost, **kw)
            ms.append(device_ms(run))
            pms.append(device_ms(plain, reps=5))
            b_ms, kind = bound(step_bytes(B, n, m, 1 if quant else 4),
                               B * n * m * (OPS_Q if quant else OPS_F32))
            bms.append(b_ms)
            kinds.append(kind)
        results[name].update(ms=statistics.mean(ms),
                             plain_ms=statistics.mean(pms),
                             bound_ms=statistics.mean(bms),
                             bound_by=max(set(kinds), key=kinds.count))
    # rollout: one control window (K = 4) of the 8-128-8 controller
    k = firefly_snn.CONFIG.timesteps
    syn = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    timed = {}
    for quant in (False, True):
        cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
               else firefly_snn.CONFIG)
        st, theta, drives = net_inputs(gen, cfg, k, dev)
        kw = dict(spiking=[cfg.engine_params(i).spiking for i in range(2)],
                  plastic=[True, True], tau_m=cfg.lif.tau_m,
                  trace_decay=cfg.trace_decay, w_clip=cfg.w_clip,
                  qcfg=cfg.quant)
        if quant:
            kw.update(scales=list(st.w_scale),
                      seed=st.t.expand(B).contiguous())
        run = lambda: fused.rollout(drives, st.w, theta, st.v, st.trace,
                                    block_b=cfg.block_b, **kw)
        plain = lambda: fused.rollout_plain(drives, st.w, theta, st.v,
                                            st.trace, **kw)
        b_ms, kind = bound(window_bytes(B, sizes, k, 1 if quant else 4),
                           k * B * syn * (OPS_Q if quant else OPS_F32))
        timed["int8" if quant else "float32"] = dict(
            ms=device_ms(run), plain_ms=device_ms(plain, reps=5),
            bound_ms=b_ms, bound_by=kind)
    results["rollout"].update(timed["float32"])
    results["rollout"]["int8"] = timed["int8"]


# ---- phase 6: the online-learning path at full width -------------------------

def mnist_rule(cfg, dev):
    """The hand-set rule of the online protocol, as (4, N, M) planes."""
    import torch
    return [torch.stack([torch.full((cfg.layer_sizes[i],
                                     cfg.layer_sizes[i + 1]), c, device=dev)
                         for c in MNIST_RULE[i]])
            for i in range(cfg.num_layers)]


def online_stream(cfg, theta, imgs, labels):
    """`mnist_throughput.online_accuracy`: predict each digit with no
    teaching current, then learn on it with the label as one
    (`classify_window` = one shared-weight rollout launch each)."""
    import torch
    from repro_torch.core import snn
    state = snn.init_state(cfg, device=imgs.device)
    preds = []
    for x, label in zip(imgs, labels):
        _, scores = snn.classify_window(cfg, state, theta, x)
        teach = TEACH * torch.nn.functional.one_hot(
            label, cfg.layer_sizes[-1]).float()
        state, _ = snn.classify_window(cfg, state, theta, x, teach=teach)
        preds.append(torch.argmax(scores))
    return state, torch.stack(preds)


def batched(state):
    """Unbatched shared-weight state as B = 1 (the baselines' layout)."""
    return dataclasses.replace(state, v=tuple(v[None] for v in state.v),
                               trace=tuple(t[None] for t in state.trace))


def forward_only_step(cfg, state, x):
    """Table II inference-only baseline: `lif_forward` per layer."""
    from repro_torch.kernels import lif_forward
    v, tr = list(state.v), list(state.trace)
    for i in range(cfg.num_layers):
        x, v[i], tr[i + 1] = lif_forward(x, state.w[i], v[i], tr[i + 1])
    return dataclasses.replace(state, v=tuple(v), trace=tuple(tr),
                               t=state.t + 1), x


def sequential_step(cfg, state, theta, x):
    """Table II unfused baseline: the forward pass completes, then the
    plasticity pass re-reads every weight matrix."""
    from repro_torch.core import plasticity as P
    from repro_torch.kernels import lif_forward
    w, v, tr = list(state.w), list(state.v), list(state.trace)
    tr[0] = P.update_trace(tr[0], x, cfg.trace_decay)
    for i in range(cfg.num_layers):
        x, v[i], tr[i + 1] = lif_forward(x, w[i], v[i], tr[i + 1])
    for i in range(cfg.num_layers):
        w[i] = P.apply_plasticity(w[i], theta[i], tr[i], tr[i + 1],
                                  cfg.layer_plasticity_cfg(i))
    return dataclasses.replace(state, w=tuple(w), v=tuple(v),
                               trace=tuple(tr), t=state.t + 1), x


def online_path(dev, counters, every):
    """120 digits of predict-then-learn at 784-1024-10, then one digit per
    event and, in float32, through the Table II baselines; float32 and
    int8.  Every counter is set to 0 first; those of this path are read
    over exactly this run."""
    import torch
    from repro_torch.core import snn
    from repro_torch.data import mnist_batch, spike_encode
    from repro_torch.kernels.plasticity import quant as Q
    gen = torch.Generator(dev).manual_seed(SEED)
    imgs, labels = mnist_batch(gen, MNIST_DIGITS)
    imgs = imgs.reshape(MNIST_DIGITS, -1)
    spikes = spike_encode(gen, imgs[0], mnist_cfg(False).timesteps)
    torch.cuda.synchronize()
    out = {}
    for c in every:
        c.launches = 0
    for quant in (False, True):
        cfg = mnist_cfg(quant)
        mode = "int8" if quant else "float32"
        theta = mnist_rule(cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, preds = online_stream(cfg, theta, imgs, labels)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        warm = MNIST_DIGITS // 5
        acc = float((preds[warm:] == labels[warm:]).float().mean())
        if quant:
            qmax = int(Q.qclip(cfg.w_clip, torch.tensor(cfg.quant.w_scale)))
            require(all(int(w.abs().max()) <= qmax for w in state.w),
                    "int8 online stream: weights outside the clip")
        else:
            require(all(torch.isfinite(w).all()
                        and float(w.abs().max()) <= cfg.w_clip
                        for w in state.w),
                    "float32 online stream: weights not finite or outside "
                    "w_clip")
        grown = float(sum(w.float().abs().sum() for w in state.w))
        require(grown > 0, f"{mode} online stream: no synapse grew")
        log(f"  online stream {mode:7s}: {MNIST_DIGITS} digits (2 windows "
            f"each) in {dt:.3f} s = {MNIST_DIGITS / dt:.1f} digits/s; "
            f"predict-then-learn accuracy {acc:.3f} (chance 0.1, by "
            f"design); sum |w| {grown:.4g}")
        # one digit per event: T timesteps through snn.timestep (one
        # shared-step launch per layer each) against one window
        x = imgs[0]
        teach = TEACH * torch.nn.functional.one_hot(
            labels[0], cfg.layer_sizes[-1]).float()
        win, win_scores = snn.classify_window(cfg, state, theta, x,
                                              teach=teach)
        ev, ev_scores = state, 0
        for _ in range(cfg.timesteps):
            ev, o = snn.timestep(cfg, ev, theta, x, teach=teach)
            ev_scores = ev_scores + o
        torch.cuda.synchronize()
        pairs = list(zip((*ev.w, *ev.v, *ev.trace, ev_scores),
                         (*win.w, *win.v, *win.trace, win_scores)))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in pairs)
        if quant:
            require(all(torch.equal(a, b) for a, b in pairs),
                    "int8 per-event digit differs from its window")
        else:
            require(err <= 1e-4, f"float32 per-event digit differs from its "
                    f"window by {err} > 1e-4")
        log(f"  per-event digit {mode:7s}: {cfg.timesteps} timesteps vs one "
            f"window, max |diff| {err:.3g}")
        if not quant:
            # the Table II baselines on the same timestep: the sequential
            # (forward, then plasticity) step computes what the fused step
            # does; forward-only its forward half
            bs, xb = batched(state), spikes[0][None]
            fused, f_out = snn.timestep(cfg, bs, theta, xb)
            seq, s_out = sequential_step(cfg, bs, theta, xb)
            fwd, o_out = forward_only_step(cfg, bs, xb)
            torch.cuda.synchronize()
            d_seq = max(float((a - b).abs().max()) for a, b in zip(
                (*seq.w, *seq.v, *seq.trace, s_out),
                (*fused.w, *fused.v, *fused.trace, f_out)))
            d_fwd = max(float((a - b).abs().max()) for a, b in zip(
                (*fwd.v, *fwd.trace[1:], o_out),
                (*fused.v, *fused.trace[1:], f_out)))
            require(d_seq <= 1e-4 and d_fwd <= 1e-4,
                    f"Table II baselines differ from the fused step: "
                    f"sequential {d_seq}, forward-only {d_fwd}")
            log(f"  Table II baselines vs the fused timestep: sequential "
                f"max |diff| {d_seq:.3g}, forward-only {d_fwd:.3g}")
        out[mode] = dict(state=state, preds=preds, theta=theta, acc=acc,
                         seconds=dt, digits_per_s=MNIST_DIGITS / dt)
    launches = {c.__name__: c.launches for c in counters}
    log(f"  launches on the online-learning path: {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the online path")
    out["data"] = (imgs, labels, spikes)
    return out, launches


def plain_stream_matches(dev, online):
    """The int8 stream through the plain versions gives the same bits."""
    import torch
    from repro_torch.kernels.plasticity import fused
    imgs, labels, _ = online["data"]
    m = online["int8"]
    with mock.patch.object(fused, "rollout", plain_rollout):
        t0 = time.perf_counter()
        state, preds = online_stream(mnist_cfg(True), m["theta"], imgs,
                                     labels)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    require(torch.equal(preds, m["preds"]),
            "int8 online stream: plain versions give other predictions")
    for a, b in zip((*state.w, *state.v, *state.trace),
                    (*m["state"].w, *m["state"].v, *m["state"].trace)):
        require(torch.equal(a, b),
                "int8 online stream: plain versions give other state")
    log(f"  int8 online stream through the plain versions: bitwise equal "
        f"predictions and state ({dt:.2f} s)")


def profile_online(online, digits=10):
    """Where the time goes over `digits` digits of the online stream (a
    step here is one digit: two windows)."""
    imgs, labels, _ = online["data"]
    out = {}
    for mode in ("float32", "int8"):
        cfg, theta = mnist_cfg(mode == "int8"), online[mode]["theta"]
        log(f"  {mode}:")
        out[mode] = profile_window(lambda: online_stream(
            cfg, theta, imgs[:digits], labels[:digits]), digits)
    return out


# ---- phase 7: Table II timings and the new kernels' times ------------------

def table2(dev, online):
    """Per-timestep latency at B = 1 of the fused timestep, the forward-only
    and sequential baselines, and the windowed `classify_window` (per
    timestep), on the state the stream left (CUDA events per call, host
    dispatch included: this is the online system's latency)."""
    from repro_torch.core import snn
    imgs, labels, spikes = online["data"]
    out = {}
    for quant in (False, True):
        cfg = mnist_cfg(quant)
        mode = "int8" if quant else "float32"
        m = online[mode]
        state, theta = m["state"], m["theta"]
        bs, xb = batched(state), spikes[0][None]
        t = cfg.timesteps
        row = {"fused": latency_ms(lambda: snn.timestep(cfg, bs, theta, xb)),
               "windowed": latency_ms(lambda: snn.classify_window(
                   cfg, state, theta, imgs[0])) / t}
        if not quant:
            row["forward_only"] = latency_ms(
                lambda: forward_only_step(cfg, bs, xb))
            row["sequential"] = latency_ms(
                lambda: sequential_step(cfg, bs, theta, xb))
        fps = {k: 1e3 / (t * v) for k, v in row.items()}
        out[mode] = {"per_timestep_ms": row, "fps": fps}
        if not quant:
            out[mode]["fused_vs_forward_only"] = (row["fused"]
                                                  / row["forward_only"])
            out[mode]["sequential_vs_fused"] = (row["sequential"]
                                                / row["fused"])
        log(f"  {mode:7s} per timestep: " + ", ".join(
            f"{k} {v:.4f} ms ({fps[k]:.1f} FPS)" for k, v in row.items()))
    log(f"  fused / forward-only: "
        f"{out['float32']['fused_vs_forward_only']:.3f}; sequential / fused:"
        f" {out['float32']['sequential_vs_fused']:.3f}")
    return out


# Scalar operations counted from the sources: per synapse and batch row the
# psum (mul, add), the Hebbian product and sum (2) and the presynaptic sum;
# per synapse the update: three divisions by B, the four-term sum (4), add,
# clip (2) in float; in fixed point three conversions and scalings, the
# four-term sum, a division, floor, subtract, the 12-operation hash,
# compare, add, convert and the integer clip.
OPS_ROW, OPS_UPD_F32, OPS_UPD_Q = 5, 10, 29


def time_new_kernels(dev, results):
    """Each new kernel at the online path's shapes (B = 1), L2 flushed
    between repetitions; the plain version beside it."""
    import torch
    from repro_torch.core import engine, snn
    from repro_torch.kernels.lif import kernel as L
    from repro_torch.kernels.plasticity import fused, kernel as K
    from repro_torch.kernels.plasticity.quant import QuantConfig
    gen = torch.Generator(dev).manual_seed(SEED + 6)
    qc = QuantConfig()
    sizes = mnist_cfg(False).layer_sizes
    layers = [(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)]
    for name, quant in (("shared_step", False), ("shared_step_q", True)):
        ms, pms, bms, kinds = [], [], [], []
        for n, m in layers:
            x, w, theta, v, tpre, tpost, _ = shared_inputs(gen, 1, n, m,
                                                           quant, dev)
            if quant:
                sc = torch.tensor(1 / 32, device=dev)
                kw = dict(qcfg=qc, seed=12345)
                run = lambda: K.shared_step_q(x, w, sc, theta, v, tpre,
                                              tpost, **kw)
                plain = lambda: K.shared_step_q_plain(x, w, sc, theta, v,
                                                      tpre, tpost, **kw)
            else:
                run = lambda: K.shared_step(x, w, theta, v, tpre, tpost)
                plain = lambda: K.shared_step_plain(x, w, theta, v, tpre,
                                                    tpost)
            ms.append(device_ms(run))
            pms.append(device_ms(plain, reps=5))
            b_ms, kind = bound(step_bytes(1, n, m, 1 if quant else 4,
                                          fleet=False),
                               n * m * (OPS_ROW + (OPS_UPD_Q if quant
                                                   else OPS_UPD_F32)))
            bms.append(b_ms)
            kinds.append(kind)
        results[name].update(ms=statistics.mean(ms),
                             plain_ms=statistics.mean(pms),
                             bound_ms=statistics.mean(bms),
                             bound_by=max(set(kinds), key=kinds.count))
    # shared window: one classify window (K = 8) of 784-1024-10 at B = 1
    syn = sum(n * m for n, m in layers)
    timed = {}
    for quant in (False, True):
        cfg = mnist_cfg(quant)
        k = cfg.timesteps
        st = snn.init_state(cfg, batch=1, device=dev)
        if quant:
            w = tuple(torch.randint(-40, 41, (n, m), generator=gen,
                                    device=dev, dtype=torch.int32)
                      .to(torch.int8) for n, m in layers)
            drives = (torch.rand(k, 1, sizes[0], generator=gen, device=dev)
                      < 0.3).int() * cfg.quant.one
        else:
            w = tuple(torch.round((torch.rand(n, m, generator=gen,
                                              device=dev) * 2 - 1) * 16) / 64
                      for n, m in layers)
            drives = (torch.rand(k, 1, sizes[0], generator=gen, device=dev)
                      < 0.3).float()
        st = dataclasses.replace(st, w=w)
        theta = snn.init_theta(cfg, gen, scale=0.02)
        kw = dict(spiking=[True, True], plastic=[True, True],
                  tau_m=cfg.lif.tau_m, trace_decay=cfg.trace_decay,
                  w_clip=cfg.w_clip, qcfg=cfg.quant)
        if quant:
            kw.update(scales=list(st.w_scale), seed=st.t)
        run = lambda: fused.rollout_shared(drives, st.w, theta, st.v,
                                           st.trace, **kw)
        plain = lambda: fused.rollout_plain(drives, st.w, theta, st.v,
                                            st.trace, **kw)
        b_ms, kind = bound(window_bytes(1, sizes, k, 1 if quant else 4,
                                        fleet=False),
                           k * syn * (OPS_ROW + (OPS_UPD_Q if quant
                                                 else OPS_UPD_F32)))
        timed["int8" if quant else "float32"] = dict(
            ms=device_ms(run), plain_ms=device_ms(plain, reps=5),
            bound_ms=b_ms, bound_by=kind)
    results["rollout_shared"].update(timed["float32"])
    results["rollout_shared"]["int8"] = timed["int8"]
    # lif_forward: the two layers of the forward-only baseline at B = 1;
    # library call: torch.matmul of the same product (the product only)
    ms, pms, lms, bms = [], [], [], []
    for n, m in layers:
        x = (torch.rand(1, n, generator=gen, device=dev) < 0.3).float()
        w = torch.randn(n, m, generator=gen, device=dev) * n ** -0.5
        v = 0.1 * torch.randn(1, m, generator=gen, device=dev)
        tr = torch.rand(1, m, generator=gen, device=dev)
        ms.append(device_ms(lambda: L.lif_forward(x, w, v, tr)))
        pms.append(device_ms(lambda: L.lif_forward_plain(x, w, v, tr)))
        lms.append(device_ms(lambda: torch.matmul(x, w)))
        bms.append(bound(4 * (n + n * m + 5 * m), 2 * n * m + 5 * m)[0])
    results["lif_forward"].update(
        ms=statistics.mean(ms), plain_ms=statistics.mean(pms),
        library_ms=statistics.mean(lms), bound_ms=statistics.mean(bms),
        bound_by="bytes", library_covers="the (B,K)x(K,M) product only")


# ---- phase 2c: flash attention against its plain version -------------------

BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32      # the serving run (phase 8)
ATTN_SHAPE = (LM_BATCH, 2048, 32, 8, 128)      # B, S, H, HKV, D at qwen3-4b
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-3)}


def attention_inputs(gen, b, sq, skv, h, hkv, d, dtype, dev):
    import torch
    q = torch.randn(b, sq, h, d, generator=gen, device=dev)
    k = torch.randn(b, skv, hkv, d, generator=gen, device=dev)
    v = torch.randn(b, skv, hkv, d, generator=gen, device=dev)
    return tuple(t.to(dtype) for t in (q, k, v))


def compare_attention(dev, results):
    """#7 against `ref.mha` on the same inputs: the prefill shape of
    qwen3-4b (B = 4, S = 2048, H = 32, HKV = 8, D = 128), a ragged
    S = 1000, a decode-shaped query against 2049 keys, a kv_len mask and
    the serve CLI's 32-token prompts (one partial query tile); bfloat16
    and float32."""
    import torch
    from repro_torch.kernels.attention import kernel as TA
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    b, s, h, hkv, d = ATTN_SHAPE
    cases = [("prefill", b, s, s, True, None),
             ("ragged", b, 1000, 1000, True, None),
             ("decode", b, 1, s + 1, True, None),
             ("kv_len", b, s, s, True, 1500),
             ("cli", b, 32, 32, True, None)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        rtol, atol = ATTN_TOL[dname]
        for what, bb, sq, skv, causal, kv_len in cases:
            q, k, v = attention_inputs(gen, bb, sq, skv, h, hkv, d, dtype,
                                       dev)
            got = TA.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
            want = TA.flash_attention_plain(q, k, v, causal=causal,
                                            kv_len=kv_len)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            results["flash_attention"]["max_abs_err"] = max(
                results["flash_attention"]["max_abs_err"], err)
            require(got.dtype == dtype and got.shape == q.shape
                    and torch.allclose(got.float(), want.float(), rtol=rtol,
                                       atol=atol),
                    f"flash_attention {dname} {what}: max err {err} "
                    f"outside rtol {rtol} atol {atol}")
            log(f"  flash_attention  {dname:8s} {what:7s} Sq={sq} Skv={skv} "
                f"kv_len={kv_len}: max |err| {err:.3g}")
            del q, k, v, got, want
    torch.cuda.empty_cache()


# ---- phase 7b: the attention kernel's time ----------------------------------

def attention_bound(b, sq, skv, h, hkv, d, itemsize):
    """Least time (ms) for causal attention: q, k, v read once and o written
    once at the memory rate, against 4·D FLOP for every visible
    (query, key) pair at the dense bf16 tensor-core peak."""
    off = skv - sq
    pairs = sum(min(skv, i + off + 1) for i in range(sq))
    nbytes = (2 * b * sq * h * d + 2 * b * skv * hkv * d) * itemsize
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = 4 * d * b * h * pairs / BF16_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations", tb, to


def time_attention(dev, results):
    """#7 at the prefill shape in bfloat16, L2 flushed between calls; its
    plain version and `scaled_dot_product_attention` (GQA) on the same
    inputs as the library yardstick (timed here only, never on the path)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel as TA
    gen = torch.Generator(dev).manual_seed(SEED + 8)
    b, s, h, hkv, d = ATTN_SHAPE
    q, k, v = attention_inputs(gen, b, s, s, h, hkv, d, torch.bfloat16, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = device_ms(lambda: TA.flash_attention(q, k, v))
    plain = device_ms(lambda: TA.flash_attention_plain(q, k, v), reps=5)
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    bms, kind, tb, to = attention_bound(b, s, s, h, hkv, d, 2)
    results["flash_attention"].update(ms=ms, plain_ms=plain, library_ms=lib,
                                      bound_ms=bms, bound_by=kind)
    log(f"  flash_attention bf16 B={b} S={s} H={h}/{hkv} D={d}: {ms:.4f} ms "
        f"(bound {bms:.4f} ms by {kind}: bytes {tb:.4f} ms, operations "
        f"{to:.4f} ms; plain {plain:.4f} ms; SDPA {lib:.4f} ms)")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()


# ---- phase 2d: the SSD scan against its plain version -----------------------

SSD_SHAPE = (LM_BATCH, 2048, 64, 64, 128)      # B, L, H, P, S at mamba2-1.3b
SSD_CHUNK = 256                                # the model's chunk
SSD_TOL = (2e-3, 2e-3)                         # float32; tests/test_kernels.py


def bf16_step(t):
    """One bfloat16 step at the largest |t| (8 significant bits)."""
    m = float(t.float().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def ssd_close(got, want):
    """One output of the SSD scan against its plain version: bfloat16 y
    within one bf16 step of the largest |y| (both round a float32 result
    once), float32 within rtol = atol = 2e-3."""
    import torch
    if got.dtype == torch.bfloat16:
        err = float((got.float() - want.float()).abs().max())
        return got.dtype == want.dtype and err <= bf16_step(want)
    return got.dtype == want.dtype and torch.allclose(
        got, want, rtol=SSD_TOL[0], atol=SSD_TOL[1])


def ssd_inputs(gen, b, length, h, p, s, g, dtype, dev):
    """x, B and C cut from one packed (B, L, H*P + 2*G*S) projection (x is
    not contiguous), dt = softplus(N(0, 1)) and a = -exp(N(0, 0.25)): the
    decay reaches exp(-100) and below within a chunk."""
    import torch
    import torch.nn.functional as F
    packed = torch.randn(b, length, h * p + 2 * g * s, generator=gen,
                         device=dev).to(dtype)
    x = packed[..., :h * p].unflatten(-1, (h, p))
    bm = packed[..., h * p:h * p + g * s].unflatten(-1, (g, s))
    cm = packed[..., h * p + g * s:].unflatten(-1, (g, s))
    dt = F.softplus(torch.randn(b, length, h, generator=gen, device=dev))
    a = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))
    return x, dt, a, bm, cm


def compare_ssd(dev, results):
    """#8 against `ssd_scan_plain` (the chunked form at the model's chunk)
    on the same inputs: the prefill shape, ragged L = 1, 100 and 300,
    G = 2, and the serve CLI's 32-token prompts; bfloat16 and float32.
    Then the kernel against the literal recurrence at a small size."""
    import torch
    from repro_torch.kernels.ssd import kernel as SK, ref as SR
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    b, length, h, p, s = SSD_SHAPE
    cases = [("prefill", b, length, 1), ("L=1", b, 1, 1),
             ("L=100", b, 100, 1), ("L=300", b, 300, 1),
             ("G=2", 2, 300, 2), ("cli", b, 32, 1)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for what, bb, ll, g in cases:
            args = ssd_inputs(gen, bb, ll, h, p, s, g, dtype, dev)
            got = SK.ssd_scan(*args)
            want = SK.ssd_scan_plain(*args, chunk=SSD_CHUNK)
            torch.cuda.synchronize()
            errs = [float((x.float() - w.float()).abs().max())
                    for x, w in zip(got, want)]
            results["ssd_scan"]["max_abs_err"] = max(
                results["ssd_scan"]["max_abs_err"], *errs)
            require(got[0].shape == want[0].shape
                    and got[1].shape == (bb, h, s, p)
                    and all(ssd_close(x, w) for x, w in zip(got, want)),
                    f"ssd_scan {dname} {what}: max err y {errs[0]}, state "
                    f"{errs[1]} (y tolerance: "
                    + ("one bf16 step" if dtype == torch.bfloat16
                       else f"{SSD_TOL}") + f"; state {SSD_TOL})")
            log(f"  ssd_scan {dname:8s} {what:7s} B={bb} L={ll} G={g}: "
                f"max |err| y {errs[0]:.3g}, state {errs[1]:.3g}")
            del args, got, want
    args = ssd_inputs(gen, 2, 200, 8, p, s, 2, torch.float32, dev)
    got, want = SK.ssd_scan(*args), SR.ssd_scan_ref(*args)
    torch.cuda.synchronize()
    errs = [float((x - w).abs().max()) for x, w in zip(got, want)]
    require(all(ssd_close(x, w) for x, w in zip(got, want)),
            f"ssd_scan float32 against the recurrence: max err {errs}")
    log(f"  ssd_scan float32 against the literal recurrence (B=2 L=200 H=8 "
        f"G=2): max |err| y {errs[0]:.3g}, state {errs[1]:.3g}")
    torch.cuda.empty_cache()


# ---- phase 7c: the SSD scan's time --------------------------------------------

def ssd_bound(b, length, h, p, s, g, chunk, itemsize):
    """Least time (ms) for the chunked SSD: x, B, C, dt and a read once, y
    and the float32 state written once, at the memory rate, against the
    FLOP of each (b, h, chunk of q rows) at the dense bf16 tensor-core
    peak: the causal triangles of C B^T and G x, q(q+1)(S + P), and the
    products C state and the state update, 2qSP each."""
    nbytes = ((2 * b * length * h * p + 2 * b * length * g * s) * itemsize
              + 4 * (b * length * h + h + b * h * s * p))
    qs = [min(chunk, length - i) for i in range(0, length, chunk)]
    flops = b * h * sum(q * (q + 1) * (s + p) + 4 * q * s * p for q in qs)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / BF16_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations", tb, to


def time_ssd(dev, results):
    """#8 at the prefill shape in bfloat16 (x, B, C cut from a packed
    projection, as the model passes them), L2 flushed between calls, beside
    its plain version; no single PyTorch call computes an SSD scan."""
    import torch
    from repro_torch.kernels.ssd import kernel as SK
    gen = torch.Generator(dev).manual_seed(SEED + 10)
    b, length, h, p, s = SSD_SHAPE
    args = ssd_inputs(gen, b, length, h, p, s, 1, torch.bfloat16, dev)
    ms = device_ms(lambda: SK.ssd_scan(*args))
    plain = device_ms(lambda: SK.ssd_scan_plain(*args, chunk=SSD_CHUNK),
                      reps=5)
    bms, kind, tb, to = ssd_bound(b, length, h, p, s, 1, SSD_CHUNK, 2)
    per_sm = SK.blocks_per_sm(torch.bfloat16)
    # one prompt: H = 64 CTAs on 132 SMs (printed, not in the kernels line)
    one = [t[:1] for t in args[:2]] + [args[2]] + [t[:1] for t in args[3:]]
    ms_b1 = device_ms(lambda: SK.ssd_scan(*one))
    bms1 = ssd_bound(1, length, h, p, s, 1, SSD_CHUNK, 2)[0]
    results["ssd_scan"].update(ms=ms, plain_ms=plain, library_ms=None,
                               bound_ms=bms, bound_by=kind,
                               blocks_per_sm=per_sm, ms_b1=ms_b1)
    log(f"  ssd_scan bf16 B={b} L={length} H={h} P={p} S={s}: {ms:.4f} ms "
        f"(bound {bms:.4f} ms by {kind}: bytes {tb:.4f} ms, operations "
        f"{to:.4f} ms; plain {plain:.4f} ms; {b * h} CTAs, {per_sm} per SM)"
        f"; B=1: {ms_b1:.4f} ms (bound {bms1:.4f} ms, {h} CTAs)")
    del args, one
    torch.cuda.empty_cache()


# ---- phase 8: LM serving at full width --------------------------------------

def serve_logits(cfg, params, prompts, gen, tokens=None):
    """Prefill + ``gen`` decode steps through the serving step builders,
    every step's logits kept (float32, on the card).  Greedy, or
    teacher-forced on ``tokens (B, gen)``.  Returns (logits list, tokens);
    the cache is freed."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill
    prefill = make_prefill(cfg, prompts.shape[1] + gen)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, prompts)
    outs, toks = [logits.float()], []
    for i in range(gen):
        tok = (tokens[:, i] if tokens is not None
               else outs[-1].argmax(-1).to(torch.int32))
        toks.append(tok)
        logits, cache = decode(params, cache, tok[:, None])
        outs.append(logits.float())
    torch.cuda.synchronize()
    del cache
    return outs, torch.stack(toks, 1)


@contextlib.contextmanager
def recording(owner, name, calls):
    """Pass every call of ``owner.<name>`` through, appending (args,
    kwargs, result) to ``calls``.  The recorded functions return fresh
    tensors and the path writes none of their inputs afterwards, so the
    record adds no device work to the run it watches.  A kernel wrapper
    counts its launches through its own module's name, so ``owner`` is
    never the wrapper's module: the model's alias of the attention kernel,
    or `plastic` for the adapter step around each fleet-step launch."""
    real = getattr(owner, name)

    def record(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out

    with mock.patch.object(owner, name, record):
        yield calls


def tensors(out):
    """The tensors of a result: a tensor, or a tuple of tensors and dicts
    of tensors, in order."""
    parts = out if isinstance(out, tuple) else (out,)
    return [t for p in parts
            for t in (p.values() if isinstance(p, dict) else (p,))]


def plain_adapter_step(*a, **kw):
    """`plastic.decode_step` with the plain fleet steps."""
    from repro_torch.models import plastic
    with contextlib.ExitStack() as stack:
        for p in plain_kernels():
            stack.enter_context(p)
        return plastic.decode_step(*a, **kw)


def replay_launches(calls, plain, name, results, what, exact, tol,
                    close=None):
    """Each recorded call on the path, one launch of kernel ``name``,
    against ``plain`` on the same inputs: bit for bit if ``exact``, else
    within ``tol = (rtol, atol)``, or as ``close(got, want)`` says."""
    import torch
    torch.cuda.synchronize()
    err = 0.0
    for i, (a, kw, got) in enumerate(calls):
        want = plain(*a, **kw)
        for g, w in zip(tensors(got), tensors(want)):
            e = float((g.double() - w.double()).abs().max())
            err = max(err, e)
            require(torch.equal(g, w) if exact else close(g, w) if close
                    else torch.allclose(g.float(), w.float(), rtol=tol[0],
                                        atol=tol[1]),
                    f"{name} {what}: launch {i} differs from the plain "
                    f"version on its inputs (max err {e})")
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    log(f"  {name:14s} {what}: all {len(calls)} launches against the plain "
        f"version on their inputs, max |err| {err:.3g}")


def plain_kernels():
    """Patches that send the LM path through the plain versions: the plain
    attention and SSD scan in the model and the plain fleet steps in the
    engine."""
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import attention as MA, ssm as MS
    return (mock.patch.object(MA, "attn_op", TA.flash_attention_plain),
            mock.patch.object(MS, "ssd_op", SK.ssd_scan_plain),
            mock.patch.object(K, "fleet_step", K.fleet_step_plain),
            mock.patch.object(K, "fleet_step_q", K.fleet_step_q_plain))


def lm_config(arch):
    """The full-width config of ``arch`` and the wrapper of the kernel its
    prefill launches once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.ssd import kernel as SK
    cfg = get_config(arch)
    return cfg, (SK.ssd_scan if cfg.layout == "ssm" else TA.flash_attention)


def rel_err(got, want):
    """Largest |got - want| over the largest |want| across steps."""
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / \
        max(float(w.abs().max()) for w in want)


def replay_adapter(cfg, params, hs, dev):
    """The adapter state after feeding ``hs`` to `plastic.decode_step` with
    the plain fleet steps, from a fresh cache."""
    from repro_torch.models import plastic, transformer
    state = transformer.init_cache(cfg, LM_BATCH, 8, device=dev)["adapter"]
    with contextlib.ExitStack() as stack:
        for p in plain_kernels():
            stack.enter_context(p)
        for h in hs:
            _, state = plastic.decode_step(params["adapter"], state, h, cfg)
    return state


def lm_path(dev, counters, every, results, arch="qwen3-4b"):
    """Serve 4 x 2048-token prompts with 32 greedy tokens on random-init
    ``arch`` at full width and depth (qwen3-4b: 36 attention layers;
    mamba2-1.3b: 48 SSM layers; bf16), the plastic adapter in float32 then
    int8, through `launch.serve.generate`: each datapath once to warm up,
    then once timed.  Every counter is set to 0 just before the timed run
    and read just after it."""
    import torch
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.launch import serve
    from repro_torch.models import factory, plastic
    cfg, mixer = lm_config(arch)
    cfg = cfg.with_(plastic_adapter=True, adapter_neurons=128)
    model = factory.build(cfg)
    gen = torch.Generator(dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    torch.cuda.synchronize()
    log(f"  {arch}: {model.n_params() / 1e9:.3f} B parameters, random "
        f"init in {time.perf_counter() - t0:.1f} s")
    out, total = {}, {c.__name__: 0 for c in counters}
    for quant in (False, True):
        mode = "int8" if quant else "float32"
        qcfg = cfg.with_(adapter_quant=quant)
        step = K.fleet_step_q if quant else K.fleet_step
        serve.generate(qcfg, params, prompts, LM_PROMPT + LM_GEN, LM_GEN)
        torch.cuda.synchronize()
        steps = []
        for c in every:
            c.launches = 0
        with recording(plastic, "decode_step", steps):
            toks, lats, cache, prefill_s = serve.generate(
                qcfg, params, prompts, LM_PROMPT + LM_GEN, LM_GEN)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        require(mixer.launches == cfg.n_layers,
                f"{mode}: {mixer.launches} {mixer.__name__} launches in one "
                f"prefill, want {cfg.n_layers}")
        require(step.launches == LM_GEN,
                f"{mode}: {step.launches} {step.__name__} launches in "
                f"{LM_GEN} decode steps, want {LM_GEN}")
        ad = cache["adapter"]
        require(tuple(toks.shape) == (LM_BATCH, LM_GEN)
                and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
                f"{mode}: bad generated tokens")
        require(int((ad["t"] == LM_GEN).sum()) == LM_BATCH
                and float(ad["w_fast"].float().abs().max()) > 0,
                f"{mode}: the adapter's fast weights did not move")
        p50 = sorted(lats)[len(lats) // 2] * 1e3
        tps = LM_BATCH * len(lats) / sum(lats)
        out[mode] = dict(prefill_ms=prefill_s * 1e3, decode_ms_p50=p50,
                         decode_ms_mean=sum(lats) / len(lats) * 1e3,
                         tokens_per_s=tps, launches=launches)
        for name, n in launches.items():
            total[name] += n
        log(f"  serve {mode:7s}: prefill {prefill_s * 1e3:.1f} ms, decode "
            f"p50 {p50:.3f} ms/token step, {tps:.1f} tokens/s; launches "
            f"{launches}")
        # every adapter step of the timed run (one fleet-step launch each)
        # against the plain fleet step on the same state and hidden state,
        # then the adapter state after the run against the plain fleet
        # steps fed the run's hidden states from the start
        replay_launches(steps, plain_adapter_step, step.__name__, results,
                        f"{mode} serve (adapter steps)", quant, (1e-5, 1e-5))
        state = replay_adapter(qcfg, params, [a[2] for a, _, _ in steps],
                               dev)
        if quant:
            for k, want in state.items():
                require(torch.equal(ad[k], want),
                        f"int8 adapter {k}: the timed run differs from the "
                        f"plain fleet steps on the same hidden states")
            log(f"  int8 adapter state after {LM_GEN} steps: bitwise equal "
                f"to the plain fleet steps on the same hidden states")
        else:
            err, share = drift([ad[k] for k in state], list(state.values()))
            out[mode]["adapter_drift"] = dict(max_abs=err, share_1e4=share)
            log(f"  float32 adapter state after {LM_GEN} steps against the "
                f"plain fleet steps on the same hidden states (not gated): "
                f"max |diff| {err:.3g}, share outside 1e-4 {share:.3g}")
        del cache, ad, steps, state
    # full depth, bf16: kernel path against the plain path (not gated);
    # for the SSM layout also two plain paths that differ only in the SSD
    # chunk length, i.e. in float32 summation order: how far bf16 rounding
    # alone moves this random-init model
    got, toks = serve_logits(cfg, params, prompts, LM_GEN)
    with contextlib.ExitStack() as stack:
        for p in plain_kernels():
            stack.enter_context(p)
        want, _ = serve_logits(cfg, params, prompts, LM_GEN, toks)
        if cfg.layout == "ssm":
            from repro_torch.kernels.ssd import kernel as SK
            from repro_torch.models import ssm as MS
            stack.enter_context(mock.patch.object(
                MS, "ssd_op", lambda *a, chunk: SK.ssd_scan_plain(
                    *a, chunk=64)))
            other, _ = serve_logits(cfg, params, prompts, LM_GEN, toks)
    pairs = [("kernel vs plain path", got, want)]
    if cfg.layout == "ssm":
        pairs.append(("plain path, chunk 64 vs 256", other, want))
    out["bf16_full_depth"] = {}
    for what, x, y in pairs:
        agree = float(torch.stack([g.argmax(-1) == w.argmax(-1)
                                   for g, w in zip(x, y)]).float().mean())
        err, err0 = rel_err(x, y), rel_err(x[:1], y[:1])
        out["bf16_full_depth"][what] = dict(
            max_rel_logit_diff=err, prefill_rel_logit_diff=err0,
            greedy_agreement=agree)
        log(f"  bf16, {cfg.n_layers} layers, {what}: max rel logit diff "
            f"{err:.3g} (prefill logits {err0:.3g}), greedy agreement "
            f"{agree:.3f}")
    del got, want, pairs
    # profile one prefill, then 8 decode steps after it
    from repro_torch.launch.steps import make_decode_step, make_prefill
    prefill = make_prefill(cfg, LM_PROMPT + 8)
    made = []
    log("  one prefill of 4 x 2048 tokens:")
    out["profile_prefill"] = profile_window(
        lambda: made.append(prefill(params, prompts)), 1)
    logits, cache = made.pop()
    decode = make_decode_step(cfg)
    tok = logits.argmax(-1).to(torch.int32)[:, None]

    def eight():
        nonlocal cache
        for _ in range(8):
            _, cache = decode(params, cache, tok)

    log("  8 decode steps, float32 adapter:")
    out["profile_decode"] = profile_window(eight, 8)
    del params, cache
    torch.cuda.empty_cache()
    return out, total


def lm_depth2_matches(dev, arch="qwen3-4b"):
    """Full width, 2 layers, float32: prefill and decode logits through the
    kernels equal the plain path's within 1e-4 of the largest logit, and
    the greedy tokens are the same."""
    import torch
    from repro_torch.models import factory
    for quant in (False, True):
        cfg = lm_config(arch)[0].with_(n_layers=2, dtype="float32",
                                       plastic_adapter=True,
                                       adapter_neurons=128,
                                       adapter_quant=quant)
        gen = torch.Generator(dev).manual_seed(SEED + 1)
        params = factory.build(cfg).init(gen)
        prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                                generator=gen, device=dev)
        got, toks = serve_logits(cfg, params, prompts, LM_GEN)
        with contextlib.ExitStack() as stack:
            for p in plain_kernels():
                stack.enter_context(p)
            want, _ = serve_logits(cfg, params, prompts, LM_GEN, toks)
        err = rel_err(got, want)
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        mode = "int8" if quant else "float32"
        require(err <= 1e-4 and same,
                f"2-layer float32 ({mode} adapter): kernel path differs from "
                f"the plain path (max rel logit diff {err:.3g}, greedy "
                f"tokens {'equal' if same else 'differ'})")
        log(f"  {arch}, 2 layers, float32, {mode} adapter: max rel logit diff "
            f"{err:.3g} over prefill + {LM_GEN} steps, greedy tokens equal")
        del params, got, want
        torch.cuda.empty_cache()


def ssm_state_matches(dev):
    """Full width, 2 layers, float32: the SSM state and conv window that a
    300-token prompt (a ragged last chunk) leaves in the cache through #8
    equal the same prompt fed token by token through `decode_step` from a
    zeroed cache, within 2e-3."""
    import torch
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import factory
    cfg = lm_config("mamba2-1.3b")[0].with_(n_layers=2, dtype="float32")
    model = factory.build(cfg)
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    params = model.init(gen)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, 300), generator=gen,
                           device=dev)
    launches = SK.ssd_scan.launches
    _, got = model.prefill(params, prompt, 300)
    require(SK.ssd_scan.launches == launches + cfg.n_layers,
            "the 300-token prefill did not launch ssd_scan per layer")
    want = model.init_cache(LM_BATCH, 300, device=dev)
    for t in range(prompt.shape[1]):
        _, want = model.decode_step(params, want, prompt[:, t:t + 1])
    torch.cuda.synchronize()
    for k in ("ssm", "conv"):
        g, w = got["segments"][0][k], want["segments"][0][k]
        err = float((g - w).abs().max())
        require(torch.allclose(g, w, rtol=SSD_TOL[0], atol=SSD_TOL[1]),
                f"prefilled {k} state differs from the token-by-token "
                f"recurrence: max err {err} (scale {float(w.abs().max())})")
        log(f"  prefilled {k} state of a 300-token prompt against 300 decode "
            f"steps: max |err| {err:.3g} (largest |value| "
            f"{float(w.abs().max()):.3g})")
    del params, got, want
    torch.cuda.empty_cache()


def serve_cli_default(results, arch="qwen3-4b"):
    """`python -m repro_torch.launch.serve --arch <arch> --plastic` at its
    defaults (4 prompts of 32 tokens, 16 generated), in this process; each
    attention or SSD-scan launch and each fleet-step launch of the run is
    then held against its plain version on its own inputs."""
    import io
    import torch
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch import serve
    from repro_torch.models import attention as MA, plastic, ssm as MS
    cfg, mixer = lm_config(arch)
    ssm = cfg.layout == "ssm"
    buf, mixes, steps = io.StringIO(), [], []
    with contextlib.redirect_stdout(buf), \
            recording(MS if ssm else MA, "ssd_op" if ssm else "attn_op",
                      mixes), \
            recording(plastic, "decode_step", steps):
        rc = serve.main(["--arch", arch, "--plastic"])
    out = json.loads(buf.getvalue())
    name = mixer.__name__
    require(rc == 0 and out["launches"][name] == cfg.n_layers
            and out["launches"]["fleet_step"] == 16,
            f"serve CLI default: rc {rc}, launches {out['launches']}")
    if ssm:
        replay_launches(mixes, SK.ssd_scan_plain, name, results,
                        "serve CLI", False, None, close=ssd_close)
    else:
        replay_launches(mixes, TA.flash_attention_plain, name, results,
                        "serve CLI", False, ATTN_TOL["bfloat16"])
    replay_launches(steps, plain_adapter_step, "fleet_step", results,
                    "serve CLI (adapter steps)", False, (1e-5, 1e-5))
    del mixes, steps
    log(f"  serve CLI default (4 x 32 + 16): prefill {out['prefill_ms']:.1f}"
        f" ms, decode p50 {out['decode_ms_p50']:.3f} ms, "
        f"{out['tokens_per_s']:.1f} tokens/s, launches {out['launches']}")
    torch.cuda.empty_cache()
    return out


# ---- phase 2e: the telemetry variants against their plain versions --------

TEL_TOL = 2e-4                  # float32 rows; tests/test_obs.py:198
TEL_FIELDS = ("spike_rate", "mean_abs_dw", "sat_frac", "occupancy")


def held_telemetry(name, got, off, want, quant, results, what, active):
    """A telemetry launch: its state bit for bit against the same launch
    without telemetry, its state against the plain version (``held``), its
    row bit for bit (int8) or within TEL_TOL (float32), zeros in vacant
    slots."""
    import torch
    torch.cuda.synchronize()
    require(all(torch.equal(g, o) for g, o in zip(got[:-1], off)),
            f"{name} {what}: state differs from the telemetry-off launch")
    err = float((got[-1].double() - want[-1].double()).abs().max())
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    if quant:
        require(torch.equal(got[-1], want[-1]),
                f"{name} {what}: row not bitwise equal to plain (max err "
                f"{err})")
    else:
        require(err <= TEL_TOL, f"{name} {what}: row err {err} > {TEL_TOL}")
    require(not got[-1][~active].any(),
            f"{name} {what}: a vacant slot reports telemetry")
    log(f"  {name:22s} {what}: state = telemetry-off launch bit for bit, "
        f"row max |err| {err:.3g}, vacant rows 0")


def compare_telemetry(dev, results):
    """Each telemetry variant at 8-128-8 and B = 4096 with 3/4 of the slots
    active and a teaching signal."""
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.core import engine, snn
    from repro_torch.kernels.plasticity import fused, kernel as K
    from repro_torch.kernels.plasticity.quant import QuantConfig
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    qc = QuantConfig()
    active = torch.rand(B, generator=gen, device=dev) < 0.75
    for n, m, spiking in ((8, 128, True), (128, 8, False)):
        for quant in (False, True):
            x, w, theta, v, tpre, tpost = rand_fleet_inputs(
                gen, B, n, m, quant, dev)
            if quant:
                teach = torch.randint(-300, 300, (B, m), generator=gen,
                                      device=dev, dtype=torch.int32)
                scale = torch.where(torch.arange(B, device=dev) % 2 == 0,
                                    1 / 32, 1 / 16).float()
                seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,),
                                     generator=gen, device=dev,
                                     dtype=torch.int64).int()
                args = (x, w, scale, theta, v, tpre, tpost)
                kw = dict(qcfg=qc, spiking=spiking, seed=seed, teach=teach,
                          active=active)
                fn, plain, name = (K.fleet_step_q, K.fleet_step_q_plain,
                                   "fleet_step_q_telemetry")
            else:
                teach = 0.5 * torch.randn(B, m, generator=gen, device=dev)
                args = (x, w, theta, v, tpre, tpost)
                kw = dict(spiking=spiking, teach=teach, active=active)
                fn, plain, name = (K.fleet_step, K.fleet_step_plain,
                                   "fleet_step_telemetry")
            got = fn(*args, telemetry=True, **kw)
            off = fn(*args, **kw)
            want = plain(*args, telemetry=True, **kw)
            held(name, got[:4], want[:4], quant, results,
                 f"N={n} M={m} state against plain")
            held_telemetry(name, got, off, want, quant, results,
                           f"N={n} M={m}", active)
    for quant in (False, True):
        cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
               else firefly_snn.CONFIG)
        params = [cfg.engine_params(i) for i in range(cfg.num_layers)]
        mode = "int8" if quant else "float32"
        for k in (4, 16):
            st, theta, drives = net_inputs(gen, cfg, k, dev)
            m_out = cfg.layer_sizes[-1]
            teach = (torch.randint(-300, 300, (B, m_out), generator=gen,
                                   device=dev, dtype=torch.int32) if quant
                     else 0.5 * torch.randn(B, m_out, generator=gen,
                                            device=dev))
            kw = dict(params=params, teach=teach, active=active,
                      block_b=cfg.block_b)
            got = engine.rollout(st, theta, drives, telemetry=True, **kw)
            off = engine.rollout(st, theta, drives, **kw)
            with mock.patch.object(fused, "rollout", plain_rollout):
                want = engine.rollout(st, theta, drives, telemetry=True, **kw)
            flat = lambda r: (list(r[0].w) + list(r[0].v) + list(r[0].trace)
                              + [r[1]])
            rows = lambda r: torch.stack([getattr(r[2], f)
                                          for f in TEL_FIELDS], 1)
            if quant:
                held("rollout_telemetry", flat(got), flat(want), True,
                     results, f"{mode} K={k} state against plain")
            else:
                err, share = drift(flat(got), flat(want))
                log(f"  rollout_telemetry      {mode} K={k} state against "
                    f"plain: max |err| {err:.3g}, share outside 1e-4 "
                    f"{share:.2e} (gated in phase 2)")
            held_telemetry("rollout_telemetry",
                           flat(got) + [rows(got)], flat(off),
                           flat(want) + [rows(want)], quant, results,
                           f"{mode} K={k}", active)


# ---- phase 5: the telemetry variants' times ----------------------------------

# Telemetry's extra operations: per (stream, column) |event|, compare, two
# adds and the shuffle tree's share; per synapse a subtraction, |.| and add.
OPS_TEL_COL, OPS_TEL_SYN = 6, 3


def time_telemetry(dev, results):
    """Each telemetry variant beside its telemetry-off twin and its plain
    version at the phase-4 shapes, L2 flushed; the overhead in percent."""
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    from repro_torch.kernels.plasticity import fused, kernel as K
    from repro_torch.kernels.plasticity.quant import QuantConfig
    gen = torch.Generator(dev).manual_seed(SEED + 10)
    qc = QuantConfig()
    sizes = firefly_snn.CONFIG.layer_sizes
    active = torch.rand(B, generator=gen, device=dev) < 0.75
    for name, quant in (("fleet_step_telemetry", False),
                        ("fleet_step_q_telemetry", True)):
        ms, off_ms, pms, bms = [], [], [], []
        for i in range(len(sizes) - 1):
            n, m = sizes[i], sizes[i + 1]
            spiking = i < len(sizes) - 2
            x, w, theta, v, tpre, tpost = rand_fleet_inputs(
                gen, B, n, m, quant, dev)
            if quant:
                sc = torch.full((B,), 1 / 32, device=dev)
                sd = torch.arange(B, dtype=torch.int32, device=dev)
                args = (x, w, sc, theta, v, tpre, tpost)
                kw = dict(qcfg=qc, spiking=spiking, seed=sd, active=active)
                fn, plain = K.fleet_step_q, K.fleet_step_q_plain
            else:
                args = (x, w, theta, v, tpre, tpost)
                kw = dict(spiking=spiking, active=active)
                fn, plain = K.fleet_step, K.fleet_step_plain
            ms.append(device_ms(lambda: fn(*args, telemetry=True, **kw)))
            off_ms.append(device_ms(lambda: fn(*args, **kw)))
            pms.append(device_ms(lambda: plain(*args, telemetry=True, **kw),
                                 reps=5))
            ops = B * n * m * ((OPS_Q if quant else OPS_F32) + OPS_TEL_SYN) \
                + B * m * OPS_TEL_COL
            bms.append(bound(step_bytes(B, n, m, 1 if quant else 4)
                             + B * 3 * 4, ops)[0])
        results[name].update(
            ms=statistics.mean(ms), plain_ms=statistics.mean(pms),
            bound_ms=statistics.mean(bms), bound_by="bytes",
            off_ms=statistics.mean(off_ms),
            overhead_pct=100 * (statistics.mean(ms) / statistics.mean(off_ms)
                                - 1))
    k = firefly_snn.CONFIG.timesteps
    syn = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    timed = {}
    for quant in (False, True):
        cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
               else firefly_snn.CONFIG)
        st, theta, drives = net_inputs(gen, cfg, k, dev)
        kw = dict(spiking=[cfg.engine_params(i).spiking for i in range(2)],
                  plastic=[True, True], tau_m=cfg.lif.tau_m,
                  trace_decay=cfg.trace_decay, w_clip=cfg.w_clip,
                  qcfg=cfg.quant, active=active)
        if quant:
            kw.update(scales=list(st.w_scale),
                      seed=st.t.expand(B).contiguous())
        args = (drives, st.w, theta, st.v, st.trace)
        t_on = device_ms(lambda: fused.rollout(
            *args, block_b=cfg.block_b, telemetry=True, **kw))
        t_off = device_ms(lambda: fused.rollout(*args, block_b=cfg.block_b,
                                                **kw))
        ops = k * B * syn * (OPS_Q if quant else OPS_F32) \
            + k * B * sum(sizes[1:]) * OPS_TEL_COL + B * syn * OPS_TEL_SYN
        b_ms, kind = bound(window_bytes(B, sizes, k, 1 if quant else 4)
                           + B * 3 * 4, ops)
        timed["int8" if quant else "float32"] = dict(
            ms=t_on, off_ms=t_off, overhead_pct=100 * (t_on / t_off - 1),
            plain_ms=device_ms(lambda: fused.rollout_plain(
                *args, telemetry=True, **kw), reps=5),
            bound_ms=b_ms, bound_by=kind)
    results["rollout_telemetry"].update(timed["float32"])
    results["rollout_telemetry"]["int8"] = timed["int8"]
    for name in ("fleet_step_telemetry", "fleet_step_q_telemetry",
                 "rollout_telemetry"):
        r = results[name]
        log(f"  {name:22s} {r['ms']:.4f} ms beside {r['off_ms']:.4f} ms "
            f"without telemetry ({r['overhead_pct']:+.1f}%), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    r = results["rollout_telemetry"]["int8"]
    log(f"  rollout_telemetry int8  {r['ms']:.4f} ms beside {r['off_ms']:.4f}"
        f" ms without telemetry ({r['overhead_pct']:+.1f}%), plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")


# ---- phase 10: session serving of the controller fleet at full width --------

POPULATION = 2 * B              # users who come and go
SERVE_WINDOWS = 24              # control windows under churn
SERVE_STEPS = 16                # per-event telemetry steps after them
DEPART_P = 0.02                 # per resident and window
PROBE_CUT = 12                  # the window before which the probe moves
VACANT = 256                    # slots left empty for the frozen check
TAIL_WINDOWS = 8                # windows of the frozen check, and profiled


def store_digest(root):
    """sha256 over every session's latest checkpoint under a store root
    (LATEST, manifest and leaves), and the number of sessions."""
    import hashlib
    h, n = hashlib.sha256(), 0
    for user in sorted(Path(root).iterdir()):
        if not (user / "LATEST").exists():
            continue            # checked out fresh, never persisted
        latest = (user / "LATEST").read_text().strip()
        step = user / f"step_{int(latest):09d}"
        h.update(f"{user.name}:{latest}".encode())
        for f in sorted(step.iterdir()):
            h.update(f.read_bytes())
        n += 1
    return h.hexdigest(), n


class ServeRun:
    """One deterministic serving run on a FleetScheduler: admissions from a
    population, churn before each window, the probe moved once, per-event
    steps, a frozen-vacancy check.  Records the probe's call sequence and
    outputs for the uninterrupted replay."""

    def __init__(self, sched, seed):
        import numpy as np
        self.s = sched
        self.rng = np.random.default_rng(seed)
        self.base = np.random.default_rng(seed + 1).standard_normal(
            (POPULATION + 1, sched.cfg.layer_sizes[0])).astype(np.float32)
        self.index = {f"u{i}": i for i in range(POPULATION)}
        self.index["probe"] = POPULATION
        self.calls = []          # (kind, probe's drive, probe's output)
        self.window = 0

    def drives(self, t):
        import numpy as np
        mat = (np.sin(0.5 * t + self.base) * 1.5).astype(np.float32)
        return {u: mat[self.index[u]] for u in self.s.active_users}

    def churn(self):
        """Each resident but the probe departs with DEPART_P; as many
        arrivals come from the population's non-residents."""
        s = self.s
        residents = [u for u in s.slot_user if u is not None and u != "probe"]
        gone = [u for u, r in zip(residents,
                                  self.rng.random(len(residents)))
                if r < DEPART_P]
        for u in gone:
            s.evict(u)
        out = sorted(set(self.index) - set(s.user_slot) - {"probe"},
                     key=self.index.get)
        for u in self.rng.choice(out, len(gone), replace=False):
            s.admit(str(u))
        return len(gone)

    def call(self, kind, churn=True):
        import torch
        if churn:
            self.churn()
        d = self.drives(self.window)
        if kind == "window":
            out = self.s.control_step(d)
        elif kind == "telemetry window":
            out, tel = self.s.pool_step(d, telemetry=True)
        else:
            out, tel = self.s.step(d, telemetry=True)
        self.calls.append((kind, d["probe"], out["probe"]))
        self.window += 1

    def move_probe(self):
        """Evict the probe to disk, drop its warm-cache entry, let a rival
        take its slot, and re-admit it into another slot."""
        s = self.s
        old = s.user_slot["probe"]
        s.evict("probe")
        s.store._warm.pop("probe")
        rival = next(u for u in self.index if u not in s.user_slot
                     and u != "probe")
        require(s.admit(rival) == old, "the rival did not take the slot")
        s.evict(next(u for u in s.slot_user if u not in (None, rival)))
        restores = s.store.restores
        new = s.admit("probe")
        require(new != old and s.store.restores == restores + 1,
                "the probe did not come back from disk into another slot")
        return old, new


def serve_run(dev, quant, root, profile=None):
    """The phase-10 sequence on a fresh B = 4096 pool; returns the run and
    its measurements."""
    import numpy as np
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    from repro_torch.kernels import _build
    from repro_torch.kernels.plasticity import fused
    from repro_torch.serving import FleetScheduler, SessionStore
    cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
           else firefly_snn.CONFIG)
    theta = snn.init_theta(cfg, torch.Generator(dev).manual_seed(SEED + 11),
                           scale=0.05)
    sched = FleetScheduler(cfg, theta, slots=B, device=dev,
                           store=SessionStore(root=str(root),
                                              capacity=B // 2))
    run = ServeRun(sched, SEED + 12)
    sched.admit("probe")
    for u in run.rng.choice(POPULATION, B - 1, replace=False):
        sched.admit(f"u{u}")
    out = {"quant": quant, "theta": theta}
    kinds = ["telemetry window" if w % 4 == 3 else "window"
             for w in range(SERVE_WINDOWS)]
    launches0 = getattr(fused.rollout, "launches", 0)   # 0 when plain
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w, kind in enumerate(kinds):
        if w == PROBE_CUT:
            out["probe_slots"] = run.move_probe()
        run.call(kind)
        if w == 3:              # warm-up: every entry point once
            run.call("step", churn=False)
            torch.cuda.synchronize()
            warm = (sched.compiled_programs(), len(_build._libs))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out.update(seconds=dt, windows_per_s=SERVE_WINDOWS / dt,
               control_steps_per_s=SERVE_WINDOWS * B / dt,
               rollout_launches_per_window=(
                   getattr(fused.rollout, "launches", 0) - launches0)
               / SERVE_WINDOWS)
    for _ in range(SERVE_STEPS):
        run.call("step", churn=False)
    # vacant slots stay frozen bit for bit over TAIL_WINDOWS windows
    for u in run.rng.choice([u for u in sched.slot_user if u != "probe"],
                            VACANT, replace=False):
        sched.evict(str(u))
    vacant = [s for s, u in enumerate(sched.slot_user) if u is None]
    before = [t[vacant].clone() for t in sched.fleet.w + sched.fleet.v
              + sched.fleet.trace + sched.fleet.w_scale]
    for _ in range(TAIL_WINDOWS):
        run.call("window", churn=False)
    after = [t[vacant] for t in sched.fleet.w + sched.fleet.v
             + sched.fleet.trace + sched.fleet.w_scale]
    require(all(torch.equal(a, b) for a, b in zip(after, before)),
            f"{len(vacant)} vacant slots moved over {TAIL_WINDOWS} windows")
    out["vacant_frozen"] = len(vacant)
    # TAIL_WINDOWS more windows under churn, profiled in the main run
    tail = lambda: [run.call("window") for _ in range(TAIL_WINDOWS)]
    if profile is not None:
        out["profile"] = profile(tail, TAIL_WINDOWS)
    else:
        tail()
    torch.cuda.synchronize()
    require(sched.compiled_programs() == warm[0]
            and len(_build._libs) == warm[1],
            f"static signatures after warm-up {warm} became "
            f"{sched.compiled_programs()}, {len(_build._libs)} libraries")
    out["signatures"] = sched.compiled_programs()
    sched.evict("probe")
    out["probe_final"], out["probe_step"] = sched.store.checkout(
        "probe", lambda: snn.init_state(cfg, device=dev), device=dev)
    snap = sched.metrics.snapshot()
    out["metrics"] = {k: snap[k] for k in (
        "pool_admit_seconds", "pool_evict_seconds", "fleet_spike_rate",
        "fleet_mean_abs_dw", "fleet_sat_frac", "fleet_occupancy")}
    out["admit_ms"] = {"p50": snap["pool_admit_seconds"]["p50"] * 1e3,
                       "mean": snap["pool_admit_seconds"]["mean"] * 1e3}
    out["evict_ms"] = {"p50": snap["pool_evict_seconds"]["p50"] * 1e3,
                       "mean": snap["pool_evict_seconds"]["mean"] * 1e3}
    st = sched.store
    out["store"] = dict(warm_hits=st.warm_hits, restores=st.restores,
                        creates=st.creates, persists=st.persists)
    out["pool_nbytes"] = sched.pool_nbytes()
    out["sched"], out["run"] = sched, run
    return out


def replay_probe(dev, res):
    """The probe's calls again on a pool where nothing interrupts it: its
    outputs and final state must equal the interrupted run's bit for bit."""
    import torch
    from repro_torch.core import snn
    from repro_torch.serving import FleetScheduler, SessionStore
    sched = res["sched"]
    ref = FleetScheduler(sched.cfg, res["theta"], slots=8, device=dev,
                         store=SessionStore())
    ref.admit("probe")
    for i, (kind, d, got) in enumerate(res["run"].calls):
        obs = {"probe": d}
        if kind == "window":
            want = ref.control_step(obs)["probe"]
        elif kind == "telemetry window":
            want = ref.pool_step(obs, telemetry=True)[0]["probe"]
        else:
            want = ref.step(obs, telemetry=True)[0]["probe"]
        require(torch.equal(got, want),
                f"probe call {i} ({kind}) differs from the uninterrupted run")
    ref.evict("probe")
    final, step = ref.store.checkout(
        "probe", lambda: snn.init_state(sched.cfg, device=dev), device=dev)
    got = res["probe_final"]
    require(step == res["probe_step"]
            and all(torch.equal(a, b) for a, b in zip(
                got.w + got.v + got.trace + got.w_scale,
                final.w + final.v + final.trace + final.w_scale)),
            "the probe's final state differs from the uninterrupted run")
    return len(res["run"].calls)


def serve_path(dev, every):
    """Phase 10: FleetScheduler at 8-128-8 with 4096 slots, float32 and
    int8, each with a SessionStore on disk.  Every counter is set to 0
    just before the two runs and read just after them."""
    import tempfile
    import torch
    from repro_torch.kernels.plasticity import fused, kernel as K
    tel_counters = (K.fleet_step, K.fleet_step_q, fused.rollout)
    for c in every:
        c.launches = 0
    for c in tel_counters:
        c.telemetry_launches = 0
    work = ROOT / "build" / "chip_smoke_sessions"
    work.mkdir(parents=True, exist_ok=True)
    runs = {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        for quant in (False, True):
            mode = "int8" if quant else "float32"
            runs[mode] = serve_run(
                dev, quant, Path(tmp) / mode,
                profile=lambda fn, n: profile_window(fn, n))
        launches = {"rollout": fused.rollout.launches,
                    "rollout_telemetry": fused.rollout.telemetry_launches,
                    "fleet_step_telemetry": K.fleet_step.telemetry_launches,
                    "fleet_step_q_telemetry":
                        K.fleet_step_q.telemetry_launches}
        log(f"  launches on the serving path: {json.dumps(launches)}")
        for name, n in launches.items():
            require(n > 0, f"kernel {name} was not launched on the serving "
                    f"path")
        report = {}
        for mode, r in runs.items():
            calls = replay_probe(dev, r)
            log(f"  {mode}: the probe moved from slot {r['probe_slots'][0]} "
                f"to {r['probe_slots'][1]} through disk; its {calls} calls "
                f"and final state equal the uninterrupted run bit for bit")
            log(f"  {mode}: {SERVE_WINDOWS} windows x {B} slots under churn "
                f"in {r['seconds']:.3f} s = {r['windows_per_s']:.4g} "
                f"windows/s, {r['control_steps_per_s']:.4g} control-steps/s;"
                f" {r['rollout_launches_per_window']:.3g} rollout launches "
                f"per window")
            log(f"  {mode}: admit p50 {r['admit_ms']['p50']:.3f} ms, mean "
                f"{r['admit_ms']['mean']:.3f} ms; evict p50 "
                f"{r['evict_ms']['p50']:.3f} ms, mean "
                f"{r['evict_ms']['mean']:.3f} ms; store "
                f"{json.dumps(r['store'])}")
            log(f"  {mode}: fleet gauges " + json.dumps(
                {k: r["metrics"][k]["value"] for k in r["metrics"]
                 if k.startswith("fleet_")}))
            log(f"  {mode}: {r['vacant_frozen']} vacant slots frozen bit for "
                f"bit over {TAIL_WINDOWS} windows; static signatures "
                f"constant after warm-up: {json.dumps(r['signatures'])}")
            report[mode] = {k: r[k] for k in (
                "seconds", "windows_per_s", "control_steps_per_s",
                "rollout_launches_per_window", "admit_ms", "evict_ms",
                "store", "signatures", "vacant_frozen", "pool_nbytes",
                "profile", "probe_slots")}
            report[mode]["fleet_gauges"] = {
                k: r["metrics"][k]["value"] for k in r["metrics"]
                if k.startswith("fleet_")}
        # the int8 run again through the plain versions: same bits
        kern = runs["int8"]
        digest = store_digest(Path(tmp) / "int8")
        with mock.patch.object(fused, "rollout", plain_rollout), \
                mock.patch.object(K, "fleet_step_q", K.fleet_step_q_plain):
            t0 = time.perf_counter()
            plain = serve_run(dev, True, Path(tmp) / "int8-plain")
            dt = time.perf_counter() - t0
        a, b = kern["sched"].fleet, plain["sched"].fleet
        require(all(torch.equal(x, y) for x, y in zip(
            a.w + a.v + a.trace + a.w_scale, b.w + b.v + b.trace + b.w_scale)),
            "int8 serving: the plain versions give another final pool")
        plain_digest = store_digest(Path(tmp) / "int8-plain")
        require(digest == plain_digest,
                f"int8 serving: the plain versions persist other sessions "
                f"({digest} vs {plain_digest})")
        log(f"  int8 run repeated through the plain versions ({dt:.1f} s): "
            f"final pool and all {digest[1]} persisted sessions bit for bit "
            f"(sha256 {digest[0][:16]})")
        report["int8"]["plain_repeat_seconds"] = dt
        report["int8"]["sessions_on_disk"] = digest[1]
    return report, launches


def nvidia_smi():
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() \
            else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.lif import kernel as L
    from repro_torch.kernels.plasticity import fused, kernel as K
    from repro_torch.kernels.ssd import kernel as SK
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t_all = time.perf_counter()

    seconds = {}

    @contextlib.contextmanager
    def phase(title):
        """Log the phase's title, then its seconds when it ends."""
        log(title)
        t0 = time.perf_counter()
        yield
        seconds[title.split(":")[0]] = dt = time.perf_counter() - t0
        log(f"  ({title.split(':')[0]}: {dt:.1f} s)")

    with phase("phase 1: build"):
        info = _build.build_all()
        log(f"  built {len(info['log'])} sources in {info['seconds']:.1f} s")
        for src, text in info["log"].items():
            for line in text.splitlines():
                if "Used" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")

    counters = (K.fleet_step, K.fleet_step_q, fused.rollout)
    online_counters = (fused.rollout_shared, K.shared_step, K.shared_step_q,
                       L.lif_forward)
    lm_counters = (TA.flash_attention, SK.ssd_scan, K.fleet_step,
                   K.fleet_step_q)
    every = counters + online_counters + (TA.flash_attention, SK.ssd_scan)
    results = {name: {"name": name, "route": "cuda",
                      "source": SOURCES[name], "replaces": REPLACES[name],
                      "launches": 0, "max_abs_err": 0.0, "ms": None,
                      "plain_ms": None, "bound_ms": None, "bound_by": None,
                      "library_ms": None}
               for name in SOURCES}

    with phase("phase 2: kernels against their plain versions"):
        compare_fleet_steps(dev, results)
        compare_rollouts(dev, results)
        compare_shared_steps(dev, results)
        compare_shared_rollouts(dev, results)
        compare_lif(dev, results)
    with phase("phase 2c: flash attention against its plain version"):
        compare_attention(dev, results)
    with phase("phase 2d: the SSD scan against its plain version"):
        compare_ssd(dev, results)
    with phase("phase 2e: the telemetry variants against their plain "
               "versions, 8-128-8, B = 4096"):
        compare_telemetry(dev, results)

    with phase("phase 3: recovery gate"):
        recovery_gate(dev)

    with phase("phase 4: main path, 8-128-8 controller, B = 4096"):
        main, launches = main_path(dev, counters, every)
        for name, n in launches.items():
            results[name]["launches"] = n
        plain_closed_loop_matches(dev, main)
    with phase("phase 4b: where the closed loop's time goes (20 control "
               "steps)"):
        profiled = profile_closed_loop(dev, main)

    with phase("phase 5: timing"):
        time_kernels(dev, results)
        time_telemetry(dev, results)

    with phase("phase 6: online-learning path, 784-1024-10, T = 8, B = 1"):
        online, online_launches = online_path(dev, online_counters, every)
        for name, n in online_launches.items():
            results[name]["launches"] = n
        plain_stream_matches(dev, online)
    with phase("phase 6b: where the online stream's time goes (10 digits)"):
        profiled_online = profile_online(online)

    with phase("phase 7: Table II timings and the new kernels (L2 "
               "flushed)"):
        table = table2(dev, online)
        time_new_kernels(dev, results)
    with phase("phase 7b: the attention kernel at the prefill shape (L2 "
               "flushed)"):
        time_attention(dev, results)
    with phase("phase 7c: the SSD scan at the prefill shape (L2 flushed)"):
        time_ssd(dev, results)

    lm, lm_launches = {}, {}
    for tag, arch, n_mix in (("8", "qwen3-4b", "36 attention"),
                             ("9", "mamba2-1.3b", "48 SSM")):
        with phase(f"phase {tag}: LM serving, {arch} at full width "
                   f"({n_mix} layers), B = 4, prompt 2048, 32 generated "
                   f"tokens, plastic adapter"):
            lm[arch], lm_launches[arch] = lm_path(dev, lm_counters, every,
                                                  results, arch)
        with phase(f"phase {tag}b: {arch}, 2 layers at full width in "
                   f"float32, kernels against the plain path"):
            lm_depth2_matches(dev, arch)
            if arch == "mamba2-1.3b":
                ssm_state_matches(dev)
        with phase(f"phase {tag}c: the serve CLI at its defaults, --arch "
                   f"{arch}"):
            lm[arch]["serve_cli_default"] = serve_cli_default(results, arch)
    results["flash_attention"]["launches"] = \
        lm_launches["qwen3-4b"]["flash_attention"]
    results["ssd_scan"]["launches"] = lm_launches["mamba2-1.3b"]["ssd_scan"]

    with phase(f"phase 10: session serving, 8-128-8 FleetScheduler, "
               f"{B} slots, float32 and int8"):
        served, serve_launches = serve_path(dev, every)
    for name in ("fleet_step_telemetry", "fleet_step_q_telemetry",
                 "rollout_telemetry"):
        results[name]["launches"] = serve_launches[name]

    for r in results.values():
        lib = (f", library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        log(f"  {r['name']:14s} {r['ms']:.4f} ms/launch (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}{lib}), {r['launches']} launches")
    for name in ("rollout", "rollout_shared", "rollout_telemetry"):
        log(f"  {name} int8: {json.dumps(results[name]['int8'])}")
    log(f"  phase seconds: {json.dumps(seconds)}")

    report = {"kernels": list(results.values()),
              "main_path": {m: {"control_steps_per_s": v["rate"],
                                "seconds": v["seconds"]}
                            for m, v in main.items()},
              "online_path": {m: {"digits_per_s": online[m]["digits_per_s"],
                                  "seconds": online[m]["seconds"],
                                  "accuracy": online[m]["acc"]}
                              for m in ("float32", "int8")},
              "table2": table,
              "lm_path": lm, "lm_launches": lm_launches,
              "serve_path": served, "serve_launches": serve_launches,
              "profile": profiled, "profile_online": profiled_online,
              "build_seconds": info["seconds"], "card": smi,
              "phase_seconds": seconds,
              "seconds": time.perf_counter() - t_all}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": report["kernels"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Check as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
