#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold every kernel against its
plain version.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from ``src/repro_torch/csrc`` (parallel nvcc);
  2. compare every kernel with its plain PyTorch version on the card, at the
     shapes of the paper's 8-128-8 controller with B = 4096 streams;
  3. the recovery gate on the card: both gate scenarios x {float32, int8},
     plastic recovers >= 1/2 of the return drop, frozen <= 1/4;
  4. the main path at full width: `firefly_snn.CONFIG` (8-128-8, T = 4) in
     the closed loop on `direction` with B = 4096 controllers for 260 steps
     (one rollout-kernel launch per control step), then the per-event path
     (`snn.timestep`, one fleet-step launch per layer per timestep), in
     float32 and int8; the int8 closed loop is repeated through the plain
     rollout and must give the same bits;
  5. time each kernel and its plain version with CUDA events.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, when there is no CUDA device or the package is not beside it.
"""
from __future__ import annotations

import dataclasses
import json
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

SOURCES = {"fleet_step": "src/repro_torch/csrc/fleet_step.cu",
           "fleet_step_q": "src/repro_torch/csrc/fleet_step.cu",
           "rollout": "src/repro_torch/csrc/rollout.cu"}
REPLACES = {"fleet_step": "src/repro/kernels/plasticity/kernel.py:256",
            "fleet_step_q": "src/repro/kernels/plasticity/kernel.py:559",
            "rollout": "src/repro/kernels/plasticity/fused.py:304"}


def log(*a):
    print(*a, flush=True)


class Check(Exception):
    pass


def require(cond, what):
    if not cond:
        raise Check(what)


# ---- timing and bounds -------------------------------------------------------

def median_ms(fn, reps=20, warmup=3):
    """Median time of one call on the card, by CUDA events around each."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
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


def step_bytes(b, n, m, wb, sb=4):
    """One fleet-step launch: every input read once, every output written
    once (x, w, theta, v, traces in; events, v, trace, w out)."""
    return (b * n * sb + b * n * m * wb + 4 * n * m * 4 + b * m * sb * 2
            + b * n * sb + b * m * sb * 3 + b * n * m * wb)


def window_bytes(b, sizes, k, wb, sb=4):
    """One rollout launch: drives and outputs once per step, the weights,
    theta, membranes and traces once per window each way."""
    syn = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    return (k * b * sizes[0] * sb + k * b * sizes[-1] * sb
            + 2 * b * syn * wb + 4 * syn * 4 + 2 * b * sum(sizes[1:]) * sb
            + 2 * b * sum(sizes) * sb)


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
            torch.cuda.synchronize()
            err = max(float((g.double() - h.double()).abs().max())
                      for g, h in zip(got, want))
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
            if quant:
                require(all(torch.equal(g, h) for g, h in zip(got, want)),
                        f"{name} N={n} M={m}: not bitwise equal to plain "
                        f"(max err {err})")
            else:
                for g, h in zip(got, want):
                    require(torch.allclose(g, h, rtol=1e-5, atol=1e-5),
                            f"{name} N={n} M={m}: max err {err} > 1e-5")
            if active is not None:
                off = ~active
                require(torch.equal(got[3][off], w[off])
                        and not got[0][off].any(),
                        f"{name}: inactive slots not frozen")
            log(f"  {name:13s} N={n:3d} M={m:3d} spiking={spiking!s:5s} "
                f"active={'mask' if mask else 'all '}: max |err| {err:.3g}")


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
            torch.cuda.synchronize()
            g = [got[1]] + list(got[0].w) + list(got[0].v) + list(got[0].trace)
            h = ([want[1]] + list(want[0].w) + list(want[0].v)
                 + list(want[0].trace))
            err = max(float((a.double() - c.double()).abs().max())
                      for a, c in zip(g, h))
            outside = sum(int((~torch.isclose(a.double(), c.double(),
                                              rtol=1e-4, atol=1e-4)).sum())
                          for a, c in zip(g, h))
            share = outside / sum(a.numel() for a in g)
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

def main_path(dev, counters):
    """Closed loop (rollout kernel) and per-event steps (fleet-step kernels)
    of the 8-128-8 controller for B = 4096 streams, float32 and int8."""
    import torch
    from repro_torch import envs, scenarios as S
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    env = envs.make("direction", episode_len=STEPS)
    out = {}
    for c in counters:
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


def profile_closed_loop(dev, main, steps=20):
    """Device busy share and device time by kernel over `steps` control
    steps of the full-width closed loop (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for mode, m in main.items():
        prog = m["prog"]
        short = dataclasses.replace(prog, steps=steps)
        short.run(m["theta"], SEED, tasks="train", device=dev)   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            short.run(m["theta"], SEED, tasks="train", device=dev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out[mode] = {
            "steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "kernel_launches_per_step": launches / steps,
            "top": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top]}
        log(f"  {mode:7s}: {steps} steps in {wall_ms:.1f} ms wall, device busy "
            f"{busy_ms:.2f} ms ({launches / steps:.0f} kernel launches per "
            f"control step)" if busy_ms else
            f"  {mode:7s}: profiler saw no device time (not measured)")
        for t in out[mode]["top"]:
            log(f"      {t['ms']:8.3f} ms  x{t['count']:<5d} {t['name']}")
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
            ms.append(median_ms(run))
            pms.append(median_ms(plain, reps=5))
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
            ms=median_ms(run), plain_ms=median_ms(plain, reps=5),
            bound_ms=b_ms, bound_by=kind)
    results["rollout"].update(timed["float32"])
    results["rollout"]["int8"] = timed["int8"]


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
    from repro_torch.kernels.plasticity import fused, kernel as K
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t_all = time.perf_counter()

    log("phase 1: build")
    info = _build.build_all()
    log(f"  built {len(info['log'])} sources in {info['seconds']:.1f} s")
    for src, text in info["log"].items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    counters = (K.fleet_step, K.fleet_step_q, fused.rollout)
    results = {name: {"name": name, "route": "cuda",
                      "source": SOURCES[name], "replaces": REPLACES[name],
                      "launches": 0, "max_abs_err": 0.0, "ms": None,
                      "plain_ms": None, "bound_ms": None, "bound_by": None,
                      "library_ms": None}
               for name in SOURCES}

    log("phase 2: kernels against their plain versions")
    compare_fleet_steps(dev, results)
    compare_rollouts(dev, results)

    log("phase 3: recovery gate")
    recovery_gate(dev)

    log("phase 4: main path, 8-128-8 controller, B = 4096")
    main, launches = main_path(dev, counters)
    for name, n in launches.items():
        results[name]["launches"] = n
    plain_closed_loop_matches(dev, main)
    log("phase 4b: where the closed loop's time goes (20 control steps)")
    profiled = profile_closed_loop(dev, main)

    log("phase 5: timing")
    time_kernels(dev, results)
    for r in results.values():
        log(f"  {r['name']:13s} {r['ms']:.4f} ms/launch (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']})")
    log(f"  rollout int8: {json.dumps(results['rollout']['int8'])}")

    report = {"kernels": list(results.values()),
              "main_path": {m: {"control_steps_per_s": v["rate"],
                                "seconds": v["seconds"]}
                            for m, v in main.items()},
              "profile": profiled,
              "build_seconds": info["seconds"], "card": smi,
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
