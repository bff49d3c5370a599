"""Time-fused rollout window: K timesteps x L layers in ONE kernel launch.

The per-step path launches one fleet-step kernel per layer per timestep —
K * L launches per control window, each re-reading and re-writing the whole
state through device memory.  `rollout` runs the entire window as one launch
of ``csrc/rollout.cu``: each CTA keeps its block of streams' weights, the
shared theta planes, membranes, all L+1 traces and the inter-layer event bus
in shared memory for the window and writes the state back once.

Semantics, identical to K per-step calls (`rollout_plain` is that loop):

  * the input population's trace is updated from the drive first, gated by
    the active mask;
  * each layer's plasticity reads the UNGATED post trace (equal to the gated
    one for active streams; inactive streams keep their old weights);
  * step k of layer i draws its stochastic round from
    ``fold_seed(seed + k, i)`` and the layer's own flat index;
  * a readout layer's output is its membrane, zeroed for inactive streams;
  * an optional teaching current drives the LAST layer, per step (K, B, M).

``telemetry=True`` (fleet only) also returns the window's per-slot
telemetry row ``(B, 3) float32``, already normalized and gated: mean
|event| and saturated share over the K * L layer steps, and the net weight
motion |w_end - w_start| / (N_i * M_i) per plastic layer over K * n_plastic
(``csrc/rollout.cu``'s telemetry variant; `rollout_plain` is its plain
version).

FLEET mode (``w (B, N, M)``) launches ``csrc/rollout.cu`` (`rollout`);
SHARED-weight mode (``w (N, M)``, batched activations, batch-averaged dw)
launches ``csrc/rollout_shared.cu`` (`rollout_shared`): one cooperative
launch whose co-resident CTAs each own a slice of every layer's columns for
the whole window, with one grid barrier per layer boundary per step.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.plasticity import fma32
from repro_torch.kernels import _build
from repro_torch.kernels.plasticity import kernel as _k
from repro_torch.kernels.plasticity import quant as Q
from repro_torch.kernels.plasticity import ref as _ref
from repro_torch.obs.telemetry import sat_threshold, sat_threshold_q

MAX_LAYERS = 8                    # ff::kMaxLayers
DEFAULT_SMEM_LIMIT = 232448       # H100: 227 KB of dynamic shared memory

_P = ctypes.c_void_p


class _RolloutArgs(ctypes.Structure):
    """``RolloutArgs`` of csrc/rollout.cu."""
    _fields_ = [(name, _P) for name in (
        "drives", "outs", "teach", "active", "seed")] + [
        (name, _P * MAX_LAYERS) for name in (
            "w_in", "w_out", "theta", "scale", "v_in", "v_out")] + [
        ("tr_in", _P * (MAX_LAYERS + 1)), ("tr_out", _P * (MAX_LAYERS + 1)),
        ("sizes", ctypes.c_int * (MAX_LAYERS + 1))] + [
        (name, ctypes.c_int) for name in (
            "n_layers", "k_steps", "batch", "block_b", "spiking_mask",
            "plastic_mask", "theta_in_smem")] + [
        ("w_clip", ctypes.c_float), ("f", _k.FParams), ("q", _k.QParams),
        ("tel", _P), ("telemetry", ctypes.c_int), ("sat_q", ctypes.c_int),
        ("sat_f", ctypes.c_float)]


def rollout_smem_bytes(sizes, block_b: int, plastic, quant: bool,
                       theta_in_smem: bool, telemetry: bool = False) -> int:
    """Shared memory of one CTA: theta planes (if resident), membranes,
    traces, the double-buffered event bus, the active flags, the block's
    weights and, with ``telemetry``, the (block_b, 2) float accumulator —
    the layout of ``csrc/rollout.cu``."""
    def al(x):
        return (x + 15) // 16 * 16
    n_layers = len(sizes) - 1
    syn = sum(sizes[i] * sizes[i + 1] for i in range(n_layers))
    th = sum(4 * sizes[i] * sizes[i + 1] for i in range(n_layers)
             if plastic[i]) if theta_in_smem else 0
    return (al(th * 4) + al(block_b * sum(sizes[1:]) * 4)
            + al(block_b * sum(sizes) * 4)
            + al(2 * block_b * max(sizes) * 4) + al(block_b * 4)
            + al(block_b * syn * (1 if quant else 4))
            + (al(block_b * 8) if telemetry else 0))


def smem_limit(device) -> int:
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       DEFAULT_SMEM_LIMIT))


def smem_plan(sizes, block_b: int, plastic, quant: bool,
              limit: int, telemetry: bool = False) -> tuple[int, bool]:
    """``(bytes, theta_in_smem)`` of one CTA: theta resident when it fits,
    else read from device memory (through L2); raises when even the state
    of ``block_b`` streams does not fit — the kernel does not fall back."""
    for theta_in_smem in (True, False):
        smem = rollout_smem_bytes(sizes, block_b, plastic, quant,
                                  theta_in_smem, telemetry)
        if smem <= limit:
            return smem, theta_in_smem
    raise ValueError(
        f"rollout working set of {smem} bytes for block_b={block_b} and "
        f"layer sizes {list(sizes)} exceeds the {limit} bytes of shared "
        f"memory a CTA may use; lower block_b")


class _SharedRolloutArgs(ctypes.Structure):
    """``SharedRolloutArgs`` of csrc/rollout_shared.cu."""
    _fields_ = [(name, _P) for name in (
        "drives", "outs", "teach", "seed")] + [
        (name, _P * MAX_LAYERS) for name in (
            "w_in", "w_out", "theta", "scale", "v_in", "v_out")] + [
        ("tr_in", _P * (MAX_LAYERS + 1)), ("tr_out", _P * (MAX_LAYERS + 1)),
        ("bus", _P * MAX_LAYERS),
        ("sizes", ctypes.c_int * (MAX_LAYERS + 1)),
        ("cols", ctypes.c_int * MAX_LAYERS)] + [
        (name, ctypes.c_int) for name in (
            "n_layers", "k_steps", "batch", "spiking_mask", "plastic_mask",
            "theta_in_smem")] + [
        ("w_clip", ctypes.c_float), ("f", _k.FParams), ("q", _k.QParams)]


SHARED_THREADS, SHARED_CHUNK = 256, 8      # csrc/rollout_shared.cu


def shared_smem_bytes(sizes, cols, batch: int, plastic, quant: bool,
                      theta_in_smem: bool) -> int:
    """Shared memory of one CTA of the shared-weight window: per layer its
    columns' theta (if resident), weights, membranes and post traces; the
    input trace, two staging rows, the pre/post sums and the partial-sum
    buffer — the layout of ``csrc/rollout_shared.cu``."""
    def al(x):
        return (x + 15) // 16 * 16
    n_layers = len(sizes) - 1
    widest = max(sizes[:n_layers])
    total = 0
    for i in range(n_layers):
        nc = sizes[i] * cols[i]
        if theta_in_smem and plastic[i]:
            total += al(16 * nc)
        total += al(nc * (1 if quant else 4)) + 2 * al(batch * cols[i] * 4)
    return (total + al(batch * sizes[0] * 4) + 2 * al(batch * widest * 4)
            + al(widest * 4) + al(32 * 4)
            + al(SHARED_THREADS // 32 * SHARED_CHUNK * 32 * 4))


def shared_plan(sizes, batch: int, plastic, quant: bool, sms: int,
                limit: int) -> dict:
    """Grid and residency of the shared-weight window: CTA g owns columns
    ``[g * c_i, (g + 1) * c_i)`` of layer i, with ``c_i`` the power of two
    that spreads the widest layer over at most ``sms`` CTAs.  Theta is
    resident when the whole layout fits, else read through L2; raises when
    the owned weights and state alone do not fit one CTA."""
    m_max = max(sizes[1:])
    grid = min(sms, m_max)
    cols = []
    for m in sizes[1:]:
        c = 1 << max(0, (-(-m // grid) - 1).bit_length())
        if c > 32:
            raise ValueError(f"shared-weight rollout: a layer of {m} columns "
                             f"needs {c} columns per CTA on {sms} SMs; the "
                             f"kernel takes at most 32")
        cols.append(c)
    grid = max(-(-m // c) for m, c in zip(sizes[1:], cols))
    for theta_in_smem in (True, False):
        smem = shared_smem_bytes(sizes, cols, batch, plastic, quant,
                                 theta_in_smem)
        if smem <= limit:
            return dict(grid=grid, cols=cols, smem=smem,
                        theta_in_smem=theta_in_smem)
    raise ValueError(
        f"shared-weight rollout working set of {smem} bytes per CTA for "
        f"layer sizes {list(sizes)} and B = {batch} exceeds the {limit} "
        f"bytes of shared memory a CTA may use")


def _event_units(out, spiking: bool, qcfg):
    """|events| in event units from a layer's gated output: a readout's
    output is its membrane, mapped back through its event nonlinearity
    (tanh, or the fixed-point clip); zeroed outputs stay zero."""
    if qcfg is not None:
        ev = out if spiking else torch.clamp(out, -qcfg.one, qcfg.one)
        return ev.abs().float() / qcfg.one
    return (out if spiking else torch.tanh(out)).abs()


def _window_telemetry(acc, ws0, ws, plastic, scales, active, k_steps, qcfg):
    """Finalize a window's (B, 2) [spike, saturation] accumulator and net
    weight motion into the gated (B, 3) row (`fused.py:256-283` of the JAX
    package)."""
    n_layers = len(ws)
    kl = float(k_steps * n_layers)
    spike_rate, sat_frac = acc[:, 0] / kl, acc[:, 1] / kl
    plast = [i for i in range(n_layers) if plastic[i]]
    mean_dw = torch.zeros_like(spike_rate)
    if plast:
        for i in plast:
            n_i, m_i = ws[i].shape[-2], ws[i].shape[-1]
            if qcfg is not None:
                d = (ws[i].to(torch.int32) - ws0[i].to(torch.int32)).abs()
                per_slot = d.sum((1, 2), dtype=torch.int32).float() \
                    * torch.as_tensor(scales[i], dtype=torch.float32,
                                      device=acc.device).reshape(-1)
            else:
                per_slot = (ws[i] - ws0[i]).abs().sum((1, 2))
            mean_dw = mean_dw + per_slot / (n_i * m_i)
        mean_dw = mean_dw / float(k_steps * len(plast))
    row = torch.stack([spike_rate, mean_dw, sat_frac], dim=1)
    if active is not None:
        row = row * active.reshape(-1, 1).float()
    return row


def rollout_plain(drives, ws, thetas, vs, traces, *, spiking, plastic,
                  tau_m: float = 2.0, v_th: float = 1.0, v_reset: float = 0.0,
                  trace_decay: float = 0.8, w_clip: float = 4.0, qcfg=None,
                  scales=None, seed=None, teach=None, active=None,
                  telemetry: bool = False):
    """The window as a Python loop over K of the plain per-layer steps.

    Arguments as `rollout`; also takes shared weights ``(N, M)``.  Returns
    ``(outs, ws, vs, traces)`` with outs (K, B, M_last), plus the (B, 3)
    telemetry row with ``telemetry`` (fleet only).
    """
    n_layers = len(ws)
    fleet = ws[0].ndim == 3
    if telemetry and not fleet:
        raise ValueError("telemetry is a fleet-mode contract (per-slot rows "
                         "need a leading stream rank)")
    ws0 = ws
    ws, vs, trs = list(ws), list(vs), list(traces)
    gate = None if active is None else active.reshape(-1).bool()[:, None]
    acc = (torch.zeros((drives.shape[1], 2), dtype=torch.float32,
                       device=drives.device) if telemetry else None)
    sat_thr = (None if not telemetry else sat_threshold(v_th)
               if qcfg is None else sat_threshold_q(v_th, qcfg))
    outs = []
    for k in range(drives.shape[0]):
        x = drives[k]
        if qcfg is not None:
            tr0 = Q.trace_update_q(trs[0], x, qcfg)
        else:
            tr0 = fma32(trace_decay, trs[0], x)
        trs[0] = tr0 if gate is None else torch.where(gate, tr0, trs[0])
        for i in range(n_layers):
            kw = dict(v_th=v_th, v_reset=v_reset, w_clip=w_clip,
                      plastic=plastic[i], spiking=spiking[i],
                      teach=None if teach is None or i < n_layers - 1
                      else teach[k])
            if fleet:
                kw["active"] = active
            if qcfg is not None:
                fn = (_ref.dual_engine_fleet_step_q if fleet
                      else _ref.dual_engine_step_q)
                res = fn(x, ws[i], scales[i], thetas[i], vs[i], trs[i],
                         trs[i + 1], qcfg=qcfg,
                         seed=Q.fold_seed(seed.long() + k, i), **kw)
            else:
                fn = (_ref.dual_engine_fleet_step if fleet
                      else _ref.dual_engine_step)
                res = fn(x, ws[i], thetas[i], vs[i], trs[i], trs[i + 1],
                         tau_m=tau_m, trace_decay=trace_decay, **kw)
            events, vs[i], trs[i + 1], ws[i] = res
            x = events if spiking[i] else vs[i]
            if gate is not None and not spiking[i]:
                x = torch.where(gate, x, torch.zeros_like(x))
            if telemetry:
                m_i = x.shape[-1]
                sat = (vs[i].abs() >= sat_thr).float()
                acc = acc + torch.stack(
                    [_event_units(x, spiking[i], qcfg).sum(1) / m_i,
                     sat.sum(1) / m_i], dim=1)
        outs.append(x)
    out = (torch.stack(outs), tuple(ws), tuple(vs), tuple(trs))
    if not telemetry:
        return out
    return out + (_window_telemetry(acc, ws0, ws, plastic, scales, active,
                                    drives.shape[0], qcfg),)


def _layer_flags(spiking, plastic, thetas):
    """Per-layer flags as bool tuples; a plastic layer needs its theta."""
    plastic = tuple(bool(p) for p in plastic)
    for i, p in enumerate(plastic):
        if p and thetas[i] is None:
            raise ValueError(f"layer {i} marked plastic but theta is None")
    return tuple(bool(s) for s in spiking), plastic


def _window_args(a, drives, ws, thetas, vs, traces, *, fleet, spiking,
                 plastic, tau_m, v_th, v_reset, trace_decay, w_clip, qcfg,
                 scales, seed, teach):
    """Check a window's operands, allocate its outputs and fill the fields
    both rollout kernels' argument structs share.  Returns ``((outs, ws,
    vs, traces), keep)``: ``keep`` holds the checked inputs alive until the
    launch."""
    n_layers = len(ws)
    if n_layers > MAX_LAYERS:
        raise ValueError(f"rollout kernel takes at most {MAX_LAYERS} layers")
    quant = qcfg is not None
    k_steps, b, n0 = drives.shape
    dev = drives.device
    sizes = [n0] + [w.shape[-1] for w in ws]
    lead = (b,) if fleet else ()          # fleet: one weight set per stream
    state_dt = torch.int32 if quant else torch.float32
    w_dt = torch.int8 if quant else torch.float32
    drives = _k.expect("drives", drives, (k_steps, b, n0), state_dt, dev)
    ws = [_k.expect(f"w[{i}]", ws[i], (*lead, sizes[i], sizes[i + 1]), w_dt,
                    dev) for i in range(n_layers)]
    vs = [_k.expect(f"v[{i}]", vs[i], (b, sizes[i + 1]), state_dt, dev)
          for i in range(n_layers)]
    trs = [_k.expect(f"trace[{i}]", traces[i], (b, sizes[i]), state_dt, dev)
           for i in range(n_layers + 1)]
    ths = [_k.expect(f"theta[{i}]", thetas[i], (4, sizes[i], sizes[i + 1]),
                     torch.float32, dev) if plastic[i] else None
           for i in range(n_layers)]
    if teach is not None:
        teach = teach.to(device=dev, dtype=state_dt).expand(
            k_steps, b, sizes[-1]).contiguous()
    per = b if fleet else 1               # scales and seeds per stream
    scs = [_k.per_stream(s, per, torch.float32, dev) for s in scales] \
        if quant else [None] * n_layers
    sd = _k.per_stream(seed, per, torch.int32, dev) if quant else None
    outs = torch.empty((k_steps, b, sizes[-1]), dtype=state_dt, device=dev)
    w_out = [torch.empty_like(w) for w in ws]
    v_out = [torch.empty_like(v) for v in vs]
    tr_out = [torch.empty_like(t) for t in trs]
    a.drives, a.outs = _k.ptr(drives), _k.ptr(outs)
    a.teach, a.seed = _k.ptr(teach), _k.ptr(sd)
    for i in range(n_layers):
        a.w_in[i], a.w_out[i] = _k.ptr(ws[i]), _k.ptr(w_out[i])
        a.theta[i], a.scale[i] = _k.ptr(ths[i]), _k.ptr(scs[i])
        a.v_in[i], a.v_out[i] = _k.ptr(vs[i]), _k.ptr(v_out[i])
    for i in range(n_layers + 1):
        a.tr_in[i], a.tr_out[i] = _k.ptr(trs[i]), _k.ptr(tr_out[i])
        a.sizes[i] = sizes[i]
    a.n_layers, a.k_steps, a.batch = n_layers, k_steps, b
    a.spiking_mask = sum(1 << i for i in range(n_layers) if spiking[i])
    a.plastic_mask = sum(1 << i for i in range(n_layers) if plastic[i])
    a.w_clip = w_clip
    a.f = _k.f_params(tau_m, v_th, v_reset, trace_decay)
    if quant:
        a.q = _k.q_params(qcfg, v_th, v_reset, batch=1 if fleet else b)
    alive = (drives, ws, vs, trs, ths, teach, scs, sd)
    return (outs, tuple(w_out), tuple(v_out), tuple(tr_out)), alive


def rollout(drives, ws, thetas, vs, traces, *, spiking, plastic,
            tau_m: float = 2.0, v_th: float = 1.0, v_reset: float = 0.0,
            trace_decay: float = 0.8, w_clip: float = 4.0, qcfg=None,
            scales=None, seed=None, teach=None, active=None,
            block_b: int = 8, telemetry: bool = False):
    """K fused timesteps of the whole layer stack.

    Args:
      drives:  (K, B, N0) time-major input window (int32 fixed point when
               ``qcfg``, float32 otherwise).
      ws:      per-layer fleet weights (B, N_i, M_i), or shared weights
               (N_i, M_i) (`rollout_shared`); int8 when ``qcfg``.
      thetas:  per-layer packed (4, N_i, M_i) rules; None where not plastic.
      vs:      per-layer membranes (B, M_i).
      traces:  L+1 population traces (B, N_i); traces[0] is the input.
      spiking/plastic: per-layer bool sequences.
      qcfg/scales/seed: fixed-point mode — per-layer (B,) weight scales and
               the (B,) base step counters.
      teach:   optional (K, B, M_last) teaching current for the last layer.
      active:  optional (B,) slot mask, constant over the window.
      block_b: streams per CTA (the kernel's residency unit).
      telemetry: fleet only — also return the window's (B, 3) telemetry
               row (the kernel's telemetry variant).

    Returns ``(outs, ws, vs, traces)``, outs (K, B, M_last), plus the
    telemetry row with ``telemetry``.  A CPU tensor runs `rollout_plain`; a
    CUDA tensor launches the fleet kernel (counted in
    ``rollout.launches``, its telemetry variant also in
    ``rollout.telemetry_launches``) or, for shared weights,
    `rollout_shared`.
    """
    spiking, plastic = _layer_flags(spiking, plastic, thetas)
    if not _k.on_card(drives):
        return rollout_plain(
            drives, ws, thetas, vs, traces, spiking=spiking, plastic=plastic,
            tau_m=tau_m, v_th=v_th, v_reset=v_reset, trace_decay=trace_decay,
            w_clip=w_clip, qcfg=qcfg, scales=scales, seed=seed, teach=teach,
            active=active, telemetry=telemetry)
    if ws[0].ndim != 3:
        if active is not None:
            raise ValueError("active slot masks are a fleet-mode contract")
        if telemetry:
            raise ValueError("telemetry is a fleet-mode contract (per-slot "
                             "rows need a leading stream rank)")
        return rollout_shared(
            drives, ws, thetas, vs, traces, spiking=spiking, plastic=plastic,
            tau_m=tau_m, v_th=v_th, v_reset=v_reset, trace_decay=trace_decay,
            w_clip=w_clip, qcfg=qcfg, scales=scales, seed=seed, teach=teach)
    b, quant = drives.shape[1], qcfg is not None
    sizes = [drives.shape[2]] + [w.shape[-1] for w in ws]
    a = _RolloutArgs()
    out, alive = _window_args(
        a, drives, ws, thetas, vs, traces, fleet=True, spiking=spiking,
        plastic=plastic, tau_m=tau_m, v_th=v_th, v_reset=v_reset,
        trace_decay=trace_decay, w_clip=w_clip, qcfg=qcfg, scales=scales,
        seed=seed, teach=teach)
    act = _k.active_mask(active, b, drives.device)
    a.active = _k.ptr(act)
    a.block_b = bb = min(block_b, b)
    tel = (torch.empty((b, 3), dtype=torch.float32, device=drives.device)
           if telemetry else None)
    a.tel, a.telemetry = _k.ptr(tel), int(telemetry)
    a.sat_q = sat_threshold_q(v_th, qcfg) if quant else 0
    a.sat_f = sat_threshold(v_th)
    smem, theta_in_smem = smem_plan(sizes, bb, plastic, quant,
                                    smem_limit(drives.device), telemetry)
    a.theta_in_smem = int(theta_in_smem)
    fn = _build.library("rollout.cu").rollout
    fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.c_int,
                   ctypes.c_size_t, _P]
    fn.restype = ctypes.c_int
    _build.check(fn(ctypes.byref(a), int(quant), smem,
                    _k.stream_of(drives)), "rollout")
    rollout.launches += 1
    rollout.telemetry_launches += int(telemetry)
    return out if tel is None else out + (tel,)


rollout.launches = 0
rollout.telemetry_launches = 0      # the telemetry variant's share


def rollout_shared(drives, ws, thetas, vs, traces, *, spiking, plastic,
                   tau_m: float = 2.0, v_th: float = 1.0,
                   v_reset: float = 0.0, trace_decay: float = 0.8,
                   w_clip: float = 4.0, qcfg=None, scales=None, seed=None,
                   teach=None):
    """K fused timesteps of a shared-weight layer stack in ONE cooperative
    launch of ``csrc/rollout_shared.cu`` (counted in
    ``rollout_shared.launches``).

    Arguments as `rollout` with ws (N_i, M_i), per-layer scales () and a
    scalar seed; state is batched (B, ·).  A CPU tensor runs
    `rollout_plain`.  Raises where the grid cannot be co-resident.
    """
    spiking, plastic = _layer_flags(spiking, plastic, thetas)
    if not _k.on_card(drives):
        return rollout_plain(
            drives, ws, thetas, vs, traces, spiking=spiking, plastic=plastic,
            tau_m=tau_m, v_th=v_th, v_reset=v_reset, trace_decay=trace_decay,
            w_clip=w_clip, qcfg=qcfg, scales=scales, seed=seed, teach=teach)
    b, n_layers, quant = drives.shape[1], len(ws), qcfg is not None
    sizes = [drives.shape[2]] + [w.shape[-1] for w in ws]
    a = _SharedRolloutArgs()
    out, alive = _window_args(
        a, drives, ws, thetas, vs, traces, fleet=False, spiking=spiking,
        plastic=plastic, tau_m=tau_m, v_th=v_th, v_reset=v_reset,
        trace_decay=trace_decay, w_clip=w_clip, qcfg=qcfg, scales=scales,
        seed=seed, teach=teach)
    dev = drives.device
    plan = shared_plan(
        sizes, b, plastic, quant,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        smem_limit(dev))
    bus = [torch.empty((2, 2, b, sizes[i + 1]), dtype=out[0].dtype,
                       device=dev) for i in range(n_layers - 1)]
    for i in range(n_layers):
        a.bus[i] = _k.ptr(bus[i]) if i < n_layers - 1 else None
        a.cols[i] = plan["cols"][i]
    a.theta_in_smem = int(plan["theta_in_smem"])
    fn = _build.library("rollout_shared.cu").rollout_shared
    fn.argtypes = [ctypes.POINTER(_SharedRolloutArgs), ctypes.c_int,
                   ctypes.c_int, ctypes.c_size_t, _P]
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(a), int(quant), plan["grid"], plan["smem"],
             _k.stream_of(drives))
    if err == 82:        # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(
            f"shared-weight rollout: {plan['grid']} CTAs of {plan['smem']} "
            f"bytes cannot all be resident on this card; the window needs "
            f"one co-resident grid")
    _build.check(err, "rollout_shared")
    rollout_shared.launches += 1
    return out


rollout_shared.launches = 0
