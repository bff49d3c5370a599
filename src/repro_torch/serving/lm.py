"""LM decode pool: continuous batching of plastic language-model streams.

The LM counterpart of `scheduler.FleetScheduler`: a fixed pool of B decode
slots whose session tree is the WHOLE per-stream decode state —

  * the backbone cache (K/V planes, Mamba2 SSM and conv states, a zsuper's
    stacked hybrid caches: any `models.factory` layout),
  * a per-slot sequence index (streams admitted at different times sit at
    different lengths),
  * the FireFly-P plastic adapter state: ``W_fast (N, N)`` float32 or int8
    (``cfg.adapter_quant``) with its per-session scale and step counter,
  * the pending next token.

Everything rides the generic `SessionPool` machinery: admission is one
B = 1 prefill (or a `SessionStore` restore) copied into a slot in place,
eviction is one slot copy plus a write-through persist, and the pool
decodes all B slots at once per token (`step`) or per K-token window
(`decode_window`, whose adapter runs `plastic.decode_rollout`: the K
plasticity steps of every resident stream in one fleet window launch on
the card).  Occupancy is an ``active (B,)`` operand, never a shape: vacant
slots are bit-exact no-ops (the cache rows and index hold, the adapter
freezes, and in a MoE layer the vacant token takes the sentinel expert,
so it never takes an active stream's expert capacity), and no host read
of the mask happens inside a step.  Under a MoE model's default capacity
an active stream's tokens still depend on its active neighbours (they
share each expert's rows); at ``capacity_factor >= num_experts`` no
assignment is dropped and they do not.

`compiled_programs()` counts, per entry point, the static signatures
dispatched (the port compiles nothing at serve time; see
`SessionPool._dispatch`): the keys are those of the JAX package's pool.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint import manager as _ckpt
from repro_torch.core.snn import resolve_device
from repro_torch.models import factory, plastic
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_from_plan
from repro_torch.obs import MetricsRegistry, phase
from repro_torch.obs import recorder as _recorder
from repro_torch.obs.health import HealthConfig
from repro_torch.obs.telemetry import (FleetTelemetry, adapter_telemetry,
                                       record_fleet_telemetry)
from repro_torch.serving.scheduler import SessionPool, uniform_axes
from repro_torch.serving.sessions import SessionStore


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


class LMScheduler(SessionPool):
    """Admit/evict LM user streams into a fixed pool of decode slots.

    Args:
      model:   a `factory.Model` (or anything `factory.build` accepts: a
               ModelConfig or an arch id).  ``cfg.adapter_quant`` makes the
               adapter rows an int8 pool.
      params:  model parameters, shared by every stream (the model is the
               deployment, the session is the user); the pool lives on
               their device.
      slots:   pool size B; fixes every pool tensor shape forever.
      max_len: cache length ceiling shared by all slots.
      store:   `SessionStore` backing eviction/restore.
      health:  optional `obs.health.HealthConfig`: ``record=`` stepping and
               the remediation loop of `SessionPool`.
    """

    ENTRY_POINTS = SessionPool.ENTRY_POINTS + (
        "prefill", "decode_step", "decode_window", "decode_step_telemetry",
        "decode_window_telemetry", "decode_step_record",
        "decode_window_record")

    def __init__(self, model, params, slots: int, max_len: int,
                 store: Optional[SessionStore] = None,
                 registry: Optional[MetricsRegistry] = None,
                 health: Optional[HealthConfig] = None):
        if not isinstance(model, factory.Model):
            model = factory.build(model)
        if model.cfg.input_mode != "tokens":
            raise ValueError(
                f"{model.cfg.name}: LMScheduler pools token streams; "
                f"input_mode {model.cfg.input_mode!r} is not poolable")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.max_len = int(max_len)
        dev = params["embed"].device
        pool = {"cache": model.pool_cache(slots, max_len, dev),
                "tok": torch.zeros((slots,), dtype=torch.int32, device=dev)}
        axes = {"cache": model.cache_axes(max_len), "tok": 0}
        # each slot's cache length on the host, so that a step that would
        # write past max_len's K/V rows is refused before dispatch with no
        # device read (a layout without attention has no such rows)
        self._length = np.zeros(slots, np.int64)
        self._kv_rows = any("k" in seg for seg in pool["cache"]["segments"])
        super().__init__(pool, axes, slots, store, registry, health=health)
        self._qcfg = plastic.QUANT if self.cfg.adapter_quant else None

    # ---- session construction --------------------------------------------

    def _session_factory(self):
        # slot 0 of the INITIAL pool, not zeros_like of it: an int8
        # adapter row carries a non-zero fresh w_scale
        return _ckpt.tree_map(torch.clone, self._zero_session)

    def _put_slot(self, slot: int, user) -> None:
        super()._put_slot(slot, user)
        self._length[slot] = (0 if user is self._zero_session
                              else int(user["cache"]["index"]))

    def load_pool(self, directory: str, step: Optional[int] = None) -> None:
        super().load_pool(directory, step)
        self._length = _host(self.pool["cache"]["index"]).astype(np.int64)

    def _prefill(self, prompt: torch.Tensor):
        """One B = 1 prefill -> a session row and its first greedy token."""
        self._dispatch("prefill", prompt)
        logits, cache = self.model.prefill(self.params, prompt[None, :],
                                           self.max_len)
        return {"cache": self.model.session_from_prefill(cache),
                "tok": logits[0].argmax(-1).to(torch.int32)}

    def admit_prompt(self, uid: str, prompt, evict_lru: bool = False) -> int:
        """Prefill `prompt` ((S,) int) into a fresh session and admit it.

        For a uid the `SessionStore` already knows, the persisted session
        (cache, adapter memory, pending token) is restored instead and the
        prompt is ignored: resumption, not re-prefill.  Returns the slot;
        the stream's first greedy token is `pending(uid)`.
        """
        prompt = torch.as_tensor(_host(prompt), dtype=torch.long,
                                 device=self.device)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be (S,), got "
                             f"{tuple(prompt.shape)}")
        return self.admit(uid, evict_lru=evict_lru,
                          factory=lambda: self._prefill(prompt))

    # ---- inspection -------------------------------------------------------

    def pending(self, uid: str) -> int:
        """The stream's next token (greedy argmax of its last logits)."""
        return int(self.pool["tok"][self.user_slot[uid]])

    def session_view(self, uid: str):
        """A copy of `uid`'s session tree, without evicting it."""
        return self._take(self.pool, self.user_slot[uid])

    # ---- stepping ---------------------------------------------------------

    def _require_adapter(self) -> None:
        if not self.cfg.plastic_adapter:
            raise ValueError(
                f"{self.cfg.name}: telemetry reads the plastic adapter "
                "cache; this model has cfg.plastic_adapter=False")

    def _check_room(self, k: int) -> list:
        """The slots a ``k``-token decode advances; raises ValueError,
        naming the sessions, where one would write past ``max_len``.  A
        frozen (quarantined) slot still reads the row at its length."""
        live, full = [], []
        for slot, uid in enumerate(self.slot_user):
            if uid is None:
                continue
            frozen = slot in self._quarantined
            if (self._kv_rows and self._length[slot] + (1 if frozen else k)
                    > self.max_len):
                full.append(f"{uid!r} ({self._length[slot]} tokens)")
            if not frozen:
                live.append(slot)
        if full:
            raise ValueError(
                f"a {k}-token decode would write past max_len = "
                f"{self.max_len} for session(s) {', '.join(full)}: evict "
                f"them first")
        return live

    def _run(self, kind: str, k: int, telemetry: bool, record: bool, decode,
             *operands):
        """Dispatch one ``k``-token decode entry point over the whole pool:
        ``decode (cache, active) -> (logits, new_cache, next tokens)``.
        Returns (logits, next tokens, telemetry or None)."""
        if record or telemetry:
            self._require_adapter()
        live = self._check_room(k)
        rec = self._ensure_recorder() if record else None
        active = self._active_mask()
        name = f"decode_{kind}" + ("_record" if record else
                                   "_telemetry" if telemetry else "")
        self._dispatch(name, self.pool, active, *operands,
                       *(() if rec is None else (rec,)))
        with phase(f"lm.decode_{kind}"):
            before = None
            if telemetry or record:
                # a copy of the leaves the telemetry reads: the step may
                # write the adapter in place
                before = {key: a.clone() for key, a in
                          self.pool["cache"]["adapter"].items()
                          if key in ("tr2", "w_fast", "w_scale")}
            logits, cache, nxt = decode(self.pool["cache"], active)
            self.pool["cache"] = cache
            self.pool["tok"] = torch.where(active, nxt, self.pool["tok"])
            self._length[live] += k
            tel = None
            if before is not None:
                tel = adapter_telemetry(before, cache["adapter"], active,
                                        qcfg=self._qcfg)
                if kind == "window":
                    # window means: net motion and recovered event mass
                    # over the K steps
                    tel = FleetTelemetry(
                        spike_rate=tel.spike_rate / k,
                        mean_abs_dw=tel.mean_abs_dw / k,
                        sat_frac=tel.sat_frac, occupancy=tel.occupancy)
            if record:
                # channels + the adapter weight norm -> ring and detectors
                # (one launch on the card); the verdict stays on the device
                self._rec, self.last_verdict = _recorder.record_step(
                    self.health_cfg, rec,
                    _recorder.AdapterLayers.of(cache["adapter"],
                                               self._qcfg is not None),
                    tel, self._rec_pos, active, self._qcfg is not None)
                self._rec_pos += 1
        if telemetry:
            record_fleet_telemetry(self.metrics, tel, prefix="adapter")
        return logits, nxt, tel

    def step(self, telemetry: bool = False, record: bool = False):
        """One greedy decode token for every admitted stream.

        Each stream consumes its pending token and produces the next;
        returns uid -> the new token (also the new pending token).

        ``telemetry=True`` (plastic-adapter models only) recovers the
        adapter's per-slot health vector from its cache delta, returns
        ``(tokens, FleetTelemetry)`` and records ``adapter_*`` gauges into
        ``self.metrics``.  ``record=True`` (with ``health=``) feeds the
        same channels and the adapter weight norm to the flight recorder
        and the detectors; the latched verdict waits on the device for
        `flagged_sessions` / `remediate`.
        """
        def decode(cache, active):
            logits, cache = self.model.decode_step(
                self.params, cache, self.pool["tok"][:, None], active=active)
            return logits, cache, logits.argmax(-1).to(torch.int32)

        _, nxt, tel = self._run("step", 1, telemetry, record, decode)
        self.advance_steps(1)
        nxt = nxt.cpu().numpy()
        toks = {uid: int(nxt[slot]) for uid, slot in self.user_slot.items()}
        return (toks, tel) if telemetry else toks

    def decode_window(self, windows: Mapping, telemetry: bool = False,
                      record: bool = False):
        """K teacher-forced tokens per stream, the adapter in ONE launch.

        `windows` maps uid -> ``(K,)`` int (one K for every stream),
        covering exactly the admitted sessions; ``windows[uid][0]`` is
        typically the stream's pending token.  Equal to K `step` calls on
        those tokens: the same cache writes and K adapter plasticity steps
        (one `plastic.decode_rollout`), the same stochastic-round stream
        in fixed point.  Returns uid -> ``(K, V)`` logits; the new pending
        token is the last position's argmax.

        ``telemetry=True`` returns ``(logits, FleetTelemetry)`` with the
        window-normalized adapter health; ``record=True`` records it as
        ONE flight-recorder observation (see `step`).
        """
        missing = [u for u in self.user_slot if u not in windows]
        extra = [u for u in windows if u not in self.user_slot]
        if missing or extra:
            raise ValueError(
                f"windows must cover exactly the admitted sessions; "
                f"missing {missing}, not admitted {extra}")
        rows = {u: _host(w).astype(np.int64) for u, w in windows.items()}
        ks = {int(w.shape[0]) for w in rows.values()}
        if len(ks) > 1:
            raise ValueError(f"all windows must share one length, got {ks}")
        k = ks.pop() if ks else 1
        tokens = np.zeros((self.slots, k), np.int64)
        for uid, w in rows.items():
            tokens[self.user_slot[uid]] = w
        tokens = torch.from_numpy(tokens).to(self.device)

        def decode(cache, active):
            logits, cache = self.model.decode_rollout(
                self.params, cache, tokens, active=active)
            return logits, cache, logits[:, -1].argmax(-1).to(torch.int32)

        logits, _, tel = self._run("window", k, telemetry, record, decode,
                                   tokens)
        self.advance_steps(k)
        out = {uid: logits[slot] for uid, slot in self.user_slot.items()}
        return (out, tel) if telemetry else out


class AdapterPool(SessionPool):
    """Adapter-state-only pool: the batch rows of `launch.serve`.

    The lockstep serve loop decodes a fixed batch at one shared cache
    index, so only the plastic adapter rows (each user's ``W_fast``,
    membranes, traces, step counter and, with ``cfg.adapter_quant``, its
    scale) are session state.  This pool IS the ``cache["adapter"]`` tree:
    admit users before `launch.serve.generate`, which installs
    ``pool.pool`` as the cache's adapter entry and hands the learned rows
    back, then evict to persist what each stream learned.
    ``device=None`` is the card.
    """

    def __init__(self, cfg: ModelConfig, slots: int,
                 store: Optional[SessionStore] = None,
                 registry: Optional[MetricsRegistry] = None, device=None,
                 health: Optional[HealthConfig] = None):
        if not cfg.plastic_adapter:
            raise ValueError(f"{cfg.name}: AdapterPool needs "
                             "cfg.plastic_adapter=True")
        self.cfg = cfg
        pool = init_from_plan(plastic.plan_cache(cfg, slots),
                              torch.Generator(resolve_device(device)))
        super().__init__(pool, uniform_axes(pool), slots, store, registry,
                         health=health)

    def _session_factory(self):
        # fresh sessions keep the plan's inits (int8 rows: w_scale != 0)
        return _ckpt.tree_map(torch.clone, self._zero_session)
