#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold every kernel against its
plain version.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from ``src/repro_torch/csrc`` (parallel nvcc);
  2. compare every kernel with its plain PyTorch version on the card: the
     fleet kernels at the shapes of the paper's 8-128-8 controller with
     B = 4096 streams, the fleet steps also at the LM adapter's 128x128
     with B = 4; the shared-weight step, the shared-weight rollout window
     and the LIF forward kernel at the 784-1024-10 MNIST network (the LIF
     kernel at both layers with B = 1 and 8 and at ragged shapes, its
     weights on a grid so that it equals its plain version bit for bit,
     and a second launch gives the same bits);
 2c. the flash-attention kernel against its plain version at qwen3-4b's
     prefill shape (B = 4, S = 2048, H = 32, HKV = 8, D = 128), a ragged
     S = 1000, a decode-shaped query against 2049 keys, a kv_len mask, the
     serve CLI's 32-token prompts, head width 64, Sq > Skv (rows with no
     visible key exactly 0) and V at 8x scale, then the other head widths
     of the configs: zamba2-7b's D = 112 at its prefill shape (H = HKV =
     32), decode-shaped and with a kv_len, and D = 16, 24, 32 at GQA over
     S = 1000, decode-shaped and with a ragged kv_len; bfloat16 (the
     Hopper kernel: TMA, mbarrier ring, wgmma with a split bf16 P) and
     float32 (the CUDA-core kernel);
  3. the recovery gate on the card: both gate scenarios x {float32, int8},
     plastic recovers >= 1/2 of the return drop, frozen <= 1/4;
  4. the controller path at full width: `firefly_snn.CONFIG` (8-128-8,
     T = 4) in the closed loop on `direction` with B = 4096 controllers for
     260 steps (one rollout-kernel launch per control step), then the
     per-event path (`snn.timestep`, one fleet-step launch per layer per
     timestep), in float32 and int8; the int8 closed loop is repeated
     through the plain rollout and must give the same bits;
  5. time each kernel and its plain version with CUDA events, the L2 cache
     flushed before each call; the fleet steps per layer shape (8->128,
     128->8 at B = 4096, the adapter's 128x128 at B = 4) in float32 and
     int8, telemetry off and on, the kernel alone (`torch.profiler`)
     beside the whole wrapper call, each launch's plan and CTAs an SM and
     ptxas registers; the fleet window's K sweep (8-128-8,
     B = 4096, K = 1, 2, 4, 8, 16, float32, int8 and bf16) fitted as fixed
     cost + K x per-step cost beside the bound's own split, each
     instantiation's launch (threads, shared memory, CTAs an SM holds by
     the occupancy query, CTAs launched) and its ptxas registers, spills
     and stack;
  6. the online-learning path at full width: `firefly_snn.MNIST`
     (784-1024-10, T = 8, B = 1) on 120 procedural digits, predict then
     learn (one shared-weight rollout launch per `classify_window`), then
     one digit per event (`snn.timestep`, one shared-step launch per layer
     per timestep) and through the Table II baselines (`lif_forward` per
     layer, then `apply_plasticity`), in float32 and int8; the int8 stream
     is repeated through the plain versions and must give the same bits;
  7. the Table II timings on the card (per timestep at B = 1: fused,
     forward-only, sequential, windowed), where 20 per-event timesteps'
     time goes (`torch.profiler`), and each new kernel's time with
     the L2 cache flushed between repetitions; the shared-weight window's
     K sweep (784-1024-10, B = 1, K = 1, 2, 4, 8, 16, float32, int8 and
     bf16) fitted as fixed cost + K x per-step cost beside the bound's own
     split, and the registers and spills ptxas gave each instantiation;
     the shared steps #4 and #5 per layer shape (784->1024 and 1024->10,
     B = 1 and 8): the kernel alone (`torch.profiler`) beside the whole
     call, which must run no device op beside the kernel (a 0-d scale and
     a number seed in int8), each launch's plan and CTAs an SM, and the
     registers and spills ptxas gave each kernel of `shared_step.cu`; the
     same for #6 (`lif_forward.cu`) at the same shapes, beside
     `torch.matmul` of its product, each after an L2 flush that writes
     the 1 GB buffer and after one that only reads it;
 7b. the attention kernel's time at the prefill shape beside its bound,
     its plain version and `scaled_dot_product_attention` (the yardstick),
     its TFLOP/s, its ratios to SDPA and to the bound, and the registers
     and spills ptxas gave the bf16 kernel; then at zamba2-7b's prefill
     shape (H = HKV = 32) D = 112 beside D = 128, and D = 16, 24, 32
     beside D = 64, each beside SDPA and its bound; the kernels line takes
     zamba2-7b's D = 112, whose path its `launches` count;
  8. LM serving at full width: random-init qwen3-4b (36 layers, bf16)
     serves 4 prompts of 2048 tokens and 32 greedy tokens through
     `launch.serve.generate`, plastic adapter in float32 and int8, each
     datapath once untimed (the prefill and 2 steps) and then timed: 36
     attention launches per
     prefill, 32 fleet-step launches per decode, each of those fleet-step
     launches against the plain step on its own inputs (int8 bit for bit,
     float32 within 1e-5), and the int8 adapter state after the timed run
     bit for bit against the plain fleet steps fed the same hidden states;
     the kernel path against the plain path at full depth in bf16
     (a prefill and 8 steps; printed, not gated) and a profile of 2
     decode steps; 8b. at full
     width with 2 layers in float32 the kernel path's logits equal the
     plain path's within 1e-4 of the largest logit and the greedy tokens
     are the same; 8c. the serve CLI at its defaults (4 x 32 + 16), each
     attention and fleet-step launch against its plain version on its own
     inputs;
 2d. the SSD-scan kernel against its plain version at mamba2-1.3b's
     prefill shape (B = 4, L = 2048, H = 64, P = 64, S = 128), ragged
     L = 1, 100 and 300, G = 2 groups by index, x, B and C cut from one
     packed projection (and from one shifted off 16 bytes: bfloat16's
     cp.async route), bfloat16 (the Hopper kernel: TMA or cp.async ring,
     wgmma with G, the state and w o x split into bf16 hi + lo) and
     float32 (the CUDA-core kernel), then zamba2-7b's prefill shape
     (H = 112, P = 64, S = 64; the TMA route) and its 32-token prompts;
     and against the literal recurrence at a small size;
 2g. silu (one pass, rounding after each op as ``jax.nn.silu`` is
     written) against its plain version, bit for bit, at every shape the
     LM paths give it: each full-width MLP's gate times x @ up, each
     Mamba2 conv activation and output gate (z read at the projection's
     row stride, times bf16 y at prefill and float32 y at decode), in bf16
     and the float32 of phases 8b, 9b and 11b;
 7c. the SSD-scan kernel's time at the prefill shape beside its bound and
     its plain version, at B = 1, and over an L sweep (512 to 4096 at
     B = 4) fitted as fixed + per-chunk cost beside the bound's own fit;
     the CTAs an SM holds and the registers and spills ptxas gave it;
     then at zamba2-7b's prefill shape (H = 112, P = 64, S = 64, x, B
     and C cut from the conv output, the TMA route), held against its
     plain version, beside its bound: the kernels line takes this row;
 7d. silu's time at zamba2-7b's prefill MLP (4 x 2048 x 14336, times
     x @ up; the kernels line's row), qwen3-4b's and zamba2-7b's conv
     activation, beside its plain version, ``F.silu`` (which rounds once)
     and its bound;
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
 11. phase 8 on random-init zamba2-7b (the hybrid layout: 9 super-blocks
     of the one shared attention + MLP block and 8 SSM layers, heads of
     112, bf16, 6.05 B parameters), after the previous model is freed:
     9 attention and 72 SSD-scan launches per prefill, the adapter checks
     of phase 8, the bf16 full-depth comparison (beside the two plain
     paths of phase 9) and the profile; 11b. at full width with 4 layers
     and a super-block of 3 (one super-block and one trailing SSM layer,
     the remainder segment) in float32, the kernel path's logits within
     1e-4 of the largest logit of the plain path's, the same greedy
     tokens; 11c. the serve CLI at its defaults with ``--arch zamba2-7b``,
     each attention, SSD-scan and silu launch against its plain version on
     its own inputs.  Phases 8, 9 and 11 count the silu launches of each
     prefill and decode step (one per MLP, two per Mamba2 block);
 2e. the telemetry variants of the fleet-step and rollout kernels against
     their plain versions at 8-128-8, B = 4096, 3/4 of the slots active and
     a teaching signal: the fleet steps at 8->128 and 128->8 and at the
     adapter's 128x128 with B = 4 (traces and rule on a grid there, so
     the 16,384-term float row is exact in any order), the rollout
     at K = 4 and 16, float32 and int8; each launch's state equals the same
     launch without telemetry bit for bit, its row equals the plain
     version's bit for bit (int8) or within 2e-4 (float32), vacant rows 0;
     phase 5 also times each variant beside its telemetry-off twin;
 10. session serving at full width: `FleetScheduler` on 8-128-8 with 4096
     slots and a `SessionStore` on disk, float32 and int8: 4096 sessions
     admitted from 8192 users, 8 windows under churn (2% of the residents
     leave before each, as many arrive; one rollout launch per window, the
     telemetry variant on every 4th), then 16 per-event telemetry steps;
     a probe moved through disk into another slot continues bit for bit
     as without the move, 256 vacant slots stay frozen over 4 windows,
     the static signatures and loaded libraries stay constant after
     warm-up, 2 windows are profiled, and the int8 run repeated through
     the plain versions gives the same final pool and persisted sessions.
 2f. the bfloat16 instantiations against their plain versions: the fleet
     step (with and without telemetry, the rule in bf16 or float32) at
     8->128, 128->8 and a ragged 17->257 with B = 4096 and the adapter's
     128x128 with B = 4, with and without
     a slot mask and teach; the fleet window at K = 1, 4, 32 with 90% of
     the slots active and its telemetry variant at K = 4, 16; the
     shared-weight window at 784-1024-10, K = 1 and 8; the shared step at
     784->1024 and 1024->10, B = 1, and `lif_forward` there at B = 1 and
     8.  Steps and one-step
     windows within 3e-2 (JAX's own bf16 tolerance), K = 4 windows with at
     most 1e-3 of the elements outside it, telemetry launches' state bit
     for bit their telemetry-off twins', vacant slots frozen; each prints
     its largest difference and the share beyond one bf16 step;
 4f. the controller path in bfloat16: `firefly_snn.CONFIG` with
     ``dtype=bfloat16``, B = 4096, 260 steps on `direction`, beside phase
     4's float32 rate and reward; one control window per event and fused,
     with and without telemetry, each against the plain versions; the
     recovery gate's two scenarios in bf16, printed and not gated;
 6f. the online path in bfloat16: `firefly_snn.MNIST` in bf16 on the 120
     digits beside phase 6's float32, one digit per event and fused
     against the plain versions, and the Table II forward-only baseline;
 7f. each bf16 kernel's time beside its float32 twin (timed in the same
     phase), its plain version, its bound at 2 bytes per bf16 element and,
     for `lif_forward`, a bf16 `torch.matmul` of the product; the bf16
     fleet steps per layer shape as in phase 5 and the bf16 shared step
     and `lif_forward` per layer shape as in phase 7.
 12. the paper's two-phase protocol on `position` (150-step episodes) at
     `AdaptationConfig`'s 11-128-2, T = 4, 24 pairs, 8 train goals, cut to
     2 generations: first #3 fleet at 11-128-2 against its plain version
     at B = 8, 72 and 384, every layer plastic or none (int8 bit for bit,
     float32 within 1e-5), and its time at B = 8 and 384; then
     `adaptation.optimize_rule`, plastic and weight-trained, through the
     entry points (exactly 2 x 48 x 150 and 2 x 150 rollout launches),
     each generation's mean fitness, seconds a generation and
     control-steps/s; 4 candidates of the first generation (two
     antithetic pairs) and one weight-trained candidate re-scored through
     the plain rollout from the same resets (per-step rewards within 1e-4
     over the first 20 control steps); `evaluate_generalization` of both
     on the 72 unseen goals, clean and with actuator 0 dead from step 50;
     arm-payload and position-noise with the reference rule, float32 and
     int8, plastic against frozen (printed, not gated); a profile of one
     candidate's loop (device busy time, idle share, device ops a control
     step, #3's device time a launch at 11-128-2, B = 8).
 2h. the recorder kernel (`obs.recorder.record_step`, csrc/recorder.cu:
     the network weight norm, the drift against wnorm0, one ring row and
     the four detectors in one launch, laid out by `recorder_plan`, which
     is printed) against its plain version at 8-128-8, B = 4096, float32,
     bfloat16 and int8, 90% of the slots active, 16 recorded steps of
     random telemetry rows with weights moving in half the slots, a
     planted stuck, dead, bursting and out-of-corridor slot: flags,
     streaks, steps and verdicts exact, int8 bit for bit, float ring,
     baselines and wnorm0 within rtol = atol = 1e-6, each planted fault
     flagged; then the LM adapter's one N x N layer at B = 8, N = 128 and
     512 (a slot on a cluster of CTAs), in the three dtypes, 8 steps, held
     the same way;
 13. session health at full width: a `FleetScheduler` on 8-128-8 with
     4096 slots, a RAM `SessionStore` and the incident drill's detectors,
     float32 and int8: 4096 sessions run 12 recorded windows (the first 4
     equal a record-off twin pool bit for bit, state and outputs),
     `health_checkpoint()`, dead input into 64 sessions spread over the
     pool until each is flagged (within 10 windows, no clean session
     flagged), `remediate(flight_dir=...)` under the armed recompile
     watchdog (0 violations; the `compiled_programs()` dict printed), 6
     more windows equal to a control pool in which the 64 were evicted
     and re-admitted by hand at the checkpoint, bit for bit, and exactly
     one recorder launch per recorded window (the count read just after
     the drills); then, in a fresh process (``--only health``), the
     recorder's time (L2 flushed by writing and by reading) beside its
     plain version and its bound by bytes at 8-128-8 in float32, bfloat16
     and int8 and at the adapter's N = 128 and 512 (B = 8), an empty
     kernel's time (a launch's floor), a `torch.profiler` window of 8
     telemetry-on windows beside
     8 recorded ones on a full pool (the recorded side runs one more
     device op a window and the same device-to-host copies), and the wall
     of 8 recorded windows with the kernel and with its plain version, in
     alternating turns.
 14. the LM decode pool (`serving.LMScheduler`): first #3 fleet at the
     adapter's one 128 -> 128 layer, B = 8 slots, one vacant, through
     `plastic.decode_rollout` against the plain window at K = 1 and 4
     (int8 bit for bit across the step counter's int32 wrap, float32
     within 1e-5 and 1e-4), its plan and its time beside its bound, and
     #1/#2 at the same shape against the plain step; then full-width
     qwen3-4b with the adapter at N = 128, 8 slots of 1024 positions,
     float32 then int8: the probe alone for 32 steps (pool Q), moved at
     that boundary through a RAM store into pool W, which runs 6 windows
     of K = 4 (the first against 4 steps of Q: the same greedy tokens, the
     session bit for bit in int8, the float32 adapter within 1e-4); pool
     C serves the probe beside 6 residents (slot 7 vacant), 2 of them
     replaced every 4 steps by the next of 19 users (prompts of 64, 256
     and 512 tokens; a returning user is restored), telemetry and record
     variants among its 32 steps and 6 windows, the probe moved through
     disk into another slot before window 3: the probe's tokens equal Q's,
     its windows and session W's (bit for bit in int8; in float32 the
     first differing leaf is reported and the logits held within 2e-2 of
     the largest), the vacant row frozen, the launches exact (36 attention
     per fresh admission, one fleet step a step, one rollout a window, one
     recorder a recorded call, silu per forward), `compiled_programs()`
     pinned, the pool's recorder against its plain version; admission,
     step and window latencies; mamba2-1.3b and zamba2-7b at `shallow`
     depth in a 4-slot pool (vacant frozen, window against steps, SSD
     scans per admission); the CPU test's compile-audit sequence on a
     smoke pool (its pinned dict); and in a fresh process (``--only
     lm-pool-profile``) a `torch.profiler` of 2 pool steps.
 15. the MoE layout on deepseek-moe-16b at full width (a dense layer, then
     27 layers of attention and 64 routed experts, top-6, beside 2 shared
     ones; 16.38 B parameters): #7 at its prefill shape (B = 4, S = 2048,
     16 query over 16 KV heads of 128) against its plain version in bf16
     and float32, timed beside SDPA and its bound; 4 x 2048 + 32 tokens
     served at full depth with the adapter in float32 then int8 (28
     attention launches a prefill, one fleet step a step, silu twice a MoE
     layer a forward, every #7 launch of the first prefill held on its
     inputs, the bf16 comparison with the plain path as statistics: the
     logit gap, greedy agreement and the share of (token, k) expert
     assignments that agree); 2 layers (the dense one and a MoE one) in
     float32 against the plain path within 1e-4 of the largest logit, the
     same tokens and the same expert choices; an 8-slot `LMScheduler`
     (int8 adapter, one slot vacant): at the default capacity the vacant
     slot's pending token moves no active stream's logits or session, at
     ``capacity_factor = 64`` a probe under churn equals the probe alone
     bit for bit; the serve CLI at its defaults with each launch held;
     and in a fresh process (``--only moe-profile``) a `torch.profiler` of
     a prefill and 2 decode steps with the routing, dispatch, experts and
     combine each in a range.
 16. the int8 KV cache (``kv_quant``: int8 codes and a float32 scale per
     position and KV head) on qwen1.5-32b at full width (64 layers, 40
     query over 40 KV heads of 128, QKV bias; 35.2 B parameters, ~66 GiB
     in bf16): #7 at its prefill shape (B = 4, S = 2048) against its plain
     version in bf16 and float32, timed beside SDPA and its bound; (a)
     4 x 2048 + 32 at full depth with the int8 cache and int8 adapter
     (every #7 launch of the warm-up's prefill held on its inputs as it
     happens, exact launches, peak memory beside the cache's bytes by the
     plan); (b) one prompt of 2048 + 16 with the int8 and the bf16 cache
     (decode p50, peak memory), the per-layer device time of the decode
     attention's float32 copy of the cache and of the dequantisation, and
     whether (a) would fit with the bf16 cache, computed and then run; (d) an
     8-slot `LMScheduler` of 1024 positions with the int8 cache and int8
     adapter, one slot vacant: the probe under churn equals the probe
     alone, a window of 4 its steps, a session back from disk the one
     that left and the probe's window under churn the window alone, bit
     for bit, the vacant slot's codes and scales frozen, launches exact;
     then in a fresh process (``--only kv-quant-profile``) a
     `torch.profiler` of 2 decode steps with each cache, the quantisation,
     dequantisation and decode attention each in a range; (c) 2 layers in
     float32 against the plain path (1e-4 of the largest logit, the same
     tokens, at most 1e-3 of the int8 codes off by one); (e)
     internlm2-20b with the int8 cache, pixtral-12b and musicgen-medium
     through the embeddings prompt, each 4 x 2048 + 8 at full width with
     every #7 launch of the warm-up's prefill held on its inputs and
     exact launches, and qwen2-72b (~135 GiB in bf16) at smoke scale
     beside its full-width plan's bytes.

 17. LM training on the dense layout: (a) #7's backward kernels
     (csrc/flash_attention_bwd.cu: in bf16 the Hopper kernels, wgmma with
     P and dS split hi + lo, TMA through an mbarrier ring) against
     `flash_attention_bwd_plain` on the forward kernel's o and lse (each
     held against `mha_lse` first) at qwen3-4b's training shape (B = 1, S = 4096, 32 query over 8 KV heads
     of 128) in bf16 and at every head width at S = 512 in float32 and
     bf16 (float32 within 1e-5 of each gradient's largest |x|, bf16
     within rtol 2e-2 / atol 2e-3, a second launch the same bits), timed
     per layer beside its plain version, its bound by operations and
     SDPA's backward, with each kernel's registers and local (spill)
     bytes from ``cudaFuncGetAttributes`` and ptxas's spills; (b) silu's
     backward (csrc/silu.cu's ``silu_bwd``) bit for bit at the training
     MLP of every dense arch, timed beside its bound by bytes, and AdamW's
     update (csrc/adamw.cu) bit for bit at qwen3-4b's leaves, timed at
     the largest beside its plain version and its bound by bytes; (c) 3
     steps of full-width qwen3-4b (4.41 B parameters) at 2 x 4096 tokens
     through `launch.train.build`: 2 microbatches into a float32
     accumulator, float32 AdamW moments, warmup-cosine, remat per block;
     each step's launches exact (144 #7 forwards, 72 backwards, 144 silu,
     72 silu backwards, one AdamW launch a parameter leaf), finite losses, the first near ln(151936); step seconds,
     tokens/s, model FLOP/s and its share of 989 TFLOP/s, peak memory;
     (d) 2 layers at full width in float32 against the plain path (loss
     within 1e-5 relative, every gradient leaf within 1e-4 of its largest
     |g|); (e) the train CLI on the card and again, resuming at step 6;
     then in a fresh process (``--only train-profile``) a `torch.profiler`
     of one step, the device time grouped by kernel name (#7's forward
     and backward, silu's, AdamW's, the GEMMs, the elementwise kernels,
     the reductions) and the optimizer's update in a range.

 18. ssm and hybrid training: (a) #8's backward (csrc/ssd_bwd.cu; bf16:
     four Hopper kernels, the carries with each chunk's contribution
     folded in (wgmma, the states split hi + lo), each chunk's gradients
     with a slab of a group's heads a CTA (every product a wgmma), d(lg)
     into ddt, the slabs summed; float32: the four CUDA-core kernels)
     against `ssd_scan_bwd_plain` at mamba2-1.3b's and zamba2-7b's
     training shapes (one microbatch of 4096 tokens; H = 64, S = 128 and
     H = 112, S = 64), G = 2 at L = 300 and L = 1000, with and without a
     final-state gradient, on x, B and C cut from a packed projection, in
     bf16 and float32 (bf16 dx, dB, dC within one bf16 step of the
     largest |g|, every float32 gradient within 1e-4; a second launch the
     same bits), timed per layer beside its plain version and
     its bound, each kernel by `torch.profiler`, registers and spills;
     (b) silu's backward in the Mamba2 block's two forms (the conv's
     ``silu(x)``, the gate's ``y * silu(z)``) bit for bit at both archs'
     widths, timed; (c) 3 steps each of full-width mamba2-1.3b (2 x 4096,
     2 microbatches) and zamba2-7b cut to 3 of its 9 super-blocks (4 x
     4096, 4 microbatches) through `launch.train.build`, each step's
     launches exact, finite losses, the first near ln(vocab); step
     seconds, tokens/s, model FLOP/s and its share of 989 TFLOP/s, peak
     memory; (d) each at full width and shallow depth in float32 against
     the plain path; then in a fresh process (``--only
     ssm-train-profile``) a `torch.profiler` of one mamba2-1.3b step by
     kernel name.

 19. MoE training: (a) #7's forward with lse and its backward at
     deepseek-moe-16b's training shape (B = 1, S = 4096, 16 query over 16
     KV heads of 128: a GQA group of 1) against their plain versions in
     bf16 (o within phase 15's tolerance, lse within 1e-4; a second
     backward launch the same bits), the backward timed beside its bound
     by operations and SDPA's backward; silu and
     its backward bit for bit at the step's three SwiGLU shapes (the
     routed experts' (64, 480, 1408) buffer, the shared experts' 4096 x
     2816, the dense first layer's 4096 x 10944); AdamW bit for bit at one
     stacked expert leaf (7 x 64 x 2048 x 1408), timed beside its bound
     by bytes; (b) one full-width MoE layer on 1 x 4096 tokens: in float32
     the gradients through the dispatch's and combine's Functions within
     1e-5 of autograd of their indexing forms, in bf16 its backward twice
     the same bits (no atomics); (c) 3 steps of deepseek-moe-16b at full
     width cut to its dense first layer and 7 of its 27 MoE layers (4.62
     B parameters) at 2 x 4096 tokens through `launch.train.build` (2
     microbatches, float32 accumulator and moments, remat per block):
     each step's launches exact (32 #7 forwards, 16 backwards, 60 silu,
     30 silu backwards, one AdamW launch a leaf), finite losses, the first
     near ln(102400); step seconds, tokens/s, model FLOP/s and its share
     of 989 TFLOP/s, peak memory; a 4th step, then the state made anew
     from the seed and steps 0-3 taken on it: the same loss and
     parameters bit for bit;
     (d) the dense layer and one MoE layer in float32 against the plain
     path, both routing alike first; then in a fresh process (``--only
     moe-train-profile``) a `torch.profiler` of one step by kernel name,
     with the routing, dispatch, experts and combine in ranges in the
     forward and the backward.

 20. sharded session pools: `firefly_snn.CONFIG` (8-128-8, T = 4) in a
     4096-slot `FleetScheduler` with a RAM `SessionStore`, float32 and
     int8, split over D = 4 shards (`distributed.fleet_mesh(devices=...)`,
     the visible cards in turn: all four on one card) beside an unmeshed
     control pool running the same sequence, and at D = every visible
     card: (a) 3072 sessions in slots 0-3071, 4 windows of K = 4 under 2%
     churn a window, then 4 per-event steps, outputs and state bit for
     bit the control's, D rollout launches a window on 1024 slots each,
     shard 1's window repeated through the plain window (int8 bit for
     bit, float32 within 1e-5); (b) `persist_resident`, `fail_device(1)`
     with poison, one window with its 1024 sessions stranded (survivors
     the control's bit for bit, the control pausing those sessions:
     evicted before the window, re-admitted after it; stranded outputs
     exactly 0), `drain_failed` into shard 3 (its seconds printed), 4
     windows bit for bit with every `steps_lost` 0 and no new signature;
     (c) `save_pool` at D = 4, `load_pool` at D = 2 and unmeshed, 2
     windows bit for bit; (d) 4 recorded windows at D = 4 against an
     unmeshed recording pool (ring, baselines and verdicts bit for bit,
     one recorder launch a shard a window), one quarantine planted and
     rolled back; (e) the LM decode pool on qwen3-4b at full width and
     `shallow` depth, D = 2 against unmeshed: the same tokens; (f) the
     sharded window's device time beside the unmeshed one (CUDA events
     behind a sleep kernel, L2 flushed; printed, not gated).  #1, #2, #3
     fleet and the recorder count their launches in the sharded pools'
     calls.

Phases 8 to 20 and their ``--only`` parts arm `faulthandler` with a limit
of a few minutes: a stall prints every thread's stack and exits with code
1 long before the script's limit.

``python3 chip_smoke.py --profiles`` adds the `torch.profiler` traces of
where each path's time goes: phases 4b and 6b, phase 7's per-event
profile, the prefill and decode steps of phases 8, 9 and 11, and the fresh
processes of phases 14 to 19 (``--only *-profile``).  Without it those
calls print their wall time only; the traces that gate a path or time a
kernel alone (phases 5, 7 and 13) run in either case.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, when there is no CUDA device or the package is not beside it.
Each phase prints its seconds.

``python3 chip_smoke.py --only <part>[,<part>...]`` builds the kernels,
runs only the named A/B parts and writes them to
``chiprun_out/chip_smoke_only.json`` or the file after ``--out`` (no
result line), any tree's wrappers
alike (unpack another tree under ``build/`` with this script beside it):
``fleet-steps`` (phases 5 and 7f's per-shape table and phase 4b's
per-event device ops), ``shared-steps`` and ``lif-forward`` (phase 7's
per-shape tables and the online learner's per-event device time),
``attention`` (phase 7b's per-width times and the ptxas registers and
spills of ``flash_attention.cu``), ``lm-prefill`` (one profiled
prefill of each full-width LM), ``rule-search`` (phase 12) and
``health`` (phase 13's timings: the recorder's time, the profiled
windows and the recorded windows' walls with the kernel and its plain
version), ``lm-pool`` (phase 14) and ``lm-pool-profile`` (its fresh
process's profile of 2 pool steps), ``moe`` (phase 15) and
``moe-profile`` (its fresh process's profile), ``kv-quant`` (phase 16)
and ``kv-quant-profile`` (its fresh process's profile), ``train`` (phase
17) and ``train-profile`` (its fresh process's profile of one step),
``ssm-train`` (phase 18) and ``ssm-train-profile``, ``moe-train`` (phase
19) and ``moe-train-profile``, ``sharded-pool`` (phase 20).
"""
from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import json
import math
import os
import re
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
# Whether `profile_window` takes `torch.profiler` traces and the LM phases
# start their fresh profile processes (`Fresh`): with ``--profiles`` and in
# every ``--only`` part; `main` sets it.  Without it those calls time the
# wall only: the traces' start and stop and the profile processes cost
# minutes of host time.  `profiled_ms` and `profile_ops` always trace.
PROFILES = False

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
           "rollout_telemetry": CSRC + "rollout.cu",
           "fleet_step_bf16": CSRC + "fleet_step.cu",
           "fleet_step_bf16_telemetry": CSRC + "fleet_step.cu",
           "rollout_bf16": CSRC + "rollout.cu",
           "rollout_bf16_telemetry": CSRC + "rollout.cu",
           "rollout_shared_bf16": CSRC + "rollout_shared.cu",
           "shared_step_bf16": CSRC + "shared_step.cu",
           "lif_forward_bf16": CSRC + "lif_forward.cu",
           "silu": CSRC + "silu.cu",
           "recorder": CSRC + "recorder.cu",
           "flash_attention_bwd": CSRC + "flash_attention_bwd.cu",
           "silu_bwd": CSRC + "silu.cu",
           "adamw": CSRC + "adamw.cu",
           "ssd_scan_bwd": CSRC + "ssd_bwd.cu",
           "silu_bwd_mamba2": CSRC + "silu.cu"}
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
            "rollout_telemetry": "src/repro/kernels/plasticity/fused.py:230",
            "fleet_step_bf16": "src/repro/kernels/plasticity/kernel.py:256",
            "fleet_step_bf16_telemetry":
                "src/repro/kernels/plasticity/kernel.py:239",
            "rollout_bf16": "src/repro/kernels/plasticity/fused.py:304",
            "rollout_bf16_telemetry":
                "src/repro/kernels/plasticity/fused.py:230",
            "rollout_shared_bf16": "src/repro/kernels/plasticity/fused.py:304",
            "shared_step_bf16": "src/repro/kernels/plasticity/kernel.py:132",
            "lif_forward_bf16": "src/repro/kernels/lif/kernel.py:47",
            # no Pallas kernel: the XLA fusion of jax.nn.silu (SwiGLU gate)
            "silu": "src/repro/models/layers.py:142",
            # no Pallas kernel: the record variant's recorder and detectors,
            # which XLA fuses into the jitted pool step
            "recorder": "src/repro/serving/scheduler.py:870",
            # the gradient of #7's port (JAX differentiates its XLA
            # attention in training: src/repro/launch/steps.py:31)
            "flash_attention_bwd": "src/repro/kernels/attention/kernel.py:79",
            # no Pallas kernel: XLA's fusion of jax.vjp of the SwiGLU gate
            "silu_bwd": "src/repro/models/layers.py:142",
            # no Pallas kernel: XLA's fusion of the AdamW update
            "adamw": "src/repro/optim/optimizers.py:67",
            # the gradient of #8's port (JAX differentiates its XLA chunked
            # scan in training: src/repro/kernels/ssd/ref.py:50)
            "ssd_scan_bwd": "src/repro/kernels/ssd/kernel.py:65",
            # no Pallas kernel: XLA's fusions of jax.vjp of the Mamba2
            # conv's silu (:75) and its output gate y * silu(z) (:111)
            "silu_bwd_mamba2": "src/repro/models/ssm.py:75"}


def log(*a):
    print(*a, flush=True)


class Check(Exception):
    pass


def require(cond, what):
    if not cond:
        raise Check(what)


class Fresh:
    """``chip_smoke.py --only <part> --wait`` in a fresh process, started
    at once: it imports torch and loads the kernels' libraries while this
    process works on, then waits on its standard input and touches the
    card only after `result` sends ``go`` (at end of input it exits).
    The profiles run in such a process because late in this one the
    profiler has lost launches.  A ``*-profile`` part starts only with
    `PROFILES`; without it `result` returns ``{}``."""

    def __init__(self, part, work):
        self.part, self.proc = part, None
        if part.endswith("-profile") and not PROFILES:
            return
        self.report = work / f"only_{part.replace('-', '_')}.json"
        self.report.unlink(missing_ok=True)
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--only", part,
             "--out", str(self.report), "--wait"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self, keep, timeout=300):
        """Run the part; log each line of its output after the part's
        title for which ``keep(line)`` holds, and return its report."""
        p = self.proc
        if p is None:
            log(f"  --only {self.part}: not run (--profiles runs it)")
            return {}
        try:
            out, err = p.communicate("go\n", timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise
        lines = out.splitlines()
        start = next((i for i, line in enumerate(lines)
                      if line.startswith(f"--only {self.part}")), len(lines))
        for line in lines[start + 1:]:
            if keep(line):
                log(line)
        require(p.returncode == 0 and self.report.exists(),
                f"--only {self.part} exited {p.returncode}: {err[-2000:]}")
        return json.loads(self.report.read_text())[self.part]


# ---- timing and bounds -------------------------------------------------------

_flush_buf = []


def flush_l2(how="write"):
    """Evict the L2 cache through a 1 GB buffer: "write" zeroes it (and
    leaves up to 50 MB of dirty lines to write back), "read" sums its
    8-byte words (clean lines only)."""
    import torch
    if not _flush_buf:
        _flush_buf.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                      device="cuda"))
    if how == "read":
        _flush_buf[0].view(torch.int64).sum()
    else:
        _flush_buf[0].zero_()


def device_ms(fn, reps=20, warmup=3, flush="write"):
    """Median device time of one call: CUDA events around each call, with
    the L2 cache flushed before it (`flush_l2`, by default zeroing a 1 GB
    buffer).  Nothing synchronises inside the loop, and the flush (~0.3 ms
    of device work) keeps the card behind the host, so the events time the
    call's kernels and not the host's dispatch."""
    import torch
    flush_l2(flush)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush_l2(flush)
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


def step_bytes(b, n, m, wb, sb=4, fleet=True, tb=4):
    """One step launch: every input read once, every output written once
    (x, w, theta, v, traces in; events, v, trace, w out); a fleet has one
    weight set per stream, a shared-weight step one.  ``wb``, ``sb`` and
    ``tb``: bytes of a weight, a state element and a rule coefficient."""
    syn = (b if fleet else 1) * n * m
    return (b * n * sb + 2 * syn * wb + 4 * tb * n * m + 2 * b * m * sb
            + b * n * sb + 3 * b * m * sb)


def window_bytes(b, sizes, k, wb, sb=4, fleet=True, tb=4):
    """One rollout launch: drives and outputs once per step, the weights,
    theta, membranes and traces once per window each way (theta in)."""
    syn = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    return (k * b * sizes[0] * sb + k * b * sizes[-1] * sb
            + 2 * (b if fleet else 1) * syn * wb + 4 * tb * syn
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
    cases = [(B, 8, 128, True, None), (B, 128, 8, False, None),
             (B, 40, 77, True, "mask"), (4, 128, 128, True, "mask")]
    for b, n, m, spiking, mask in cases:
        active = None
        if mask:
            active = (torch.rand(b, generator=gen, device=dev) < 0.7)
        for quant in (False, True):
            x, w, theta, v, tpre, tpost = rand_fleet_inputs(
                gen, b, n, m, quant, dev)
            if quant:
                scale = torch.where(torch.arange(b, device=dev) % 2 == 0,
                                    1 / 32, 1 / 16).float()
                seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (b,),
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
                 f"B={b} N={n} M={m} spiking={spiking} "
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
    """#6 against its plain version at the online learner's layers (B = 1
    and 8) and ragged shapes: an 8-CTA cluster cutting 1000 rows unevenly,
    rows of 1001 weights (a ragged 16-byte edge).  The weights lie on a
    grid of 1/64 and the events are 0 or 1, so every fold order gives the
    same psum: the kernel equals the plain version bit for bit, and a
    second launch gives the same bits."""
    import torch
    from repro_torch.kernels.lif import kernel as L
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    for b, k, m in ((1, 784, 1024), (8, 784, 1024), (1, 1024, 10),
                    (8, 1024, 10), (8, 130, 250), (1, 1000, 10),
                    (1, 784, 1001)):
        x = (torch.rand(b, k, generator=gen, device=dev) < 0.5).float()
        w = torch.round(torch.randn(k, m, generator=gen, device=dev)
                        * 8) / 64
        v = 0.1 * torch.randn(b, m, generator=gen, device=dev)
        tr = torch.rand(b, m, generator=gen, device=dev)
        got = L.lif_forward(x, w, v, tr)
        what = f"B={b} K={k} M={m}"
        held("lif_forward", got, L.lif_forward_plain(x, w, v, tr), True,
             results, what + " (weights on a 1/64 grid: bit for bit)")
        again = L.lif_forward(x, w, v, tr)
        torch.cuda.synchronize()
        require(all(torch.equal(g, a) for g, a in zip(got, again)),
                f"lif_forward {what}: a second launch gave other bits")


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


def profile_window(fn, steps, groups=None):
    """Device busy time, idle share and device time by kernel over one call
    of ``fn`` (torch.profiler, CUPTI), against its wall time; the wall time
    alone without `PROFILES`.  Ranges
    annotated with `record_function` (the serving phases) are not kernels:
    their host time is reported apart.  ``groups`` ({name: regex}) adds the
    device time of the kernels whose names each regex finds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    if not PROFILES:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        log(f"    {steps} steps in {wall_ms:.1f} ms wall (device time not "
            f"measured: --profiles measures it)")
        return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": None,
                "idle_share": None, "kernel_launches_per_step": None,
                "top": []}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    annotated = lambda e: getattr(e, "is_user_annotation", False)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not annotated(e)]
    ranges = {e.key: {"host_ms": e.cpu_time_total / 1e3, "count": e.count,
                      "device_ms": e.device_time_total / 1e3}
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
        out["annotated_ranges"] = ranges
    if groups:
        out["groups"] = {
            g: dict(ms=sum(e.self_device_time_total for e in kernels
                           if re.search(rx, e.key)) / 1e3,
                    count=sum(e.count for e in kernels
                              if re.search(rx, e.key)))
            for g, rx in groups.items()}
    log(f"    {steps} steps in {wall_ms:.1f} ms wall, device busy "
        f"{busy_ms:.2f} ms ({launches / steps:.0f} kernel launches per "
        f"step)" if busy_ms else
        "    profiler saw no device time (not measured)")
    for t in out["top"]:
        log(f"      {t['ms']:8.3f} ms  x{t['count']:<5d} {t['name']}")
    for name, r in sorted(ranges.items()):
        log(f"      host {r['host_ms']:8.3f} ms  x{r['count']:<5d} {name} "
            f"(its kernels {r['device_ms']:.3f} ms on the device)")
    for name, r in (groups and out["groups"] or {}).items():
        log(f"      {r['ms']:8.3f} ms  x{r['count']:<5d} {name} (by name)")
    return out


def profile_per_event(dev, windows=5):
    """Where the time goes over `windows` control windows of the per-event
    path (`snn.timestep`: one fleet-step launch per layer per timestep) of
    the 8-128-8 controller at B = 4096, float32 and int8, plain and with
    telemetry under a bool slot mask (3/4 active, the serving pool's
    per-step call); device ops per timestep."""
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    gen = torch.Generator(dev).manual_seed(SEED + 16)
    out = {}
    for quant in (False, True):
        cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
               else firefly_snn.CONFIG)
        theta = snn.init_theta(cfg, gen, scale=0.01)
        drive = torch.rand(B, cfg.layer_sizes[0], generator=gen,
                           device=dev) * 2 - 1
        active = torch.rand(B, generator=gen, device=dev) < 0.75
        steps = windows * cfg.timesteps
        for tel in (False, True):
            net = [snn.init_state(cfg, batch=B, fleet=True, device=dev)]
            kw = dict(telemetry=True, active=active) if tel else {}

            def run():
                for _ in range(steps):
                    net[0] = snn.timestep(cfg, net[0], theta, drive,
                                          **kw)[0]
            run()
            key = ("int8" if quant else "float32") + (" telemetry" if tel
                                                      else "")
            log(f"  per-event {key}:")
            out[key] = profile_window(run, steps)
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


FLEET_MODES = ("float32", "int8", "bfloat16")


def fleet_sweep_inputs(gen, mode, k, dev):
    """`net_inputs` of the controller in one of FLEET_MODES (the rule in
    bf16 for bfloat16) and the `fused.rollout` keywords of its window."""
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    cfg = (snn.quant_config(firefly_snn.CONFIG) if mode == "int8"
           else bf16_controller_cfg() if mode == "bfloat16"
           else firefly_snn.CONFIG)
    st, theta, drives = (bf16_net_inputs if mode == "bfloat16"
                         else net_inputs)(gen, cfg, k, dev)
    kw = dict(spiking=[cfg.engine_params(i).spiking
                       for i in range(cfg.num_layers)],
              plastic=[True] * cfg.num_layers, tau_m=cfg.lif.tau_m,
              trace_decay=cfg.trace_decay, w_clip=cfg.w_clip, qcfg=cfg.quant,
              block_b=cfg.block_b)
    if cfg.quant is not None:
        kw.update(scales=list(st.w_scale), seed=st.t.expand(B).contiguous())
    return cfg, (drives, st.w, theta, st.v, st.trace), kw


def sweep_fleet_window(dev):
    """#3 fleet at 8-128-8, B = 4096, K in SWEEP_K, in float32, int8 and
    bfloat16 (the rule in bf16), L2 flushed: ``ms = fixed + K * per_step``
    fitted by least squares beside the bound's own split; the launch
    (threads, shared memory, CTAs an SM holds by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, CTAs launched) of every
    instantiation, and the registers, spills and stack ptxas gave each."""
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.kernels import _build
    from repro_torch.kernels.plasticity import fused
    gen = torch.Generator(dev).manual_seed(SEED + 14)
    sizes = firefly_snn.CONFIG.layer_sizes
    syn = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    out = {}
    for mode in FLEET_MODES:
        quant, eb = mode == "int8", 2 if mode == "bfloat16" else 4
        ms, bms = [], []
        for k in SWEEP_K:
            cfg, args, kw = fleet_sweep_inputs(gen, mode, k, dev)
            ms.append(device_ms(lambda: fused.rollout(*args, **kw)))
            bms.append(bound(window_bytes(B, sizes, k, 1 if quant else eb,
                                          sb=eb, tb=eb),
                             k * B * syn * (OPS_Q if quant else OPS_F32))[0])
        fixed, per_step = fit_line(SWEEP_K, ms)
        b_fixed, b_step = fit_line(SWEEP_K, bms)
        out[mode] = dict(k=list(SWEEP_K), ms=ms, fixed_ms=fixed,
                         per_step_ms=per_step, bound_ms=bms,
                         bound_fixed_ms=b_fixed, bound_per_step_ms=b_step)
        log(f"  rollout {mode:8s} K sweep "
            + ", ".join(f"K={k} {t:.4f}" for k, t in zip(SWEEP_K, ms))
            + f" ms: fixed {fixed:.4f} ms + {per_step:.4f} ms/step (bound "
            f"{b_fixed:.4f} + {b_step:.5f} ms/step)")
    out["launch"] = {}
    bb = firefly_snn.CONFIG.block_b
    for mode, th_bf16 in (("float32", False), ("int8", False),
                          ("bfloat16", True), ("bfloat16, rule float32",
                                               False)):
        for tel in (False, True):
            name = mode + (" telemetry" if tel else "")
            info = fused.fleet_launch(
                dev, sizes, B, bb, [True, True], quant=mode == "int8",
                telemetry=tel, bf16=mode.startswith("bfloat16"),
                theta_bf16=th_bf16)
            out["launch"][name] = info
            log(f"  rollout {name}: " + ", ".join(
                f"{k} {v}" for k, v in info.items()))
    usage = ptxas_usage(_build.build_all()["log"].get("rollout.cu", ""))
    out["ptxas"] = {name: dict(registers=r, spill_store_bytes=st,
                               spill_load_bytes=ld, stack_bytes=sk)
                    for name, (r, st, ld, sk) in usage.items()}
    for name, (r, st, ld, sk) in usage.items():
        log(f"  ptxas {name}: {r} registers, spills {st} B stored / {ld} B "
            f"loaded, stack {sk} B")
    return out


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


def profile_online_per_event(dev, steps=20):
    """Where the time goes over `steps` per-event timesteps of the online
    learner (`snn.timestep` at B = 1: one shared-step launch a layer), float32
    and int8, from a fresh network and rule (seeded) on one digit's spikes;
    any tree's wrappers alike."""
    import torch
    from repro_torch.core import snn
    gen = torch.Generator(dev).manual_seed(SEED + 18)
    out = {}
    for mode in ("float32", "int8"):
        cfg = mnist_cfg(mode == "int8")
        theta = snn.init_theta(cfg, gen, scale=0.02)
        net = [snn.init_state(cfg, batch=1, device=dev)]
        xb = (torch.rand(1, cfg.layer_sizes[0], generator=gen, device=dev)
              < 0.3).float()

        def run():
            for _ in range(steps):
                net[0] = snn.timestep(cfg, net[0], theta, xb)[0]
        run()
        log(f"  per-event {mode}:")
        out[mode] = profile_window(run, steps)
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
    between repetitions; the plain version beside it; #6 per layer shape
    (`time_lif_shapes`)."""
    import torch
    from repro_torch.core import engine, snn
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
    results["rollout_shared"]["sweep"] = sweep_shared_window(dev)
    lif_row(results, time_lif_shapes(dev, ("float32",), results), "float32")


SWEEP_K = (1, 2, 4, 8, 16)


def fit_line(xs, ys):
    """Least-squares ``(intercept, slope)`` of ys against xs."""
    mx, my = statistics.mean(xs), statistics.mean(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return my - slope * mx, slope


def sweep_shared_window(dev):
    """#3 shared at 784-1024-10, B = 1, K in SWEEP_K, in float32, int8 and
    bfloat16 (the rule in bf16), L2 flushed: ``ms = fixed + K * per_step``
    fitted by least squares, beside the bound's own split."""
    import torch
    from repro_torch.core import snn
    from repro_torch.kernels.plasticity import fused
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    sizes = mnist_cfg(False).layer_sizes
    layers = [(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)]
    syn = sum(n * m for n, m in layers)
    out = {}
    for mode in ("float32", "int8", "bfloat16"):
        quant, bf16 = mode == "int8", mode == "bfloat16"
        cfg = mnist_cfg(quant)
        if bf16:
            cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        st = snn.init_state(cfg, batch=1, device=dev)
        if quant:
            w = tuple(torch.randint(-40, 41, (n, m), generator=gen,
                                    device=dev, dtype=torch.int32)
                      .to(torch.int8) for n, m in layers)
        else:
            w = tuple((torch.round((torch.rand(n, m, generator=gen,
                                               device=dev) * 2 - 1) * 16)
                       / 64).to(cfg.dtype) for n, m in layers)
        st = dataclasses.replace(st, w=w)
        theta = snn.init_theta(cfg, gen, scale=0.02)
        kw = dict(spiking=[True, True], plastic=[True, True],
                  tau_m=cfg.lif.tau_m, trace_decay=cfg.trace_decay,
                  w_clip=cfg.w_clip, qcfg=cfg.quant)
        if quant:
            kw.update(scales=list(st.w_scale), seed=st.t)
        ms, bms = [], []
        for k in SWEEP_K:
            drives = (torch.rand(k, 1, sizes[0], generator=gen, device=dev)
                      < 0.3)
            drives = (drives.int() * cfg.quant.one if quant
                      else drives.to(cfg.dtype))
            ms.append(device_ms(lambda: fused.rollout_shared(
                drives, st.w, theta, st.v, st.trace, **kw)))
            eb = 2 if bf16 else 4
            bms.append(bound(window_bytes(1, sizes, k,
                                          1 if quant else eb, sb=eb,
                                          fleet=False, tb=eb),
                             k * syn * (OPS_ROW + (OPS_UPD_Q if quant
                                                   else OPS_UPD_F32)))[0])
        fixed, per_step = fit_line(SWEEP_K, ms)
        b_fixed, b_step = fit_line(SWEEP_K, bms)
        out[mode] = dict(k=list(SWEEP_K), ms=ms, fixed_ms=fixed,
                         per_step_ms=per_step, bound_ms=bms,
                         bound_fixed_ms=b_fixed, bound_per_step_ms=b_step)
        log(f"  rollout_shared {mode:8s} K sweep "
            + ", ".join(f"K={k} {t:.4f}" for k, t in zip(SWEEP_K, ms))
            + f" ms: fixed {fixed:.4f} ms + {per_step:.4f} ms/step (bound "
            f"{b_fixed:.4f} + {b_step:.5f} ms/step)")
    from repro_torch.kernels import _build
    usage = ptxas_usage(_build.build_all()["log"].get("rollout_shared.cu",
                                                        ""))
    out["ptxas"] = {name: dict(registers=r, spill_store_bytes=st,
                               spill_load_bytes=ld)
                    for name, (r, st, ld, _) in usage.items()}
    for name, (r, st, ld, _) in usage.items():
        log(f"  ptxas {name}: {r} registers, spills {st} B stored / {ld} B "
            f"loaded")
    return out


# ---- phase 2c: flash attention against its plain version -------------------

BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32      # the serving run (phase 8)
LM_WARM = 2                     # decode steps of each untimed warm-up run
LM_COMPARE_GEN = 8              # steps of the full-depth bf16 comparison
PROFILED_STEPS = 2              # decode or pool steps of each LM profile
ATTN_SHAPE = (LM_BATCH, 2048, 32, 8, 128)      # B, S, H, HKV, D at qwen3-4b
ZAMBA_ATTN = (LM_BATCH, 2048, 32, 32, 112)     # the same at zamba2-7b
# the narrow head widths of the smoke configs, each at GQA: D -> (H, HKV)
NARROW_HEADS = {16: (8, 2), 24: (10, 5), 32: (32, 8)}
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-3)}


def attention_inputs(gen, b, sq, skv, h, hkv, d, dtype, dev, v_scale=1.0):
    import torch
    q = torch.randn(b, sq, h, d, generator=gen, device=dev)
    k = torch.randn(b, skv, hkv, d, generator=gen, device=dev)
    v = v_scale * torch.randn(b, skv, hkv, d, generator=gen, device=dev)
    return tuple(t.to(dtype) for t in (q, k, v))


def compare_attention(dev, results):
    """#7 against `ref.mha` on the same inputs: the prefill shape of
    qwen3-4b (B = 4, S = 2048, H = 32, HKV = 8, D = 128), a ragged
    S = 1000, a decode-shaped query against 2049 keys, a kv_len mask, the
    serve CLI's 32-token prompts (one partial query tile), head width 64,
    Sq > Skv (rows with no visible key, exactly 0) and V at 8x scale (where
    a single bf16 P would leave the tolerance); then the other head widths
    of the repo's configs: zamba2-7b's D = 112 at its prefill shape (32
    query over 32 KV heads), decode-shaped and with a kv_len, and the smoke
    configs' D = 16, 24 and 32 at GQA over S = 1000, decode-shaped and with
    a ragged kv_len; bfloat16 and float32."""
    import torch
    from repro_torch.kernels.attention import kernel as TA
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    b, s, h, hkv, d = ATTN_SHAPE
    zh, zkv, zd = ZAMBA_ATTN[2:]
    # (what, B, Sq, Skv, kv_len, D, V scale, H, HKV), all causal
    cases = [("prefill", b, s, s, None, d, 1.0, h, hkv),
             ("ragged", b, 1000, 1000, None, d, 1.0, h, hkv),
             ("decode", b, 1, s + 1, None, d, 1.0, h, hkv),
             ("kv_len", b, s, s, 1500, d, 1.0, h, hkv),
             ("cli", b, 32, 32, None, d, 1.0, h, hkv),
             ("d64", b, s, s, None, 64, 1.0, h, hkv),
             ("sq>skv", b, 300, 200, None, d, 1.0, h, hkv),
             ("v8x", b, s, s, None, d, 8.0, h, hkv),
             ("zamba2", b, s, s, None, zd, 1.0, zh, zkv),
             ("zamba2 decode", b, 1, s + 1, None, zd, 1.0, zh, zkv),
             ("zamba2 kv_len", b, s, s, 1500, zd, 1.0, zh, zkv)]
    for nd, (nh, nkv) in NARROW_HEADS.items():
        cases += [(f"d{nd} gqa", b, 1000, 1000, None, nd, 1.0, nh, nkv),
                  (f"d{nd} decode", b, 1, s + 1, None, nd, 1.0, nh, nkv),
                  (f"d{nd} kv_len", 2, 300, 300, 250, nd, 1.0, nh, nkv)]
    results["flash_attention"]["head_dims"] = sorted({c[5] for c in cases})
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        rtol, atol = ATTN_TOL[dname]
        for what, bb, sq, skv, kv_len, dd, v_scale, h, hkv in cases:
            q, k, v = attention_inputs(gen, bb, sq, skv, h, hkv, dd, dtype,
                                       dev, v_scale)
            got = TA.flash_attention(q, k, v, kv_len=kv_len)
            want = TA.flash_attention_plain(q, k, v, kv_len=kv_len)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            results["flash_attention"]["max_abs_err"] = max(
                results["flash_attention"]["max_abs_err"], err)
            require(got.dtype == dtype and got.shape == q.shape
                    and torch.allclose(got.float(), want.float(), rtol=rtol,
                                       atol=atol),
                    f"flash_attention {dname} {what}: max err {err} "
                    f"outside rtol {rtol} atol {atol}")
            require(sq <= skv or bool((got[:, :sq - skv] == 0).all()),
                    f"flash_attention {dname} {what}: a row with no visible "
                    f"key is not 0")
            log(f"  flash_attention  {dname:8s} {what:13s} Sq={sq} Skv={skv} "
                f"H={h}/{hkv} D={dd} kv_len={kv_len} V x{v_scale:g}: max "
                f"|err| {err:.3g}")
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


def ptxas_usage(text):
    """``{kernel: (registers, spill store bytes, spill load bytes, stack
    frame bytes)}`` from the ``-Xptxas -v`` output of one source."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            usage[name] = [None, int(m.group(2)), int(m.group(3)),
                           int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in usage:
            usage[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def time_attention(dev, results):
    """#7 at the prefill shapes (`time_attention_widths`), each beside its
    plain version at qwen3-4b's D = 128 and zamba2-7b's D = 112: the
    kernels line takes zamba2-7b's, as its `launches` are zamba2-7b's; the
    registers and spills ptxas gave each instantiation of the Hopper
    kernel."""
    import torch
    from repro_torch.kernels.attention import kernel as TA
    widths = time_attention_widths(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 8)
    for key, (b, s, h, hkv, d) in (("qwen3-4b D=128", ATTN_SHAPE),
                                   ("zamba2-7b D=112", ZAMBA_ATTN)):
        q, k, v = attention_inputs(gen, b, s, s, h, hkv, d, torch.bfloat16,
                                   dev)
        widths[key]["plain_ms"] = device_ms(
            lambda: TA.flash_attention_plain(q, k, v), reps=5)
        del q, k, v
        log(f"  flash_attention bf16 {key}: plain "
            f"{widths[key]['plain_ms']:.4f} ms")
    row = widths["zamba2-7b D=112"]
    results["flash_attention"].update(
        shape=dict(zip(("B", "S", "H", "HKV", "D"), ZAMBA_ATTN)),
        ms=row["ms"], plain_ms=row["plain_ms"], library_ms=row["library_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        tflops=row["tflops"], widths=widths)
    results["flash_attention"]["ptxas"] = attention_ptxas()
    torch.cuda.empty_cache()


def time_attention_widths(dev):
    """#7 in bf16, L2 flushed between calls, at qwen3-4b's prefill shape
    (D = 128) and at zamba2-7b's (B = 4, S = 2048, 32 query over 32 KV
    heads) at every head width the wrapper takes, each beside
    `scaled_dot_product_attention` on the same inputs (the yardstick, never
    on the path) and its bound, with its TFLOP/s at 4·D FLOP per visible
    pair (phase 7b, and ``--only attention``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel as TA
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    out = {}
    shapes = [("qwen3-4b", ATTN_SHAPE)] + [
        ("zamba2-7b", ZAMBA_ATTN[:4] + (d,)) for d in TA.HEAD_DIMS]
    for label, (b, s, h, hkv, d) in shapes:
        q, k, v = attention_inputs(gen, b, s, s, h, hkv, d, torch.bfloat16,
                                   dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = device_ms(lambda: TA.flash_attention(q, k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bms, kind, tb, to = attention_bound(b, s, s, h, hkv, d, 2)
        tflops = to * BF16_OPS_PER_S / 1e3 / ms / 1e9
        out[f"{label} D={d}"] = dict(ms=ms, library_ms=lib, bound_ms=bms,
                                     bound_by=kind, tflops=tflops)
        log(f"  flash_attention bf16 {label} B={b} S={s} H={h}/{hkv} D={d}: "
            f"{ms:.4f} ms (bound {bms:.4f} ms by {kind}: bytes {tb:.4f} ms, "
            f"operations {to:.4f} ms), {tflops:.1f} TFLOP/s, {ms / bms:.2f}x "
            f"the bound; SDPA {lib:.4f} ms ({ms / lib:.2f}x)")
        del q, k, v, qt, kt, vt
    if {"zamba2-7b D=112", "zamba2-7b D=128"} <= set(out):
        ratio = out["zamba2-7b D=112"]["ms"] / out["zamba2-7b D=128"]["ms"]
        log(f"  flash_attention bf16 at zamba2's shape: D=112 / D=128 = "
            f"{ratio:.3f}")
    torch.cuda.empty_cache()
    return out


def attention_ptxas():
    """The registers and spills ptxas gave each instantiation of the bf16
    attention kernel: ``{name: (registers, spill store bytes, spill load
    bytes, stack frame bytes)}``."""
    from repro_torch.kernels import _build
    text = _build.build_all()["log"].get("flash_attention.cu", "")
    usage = {f"flash_wgmma_kernel<{m.group(1)}, {m.group(2)}>": v
             for k, v in ptxas_usage(text).items()
             for m in [re.search(r"flash_wgmma_kernelILi(\d+)ELb(\d)E", k)]
             if m}
    for name, (regs, st, ld, _) in usage.items():
        log(f"  ptxas {name}: {regs} registers, spills {st} bytes stored, "
            f"{ld} bytes loaded")
    if not usage:
        log("  ptxas: no compiler log for flash_attention.cu")
    return usage


def profile_lm_prefills(dev):
    """``--only lm-prefill``: one prefill of 4 x 2048 tokens of each
    full-width LM this tree carries (random init from the seed, bf16),
    after one untimed prefill, under `torch.profiler`: device busy, wall
    and kernel launches."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import factory
    out = {}
    for arch in ("qwen3-4b", "mamba2-1.3b", "zamba2-7b"):
        if arch not in ARCHS:
            continue
        model = factory.build(arch)
        gen = torch.Generator(dev).manual_seed(SEED)
        params = model.init(gen)
        prompts = torch.randint(0, model.cfg.vocab, (LM_BATCH, LM_PROMPT),
                                generator=gen, device=dev)
        prefill = make_prefill(model.cfg, LM_PROMPT)
        prefill(params, prompts)
        log(f"  {arch}: one prefill of {LM_BATCH} x {LM_PROMPT} tokens:")
        out[arch] = profile_window(lambda: prefill(params, prompts), 1)
        del params, prompts
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---- phase 2d: the SSD scan against its plain version -----------------------

SSD_SHAPE = (LM_BATCH, 2048, 64, 64, 128)      # B, L, H, P, S at mamba2-1.3b
ZAMBA_SSD = (LM_BATCH, 2048, 112, 64, 64)      # the same at zamba2-7b
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


def ssd_inputs(gen, b, length, h, p, s, g, dtype, dev, shift=0):
    """x, B and C cut from one packed (B, L, H*P + 2*G*S) projection (x is
    not contiguous; ``shift`` leading elements move every base and token
    stride off 16 bytes), dt = softplus(N(0, 1)) and a = -exp(N(0, 0.25)):
    the decay reaches exp(-100) and below within a chunk."""
    import torch
    import torch.nn.functional as F
    packed = torch.randn(b, length, shift + h * p + 2 * g * s, generator=gen,
                         device=dev).to(dtype)[..., shift:]
    x = packed[..., :h * p].unflatten(-1, (h, p))
    bm = packed[..., h * p:h * p + g * s].unflatten(-1, (g, s))
    cm = packed[..., h * p + g * s:].unflatten(-1, (g, s))
    dt = F.softplus(torch.randn(b, length, h, generator=gen, device=dev))
    a = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))
    return x, dt, a, bm, cm


def compare_ssd(dev, results):
    """#8 against `ssd_scan_plain` (the chunked form at the model's chunk)
    on the same inputs: mamba2-1.3b's prefill shape, ragged L = 1, 100 and
    300, G = 2, the serve CLI's 32-token prompts, a projection shifted by
    one element (bfloat16 then takes the cp.async route), and zamba2-7b's
    prefill shape (H = 112, S = 64) and its 32-token prompts; bfloat16 and
    float32.  Then the kernel against the literal recurrence at a small
    size."""
    import torch
    from repro_torch.kernels.ssd import kernel as SK, ref as SR
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    b, length, h, p, s = SSD_SHAPE
    zh, zp, zs = ZAMBA_SSD[2:]
    # (what, B, L, G, shift, (H, P, S))
    cases = [("prefill", b, length, 1, 0, (h, p, s)),
             ("L=1", b, 1, 1, 0, (h, p, s)),
             ("L=100", b, 100, 1, 0, (h, p, s)),
             ("L=300", b, 300, 1, 0, (h, p, s)),
             ("G=2", 2, 300, 2, 0, (h, p, s)),
             ("cli", b, 32, 1, 0, (h, p, s)),
             ("shifted", b, 300, 1, 1, (h, p, s)),
             ("zamba2", b, ZAMBA_SSD[1], 1, 0, (zh, zp, zs)),
             ("zamba2 cli", b, 32, 1, 0, (zh, zp, zs))]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for what, bb, ll, g, shift, (h, p, s) in cases:
            args = ssd_inputs(gen, bb, ll, h, p, s, g, dtype, dev, shift)
            route = SK.copy_route(args[0], args[3], args[4])
            require(dtype != torch.bfloat16
                    or route == ("cp.async" if shift else "tma"),
                    f"ssd_scan {what}: the {route} route")
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
            log(f"  ssd_scan {dname:8s} {what:10s} B={bb} L={ll} H={h} S={s} "
                f"G={g}"
                + (f" ({route})" if dtype == torch.bfloat16 else "")
                + f": max |err| y {errs[0]:.3g}, state {errs[1]:.3g}")
            del args, got, want
    b, length, h, p, s = SSD_SHAPE
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


SSD_SWEEP_L = (512, 1024, 2048, 4096)           # phase 7c's L sweep, B = 4


def time_ssd(dev, results):
    """#8 at mamba2-1.3b's prefill shape in bfloat16 (x, B, C cut from a
    packed projection, as the model passes them), L2 flushed between calls,
    beside its plain version; no single PyTorch call computes an SSD scan.
    Then one prompt (B = 1), the L sweep fitted as fixed + per-chunk cost
    (64 rows a chunk) beside the bound's own fit, the CTAs an SM holds
    (occupancy query) and the registers and spills ptxas gave each kernel;
    these go under ``mamba2-1.3b``.  Last zamba2-7b's prefill shape, held
    against the plain version and then timed: the kernels line takes its
    numbers, as its `launches` are zamba2-7b's."""
    import torch
    from repro_torch.kernels import _build
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
    del args, one
    sweep_ms, sweep_bound = [], []
    for ll in SSD_SWEEP_L:
        sw = ssd_inputs(gen, b, ll, h, p, s, 1, torch.bfloat16, dev)
        sweep_ms.append(device_ms(lambda: SK.ssd_scan(*sw)))
        sweep_bound.append(ssd_bound(b, ll, h, p, s, 1, SSD_CHUNK, 2)[0])
        del sw
    chunks = [ll // SK.CHUNK for ll in SSD_SWEEP_L]
    fixed, per_chunk = fit_line(chunks, sweep_ms)
    b_fixed, b_chunk = fit_line(chunks, sweep_bound)
    usage = ptxas_usage(_build.build_all()["log"].get("ssd.cu", ""))
    ptxas = {name: dict(registers=r, spill_store_bytes=st,
                        spill_load_bytes=ld, stack_bytes=sk)
             for name, (r, st, ld, sk) in usage.items()}
    results["ssd_scan"]["mamba2-1.3b"] = dict(
        shape=dict(zip("BLHPS", SSD_SHAPE)),
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=kind,
        blocks_per_sm=per_sm, ms_b1=ms_b1, ptxas=ptxas,
        sweep=dict(length=list(SSD_SWEEP_L), ms=sweep_ms,
                   fixed_ms=fixed, per_chunk_ms=per_chunk,
                   bound_ms=sweep_bound, bound_fixed_ms=b_fixed,
                   bound_per_chunk_ms=b_chunk))
    log(f"  ssd_scan bf16 B={b} L={length} H={h} P={p} S={s}: {ms:.4f} ms "
        f"(bound {bms:.4f} ms by {kind}: bytes {tb:.4f} ms, operations "
        f"{to:.4f} ms; plain {plain:.4f} ms; {b * h} CTAs, {per_sm} per SM)"
        f"; B=1: {ms_b1:.4f} ms (bound {bms1:.4f} ms, {h} CTAs)")
    log(f"  ssd_scan bf16 L sweep (B={b}) "
        + ", ".join(f"L={ll} {t:.4f}" for ll, t in zip(SSD_SWEEP_L, sweep_ms))
        + f" ms: fixed {fixed:.4f} ms + {per_chunk * 1e3:.3f} us/chunk "
        f"(bound {b_fixed:.4f} ms + {b_chunk * 1e3:.3f} us/chunk)")
    for name, (r, st, ld, sk) in usage.items():
        log(f"  ptxas {name}: {r} registers, spills {st} B stored / {ld} B "
            f"loaded, stack {sk} B")
    if not usage:
        log("  ptxas: ssd.cu was not built in this process")
    # zamba2-7b's prefill shape: x, B and C cut from the conv output of
    # width 7168 + 2 * 64, as the model hands them over
    b, length, h, p, s = ZAMBA_SSD
    args = ssd_inputs(gen, b, length, h, p, s, 1, torch.bfloat16, dev)
    route = SK.copy_route(args[0], args[3], args[4])
    require(route == "tma", f"ssd_scan at zamba2's shape: the {route} route")
    got = SK.ssd_scan(*args)
    want = SK.ssd_scan_plain(*args, chunk=SSD_CHUNK)
    require(all(ssd_close(x, w) for x, w in zip(got, want)),
            "ssd_scan bf16 at zamba2's shape differs from its plain version")
    del got, want
    ms = device_ms(lambda: SK.ssd_scan(*args))
    plain = device_ms(lambda: SK.ssd_scan_plain(*args, chunk=SSD_CHUNK),
                      reps=5)
    bms, kind, tb, to = ssd_bound(b, length, h, p, s, 1, SSD_CHUNK, 2)
    results["ssd_scan"].update(
        shape=dict(zip("BLHPS", ZAMBA_SSD)), ms=ms, plain_ms=plain,
        library_ms=None, bound_ms=bms, bound_by=kind, route=route)
    log(f"  ssd_scan bf16 B={b} L={length} H={h} P={p} S={s} ({route}): "
        f"{ms:.4f} ms (bound {bms:.4f} ms by {kind}: bytes {tb:.4f} ms, "
        f"operations {to:.4f} ms; plain {plain:.4f} ms; {b * h} CTAs)")
    del args
    torch.cuda.empty_cache()


# ---- phase 2g / 7d: silu against its plain version, and its time -----------

def silu_cases():
    """Every silu the LM paths launch, per full-width LM: ``(what, shape,
    x dtype, other dtype or None, out dtype, projection width or None)``.
    The SwiGLU gate times x @ up (bf16); in a Mamba2 block the conv
    activation (bf16), and the output gate on z cut from the input
    projection (rows at the projection's stride) times y into float32:
    bf16 y at prefill, float32 y at decode; and the float32 models of
    phases 8b, 9b and 11b.  In deepseek-moe-16b (phase 15) the dense
    layer's and the shared experts' gates, and the routed experts' on
    their ``(E, cap, d_expert)`` GEMM outputs: at prefill (cap 960), at
    decode (cap 1) and at a pool admission of 512 tokens at
    ``capacity_factor = num_experts`` (cap 3072).  The dense archs of
    phase 16: their MLP gate in bf16, qwen1.5-32b's in float32 too (16c
    runs it in float32)."""
    from repro_torch.models import moe as MoE, ssm as MS
    cases = []
    for arch in ("qwen3-4b", "mamba2-1.3b", "zamba2-7b"):
        cfg = lm_config(arch)[0]
        if cfg.d_ff:
            for dt in ("bfloat16", "float32"):
                cases.append((f"{arch} mlp {dt}", (LM_BATCH, LM_PROMPT,
                              cfg.d_ff), dt, dt, dt, None))
        if cfg.ssm is not None:
            d_inner, heads, d_xbc = MS.dims(cfg)
            proj = d_inner + d_xbc + heads
            for s in (LM_PROMPT, 1):
                step = "prefill" if s > 1 else "decode"
                cases += [(f"{arch} conv {step}", (LM_BATCH, s, d_xbc),
                           "bfloat16", None, "bfloat16", None),
                          (f"{arch} gate {step}", (LM_BATCH, s, d_inner),
                           "bfloat16", "bfloat16" if s > 1 else "float32",
                           "float32", proj)]
            cases += [(f"{arch} conv float32", (LM_BATCH, LM_PROMPT, d_xbc),
                       "float32", None, "float32", None),
                      (f"{arch} gate float32", (LM_BATCH, LM_PROMPT,
                       d_inner), "float32", "float32", "float32", proj)]
    cfg = lm_config(MOE_ARCH)[0]
    moe = cfg.moe
    e, f = moe.num_experts, moe.d_expert
    raised = cfg.with_(moe=dataclasses.replace(moe, capacity_factor=e))
    for dt in ("bfloat16", "float32"):
        cases += [(f"moe dense_ff {dt}", (LM_BATCH, LM_PROMPT,
                   moe.first_dense_ff), dt, dt, dt, None),
                  (f"moe shared {dt}", (LM_BATCH, LM_PROMPT,
                   moe.n_shared * f), dt, dt, dt, None),
                  (f"moe routed prefill {dt}", (e, MoE.capacity(
                      cfg, LM_BATCH * LM_PROMPT), f), dt, dt, dt, None)]
    for what, c, tokens in (("decode", cfg, POOL_SLOTS),
                            ("pool admission", raised, max(POOL_PROMPTS))):
        cases.append((f"moe routed {what}", (e, MoE.capacity(c, tokens), f),
                      "bfloat16", "bfloat16", "bfloat16", None))
    for arch in (KVQ_ARCH,) + KVQ_OTHERS:
        d_ff = lm_config(arch)[0].d_ff
        for dt in ("bfloat16", "float32")[:2 if arch == KVQ_ARCH else 1]:
            cases.append((f"{arch} mlp {dt}", (LM_BATCH, LM_PROMPT, d_ff),
                          dt, dt, dt, None))
    return cases


def silu_inputs(gen, shape, xd, od, proj, dev):
    import torch
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    wide = 4 * torch.randn(*shape[:-1], proj or shape[-1], generator=gen,
                           device=dev)
    x = wide.to(dt[xd])[..., :shape[-1]]
    other = None if od is None else torch.randn(
        shape, generator=gen, device=dev).to(dt[od])
    return x, other


def compare_silu(dev, results):
    """`layers.silu` (csrc/silu.cu, one pass) against `silu_plain` (the
    five ops as ``jax.nn.silu`` writes them, each rounding to x's dtype)
    at every shape the LM paths give it (`silu_cases`), bit for bit."""
    import torch
    from repro_torch.models import layers as ML
    gen = torch.Generator(dev).manual_seed(SEED + 12)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for what, shape, xd, od, yd, proj in silu_cases():
        x, other = silu_inputs(gen, shape, xd, od, proj, dev)
        got = ML.silu(x, other, dt[yd])
        want = ML.silu_plain(x, other, dt[yd])
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        results["silu"]["max_abs_err"] = max(results["silu"]["max_abs_err"],
                                             err)
        require(got.dtype == dt[yd] and torch.equal(got, want),
                f"silu {what}: differs from its plain version (max err "
                f"{err})")
        log(f"  silu {what:26s} {tuple(shape)} x {xd}, other {od}, out {yd}"
            f": bit for bit")
        del x, other, got, want
    torch.cuda.empty_cache()


def time_silu(dev, results):
    """silu times x @ up at zamba2-7b's prefill MLP (4 x 2048 rows of
    14336, bf16), L2 flushed between calls, beside its plain version and
    its bound (x and up read once, y written once); no single PyTorch call
    rounds as ``jax.nn.silu`` is written (``F.silu`` rounds once), so
    ``library_ms`` is null; ``F.silu(x) * up``, what the port ran before
    it rounded as JAX does, is printed beside it.  Then qwen3-4b's MLP and
    zamba2-7b's conv activation."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as ML
    gen = torch.Generator(dev).manual_seed(SEED + 13)
    out = {}
    for label, d, mul in (("zamba2-7b mlp", 14336, True),
                          ("qwen3-4b mlp", 9728, True),
                          ("zamba2-7b conv", 7296, False)):
        shape = (LM_BATCH, LM_PROMPT, d)
        x, other = silu_inputs(gen, shape, "bfloat16",
                               "bfloat16" if mul else None, None, dev)
        ms = device_ms(lambda: ML.silu(x, other))
        plain = device_ms(lambda: ML.silu_plain(x, other))
        once = device_ms((lambda: F.silu(x) * other) if mul
                         else (lambda: F.silu(x)))
        n = LM_BATCH * LM_PROMPT * d
        # neg, exp, add, divide, multiply (and the product) per element
        bms, kind = bound(2 * n * (3 if mul else 2), n * (6 if mul else 5))
        out[label] = dict(ms=ms, plain_ms=plain, library_ms=None,
                          bound_ms=bms, bound_by=kind, f_silu_ms=once)
        log(f"  silu bf16 {label} {shape}{' x up' if mul else ''}: "
            f"{ms:.4f} ms (bound {bms:.4f} ms by {kind}, {bms / ms:.0%} of "
            f"the memory rate; plain, five ops{' and the product' if mul else ''}"
            f" {plain:.4f} ms; F.silu{' x up' if mul else ''}, rounding once,"
            f" {once:.4f} ms)")
        del x, other
    row = out["zamba2-7b mlp"]
    results["silu"].update(shape=dict(B=LM_BATCH, S=LM_PROMPT, d_ff=14336),
                           **{k: row[k] for k in ("ms", "plain_ms",
                                                  "library_ms", "bound_ms",
                                                  "bound_by")},
                           shapes=out)
    torch.cuda.empty_cache()


# ---- phase 8: LM serving at full width --------------------------------------

def serve_logits(cfg, params, prompts, gen, tokens=None, keep_cache=False):
    """Prefill + ``gen`` decode steps through the serving step builders,
    every step's logits kept (float32, on the card).  Greedy, or
    teacher-forced on ``tokens (B, gen)``.  Returns (logits list, tokens);
    the cache is freed, or with ``keep_cache`` returned third."""
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
    if keep_cache:
        return outs, torch.stack(toks, 1), cache
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
                    close=None, quiet=False):
    """Each recorded call on the path, one launch of kernel ``name``,
    against ``plain`` on the same inputs: bit for bit if ``exact``, else
    within ``tol = (rtol, atol)``, or as ``close(got, want)`` says.
    Returns the largest error; ``quiet`` logs nothing."""
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
    if not quiet:
        log(f"  {name:14s} {what}: all {len(calls)} launches against the "
            f"plain version on their inputs, max |err| {err:.3g}")
    return err


def plain_kernels():
    """Patches that send the LM path through the plain versions: the plain
    attention, SSD scan and silu in the model and the plain fleet steps in
    the engine."""
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import attention as MA, layers as ML, ssm as MS
    return (mock.patch.object(MA, "attn_op", TA.flash_attention_plain),
            mock.patch.object(MS, "ssd_op", SK.ssd_scan_plain),
            mock.patch.object(ML, "silu", ML.silu_plain),
            mock.patch.object(MS, "silu", ML.silu_plain),
            mock.patch.object(K, "fleet_step", K.fleet_step_plain),
            mock.patch.object(K, "fleet_step_q", K.fleet_step_q_plain))


def lm_config(arch):
    """The full-width config of ``arch`` and ``{wrapper: launches}`` of the
    kernels its prefill launches: the attention kernel once per attention
    block (a zamba2 super-block's shared block included), the SSD scan
    once per Mamba2 block.  silu launches in every forward, prefill or
    decode step: `silu_per_forward`."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models.transformer import segments
    cfg = get_config(arch)
    n = {TA.flash_attention: 0, SK.ssd_scan: 0}
    for kind, count in segments(cfg):
        n[SK.ssd_scan if kind == "ssm" else TA.flash_attention] += count
        if kind == "zsuper":
            n[SK.ssd_scan] += count * (cfg.ssm.attn_every - 1)
    return cfg, {k: v for k, v in n.items() if v}


def silu_per_forward(cfg):
    """silu launches in one forward (a prefill or a decode step): one per
    MLP, two per Mamba2 block (the conv activation and the output gate),
    one per MoE FFN's routed experts and one more for its shared experts
    if it has any."""
    from repro_torch.models.transformer import segments
    n = 0
    moe = 1 + bool(cfg.moe is not None and cfg.moe.n_shared)
    for kind, count in segments(cfg):
        n += {"dense": 1, "dense_ff": 1, "ssm": 2, "moe": moe}.get(
            kind, 0) * count
        if kind == "zsuper":
            n += count * (1 + 2 * (cfg.ssm.attn_every - 1))
    return n


def rel_err(got, want):
    """Largest |got - want| over the largest |want| across steps."""
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / \
        max(float(w.abs().max()) for w in want)


@contextlib.contextmanager
def expert_choices(into):
    """Append each MoE layer's expert choices ``(G, Tg, K)`` to ``into``
    as `moe.route` makes them (nothing else of the call is kept)."""
    from repro_torch.models import moe as MoE
    real = MoE.route

    def route(*a, **kw):
        r = real(*a, **kw)
        into.append(r.expert_idx)
        return r

    with mock.patch.object(MoE, "route", route):
        yield into


def assignment_agreement(got, want):
    """The share of (token, k) expert assignments that agree between two
    runs' `expert_choices`, call by call."""
    require(len(got) == len(want) and all(
        g.shape == w.shape for g, w in zip(got, want)),
        "the two runs made different MoE calls")
    same = sum(int((g == w).sum()) for g, w in zip(got, want))
    return same / sum(g.numel() for g in got)


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


def lm_path(dev, counters, every, results, arch="qwen3-4b", profile=True):
    """Serve 4 x 2048-token prompts with 32 greedy tokens on random-init
    ``arch`` at full width and depth (qwen3-4b: 36 attention layers;
    mamba2-1.3b: 48 SSM layers; zamba2-7b: 9 super-blocks, each the shared
    attention block and 8 SSM layers; deepseek-moe-16b: a dense layer and
    27 MoE layers; bf16), the plastic adapter in float32 then int8, through
    `launch.serve.generate`: each datapath once to warm up (the prefill
    and `LM_WARM` steps), then once timed.  Every counter is set to 0 just
    before the timed run and read just after it.  For a MoE model every
    attention launch of the first prefill is held against its plain
    version on its own inputs.  The full-depth comparison with the plain
    path runs the prefill and `LM_COMPARE_GEN` steps; for a MoE model it
    also reports the share of (token, k) expert assignments that agree.
    ``profile``: profile a prefill and `PROFILED_STEPS` decode steps in
    this process."""
    import torch
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.launch import serve
    from repro_torch.models import attention as MA, factory, layers as ML, \
        plastic
    cfg, mixers = lm_config(arch)
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
        attns = []
        with (recording(MA, "attn_op", attns) if cfg.moe is not None
              and not quant else contextlib.nullcontext()):
            serve.generate(qcfg, params, prompts, LM_PROMPT + LM_GEN, LM_WARM)
        torch.cuda.synchronize()
        if attns:
            # the first prefill's attention launches, each on its inputs
            replay_launches(attns, TA.flash_attention_plain,
                            "flash_attention", results, f"{arch} prefill",
                            False, ATTN_TOL["bfloat16"])
            out["prefill_attention_held"] = len(attns)
            del attns
        steps = []
        for c in every:
            c.launches = 0
        with recording(plastic, "decode_step", steps):
            toks, lats, cache, prefill_s = serve.generate(
                qcfg, params, prompts, LM_PROMPT + LM_GEN, LM_GEN)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        for mixer, want in mixers.items():
            require(mixer.launches == want,
                    f"{mode}: {mixer.launches} {mixer.__name__} launches in "
                    f"one prefill, want {want}")
        require(step.launches == LM_GEN,
                f"{mode}: {step.launches} {step.__name__} launches in "
                f"{LM_GEN} decode steps, want {LM_GEN}")
        want = silu_per_forward(cfg) * (1 + LM_GEN)
        require(ML.silu.launches == want,
                f"{mode}: {ML.silu.launches} silu launches in a prefill and "
                f"{LM_GEN} decode steps, want {want}")
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
    # for the layouts with SSM blocks also two plain paths that differ only
    # in the SSD chunk length, i.e. in float32 summation order: how far bf16
    # rounding alone moves this random-init model
    got_routes, want_routes = [], []
    with expert_choices(got_routes):
        got, toks = serve_logits(cfg, params, prompts, LM_COMPARE_GEN)
    with contextlib.ExitStack() as stack:
        for p in plain_kernels():
            stack.enter_context(p)
        with expert_choices(want_routes):
            want, _ = serve_logits(cfg, params, prompts, LM_COMPARE_GEN,
                                   toks)
        if cfg.ssm is not None:
            from repro_torch.kernels.ssd import kernel as SK
            from repro_torch.models import ssm as MS
            stack.enter_context(mock.patch.object(
                MS, "ssd_op", lambda *a, chunk: SK.ssd_scan_plain(
                    *a, chunk=64)))
            other, _ = serve_logits(cfg, params, prompts, LM_COMPARE_GEN,
                                    toks)
    pairs = [("kernel vs plain path", got, want)]
    if cfg.ssm is not None:
        pairs.append(("plain path, chunk 64 vs 256", other, want))
    out["bf16_full_depth"] = {}
    for what, x, y in pairs:
        agree = float(torch.stack([g.argmax(-1) == w.argmax(-1)
                                   for g, w in zip(x, y)]).float().mean())
        err, err0 = rel_err(x, y), rel_err(x[:1], y[:1])
        out["bf16_full_depth"][what] = dict(
            max_rel_logit_diff=err, prefill_rel_logit_diff=err0,
            greedy_agreement=agree)
        log(f"  bf16, {cfg.n_layers} layers, {what}, prefill + "
            f"{LM_COMPARE_GEN} steps: max rel logit diff {err:.3g} (prefill "
            f"logits {err0:.3g}), greedy agreement {agree:.3f}")
    if got_routes:
        share = assignment_agreement(got_routes, want_routes)
        out["bf16_full_depth"]["kernel vs plain path"][
            "assignment_agreement"] = share
        log(f"  bf16, {cfg.n_layers} layers, kernel vs plain path: "
            f"{share:.4f} of the (token, k) expert assignments agree over "
            f"{len(got_routes)} MoE calls")
    del got, want, pairs, got_routes, want_routes
    if not profile:
        del params
        torch.cuda.empty_cache()
        return out, total
    # profile one prefill, then PROFILED_STEPS decode steps after it
    from repro_torch.launch.steps import make_decode_step, make_prefill
    prefill = make_prefill(cfg, LM_PROMPT + 8)
    made = []
    log("  one prefill of 4 x 2048 tokens:")
    out["profile_prefill"] = profile_window(
        lambda: made.append(prefill(params, prompts)), 1)
    logits, cache = made.pop()
    decode = make_decode_step(cfg)
    tok = logits.argmax(-1).to(torch.int32)[:, None]

    def steps():
        nonlocal cache
        for _ in range(PROFILED_STEPS):
            _, cache = decode(params, cache, tok)

    log(f"  {PROFILED_STEPS} decode steps, float32 adapter:")
    out["profile_decode"] = profile_window(steps, PROFILED_STEPS)
    del params, cache
    torch.cuda.empty_cache()
    return out, total


def shallow(cfg):
    """``cfg`` cut to 2 layers (qwen3-4b, mamba2-1.3b), or for the hybrid to
    4 with a super-block of 3: one super-block (the shared attention block
    and 2 SSM layers) and one trailing SSM layer, the remainder segment."""
    if cfg.layout == "hybrid":
        return cfg.with_(n_layers=4, ssm=dataclasses.replace(cfg.ssm,
                                                              attn_every=3))
    return cfg.with_(n_layers=2)


def lm_depth2_matches(dev, arch="qwen3-4b"):
    """Full width, `shallow` depth, float32: prefill and decode logits
    through the kernels equal the plain path's within 1e-4 of the largest
    logit, and the greedy tokens are the same; in a MoE layer so are the
    expert choices of every token."""
    import torch
    from repro_torch.models import factory
    for quant in (False, True):
        cfg = shallow(lm_config(arch)[0]).with_(
            dtype="float32", plastic_adapter=True, adapter_neurons=128,
            adapter_quant=quant)
        gen = torch.Generator(dev).manual_seed(SEED + 1)
        params = factory.build(cfg).init(gen)
        prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                                generator=gen, device=dev)
        got_routes, want_routes = [], []
        with expert_choices(got_routes):
            got, toks = serve_logits(cfg, params, prompts, LM_GEN)
        with contextlib.ExitStack() as stack:
            for p in plain_kernels():
                stack.enter_context(p)
            with expert_choices(want_routes):
                want, _ = serve_logits(cfg, params, prompts, LM_GEN, toks)
        err = rel_err(got, want)
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        mode = "int8" if quant else "float32"
        if cfg.moe is not None:
            share = assignment_agreement(got_routes, want_routes)
            require(share == 1.0,
                    f"{cfg.n_layers}-layer float32 ({mode} adapter): "
                    f"{share:.6f} of the expert assignments agree with the "
                    f"plain path's, want all")
            log(f"  {arch}, {cfg.n_layers} layers, float32, {mode} adapter: "
                f"every expert choice of {len(got_routes)} MoE calls equals "
                f"the plain path's")
        del got_routes, want_routes
        require(err <= 1e-4 and same,
                f"{cfg.n_layers}-layer float32 ({mode} adapter): kernel path "
                f"differs from the plain path (max rel logit diff {err:.3g}, "
                f"greedy tokens {'equal' if same else 'differ'})")
        log(f"  {arch}, {cfg.n_layers} layers, float32, {mode} adapter: max "
            f"rel logit diff {err:.3g} over prefill + {LM_GEN} steps, greedy "
            f"tokens equal")
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
    attention, SSD-scan, silu and fleet-step launch of the run is then held
    against its plain version on its own inputs (silu bit for bit)."""
    import io
    import torch
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch import serve
    from repro_torch.models import attention as MA, layers as ML, plastic, \
        ssm as MS
    cfg, mixers = lm_config(arch)
    buf, attns, scans, steps, silus = io.StringIO(), [], [], [], []
    with contextlib.redirect_stdout(buf), \
            recording(MA, "attn_op", attns), recording(MS, "ssd_op", scans), \
            recording(ML, "silu", silus), recording(MS, "silu", silus), \
            recording(plastic, "decode_step", steps):
        rc = serve.main(["--arch", arch, "--plastic"])
    out = json.loads(buf.getvalue())
    require(rc == 0 and out["launches"]["fleet_step"] == 16
            and all(out["launches"][m.__name__] == n
                    for m, n in mixers.items())
            and out["launches"]["silu"] == silu_per_forward(cfg) * 17,
            f"serve CLI default: rc {rc}, launches {out['launches']}")
    if scans:
        replay_launches(scans, SK.ssd_scan_plain, "ssd_scan", results,
                        "serve CLI", False, None, close=ssd_close)
    if attns:
        replay_launches(attns, TA.flash_attention_plain, "flash_attention",
                        results, "serve CLI", False, ATTN_TOL["bfloat16"])
    replay_launches(silus, ML.silu_plain, "silu", results, "serve CLI", True,
                    None)
    replay_launches(steps, plain_adapter_step, "fleet_step", results,
                    "serve CLI (adapter steps)", False, (1e-5, 1e-5))
    del attns, scans, steps, silus
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
    for b, n, m, spiking in ((B, 8, 128, True), (B, 128, 8, False),
                             (4, 128, 128, True)):
        act = active
        if b < B:
            act = active[:b].clone()
            act[b // 2] = False          # a vacant slot among the four
        for quant in (False, True):
            x, w, theta, v, tpre, tpost = rand_fleet_inputs(
                gen, b, n, m, quant, dev)
            if quant:
                teach = torch.randint(-300, 300, (b, m), generator=gen,
                                      device=dev, dtype=torch.int32)
                scale = torch.where(torch.arange(b, device=dev) % 2 == 0,
                                    1 / 32, 1 / 16).float()
                seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (b,),
                                     generator=gen, device=dev,
                                     dtype=torch.int64).int()
                args = (x, w, scale, theta, v, tpre, tpost)
                kw = dict(qcfg=qc, spiking=spiking, seed=seed, teach=teach,
                          active=act)
                fn, plain, name = (K.fleet_step_q, K.fleet_step_q_plain,
                                   "fleet_step_q_telemetry")
            else:
                if n * m > 8192:
                    # the row sums 16,384 |dw| near 1e3, where a float32
                    # ulp is ~1e-4: traces on quarters and the rule on
                    # 2^-8 make every partial sum exact, so TEL_TOL holds
                    # the same number whatever the summation order
                    tpre, tpost = (torch.round(t * 4) / 4
                                   for t in (tpre, tpost))
                    theta = torch.round(theta * 256) / 256
                teach = 0.5 * torch.randn(b, m, generator=gen, device=dev)
                args = (x, w, theta, v, tpre, tpost)
                kw = dict(spiking=spiking, teach=teach, active=act)
                fn, plain, name = (K.fleet_step, K.fleet_step_plain,
                                   "fleet_step_telemetry")
            got = fn(*args, telemetry=True, **kw)
            off = fn(*args, **kw)
            want = plain(*args, telemetry=True, **kw)
            held(name, got[:4], want[:4], quant, results,
                 f"B={b} N={n} M={m} state against plain")
            held_telemetry(name, got, off, want, quant, results,
                           f"B={b} N={n} M={m}", act)
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


# ---- phases 5 and 7f: the fleet steps per layer shape ------------------------

# (label, B, N, M, spiking): the controller's two layers at full width and
# the LM adapter's one layer per decode step
FLEET_SHAPES = (("8->128", B, 8, 128, True), ("128->8", B, 128, 8, False),
                ("adapter 128->128", 4, 128, 128, True))
PROFILE_CALLS = 10


def fleet_shape_inputs(gen, mode, b, n, m, dev):
    """Positional arguments of one fleet step in FLEET_MODES (the rule in
    bf16 for bfloat16) and its fixed-point keywords."""
    import torch
    from repro_torch.kernels.plasticity.quant import QuantConfig
    if mode == "bfloat16":
        return bf16_fleet_inputs(gen, b, n, m, dev), {}
    x, w, theta, v, tpre, tpost = rand_fleet_inputs(gen, b, n, m,
                                                    mode == "int8", dev)
    if mode == "float32":
        return (x, w, theta, v, tpre, tpost), {}
    scale = torch.full((b,), 1 / 32, device=dev)
    seed = torch.arange(b, dtype=torch.int32, device=dev)
    return (x, w, scale, theta, v, tpre, tpost), dict(qcfg=QuantConfig(),
                                                     seed=seed)


def fleet_step_launches(dev):
    """Each fleet-step instantiation's launch at each `FLEET_SHAPES` shape
    (warps, tile, buffers, rule route, shared memory, CTAs an SM holds by
    the occupancy query, CTAs launched) and the registers, spills and stack
    ptxas gave each kernel of ``csrc/fleet_step.cu``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.plasticity import kernel as K
    out = {"launch": {}}
    for kind, th_bf16 in (("float32", False), ("int8", False),
                          ("bfloat16", True), ("bfloat16", False)):
        for label, b, n, m, _ in FLEET_SHAPES:
            for tel in (False, True):
                info = K.fleet_step_launch(dev, b, n, m, True, kind=kind,
                                           telemetry=tel,
                                           theta_bf16=th_bf16)
                rule = (", rule float32" if kind == "bfloat16"
                        and not th_bf16 else "")
                name = f"{kind}{rule} {label}" + (" telemetry" if tel
                                                  else "")
                out["launch"][name] = {k: v for k, v in info.items()
                                       if k != "role_smem"}
                log(f"  launch {name}: " + ", ".join(
                    f"{k} {v}" for k, v in out["launch"][name].items()))
    usage = ptxas_usage(_build.build_all()["log"].get("fleet_step.cu", ""))
    out["ptxas"] = {name: dict(registers=r, spill_store_bytes=st,
                               spill_load_bytes=ld, stack_bytes=sk)
                    for name, (r, st, ld, sk) in usage.items()}
    for name, (r, st, ld, sk) in usage.items():
        log(f"  ptxas {name}: {r} registers, spills {st} B stored / {ld} B "
            f"loaded, stack {sk} B")
    if not usage:
        log("  ptxas: no compiler log for fleet_step.cu")
    return out


# results' kernel names of the per-shape timings, by (mode, telemetry)
SHAPE_NAMES = {("float32", False): "fleet_step",
               ("float32", True): "fleet_step_telemetry",
               ("int8", False): "fleet_step_q",
               ("int8", True): "fleet_step_q_telemetry",
               ("bfloat16", False): "fleet_step_bf16",
               ("bfloat16", True): "fleet_step_bf16_telemetry"}


def file_shapes(results, shapes):
    """`time_fleet_shapes` rows into each kernel's ``shapes`` entry."""
    for key, row in shapes.items():
        mode, rest = key.split(" ", 1)
        tel = rest.endswith(" telemetry")
        label = rest[:-len(" telemetry")] if tel else rest
        results[SHAPE_NAMES[mode, tel]].setdefault("shapes", {})[label] = row


def time_fleet_shapes(dev, modes):
    """#1 and #2 per layer shape (`FLEET_SHAPES`) in each of ``modes``,
    3/4 of the slots active, telemetry off and on: the whole wrapper call
    by `device_ms` (L2 flushed), the kernel alone and the wrapper's other
    device ops by `profiled_ms`, and the bound."""
    import torch
    from repro_torch.kernels.plasticity import kernel as K
    gen = torch.Generator(dev).manual_seed(SEED + 15)
    out = {}
    for mode in modes:
        quant, eb = mode == "int8", 2 if mode == "bfloat16" else 4
        fn = K.fleet_step_q if quant else K.fleet_step
        for label, b, n, m, spiking in FLEET_SHAPES:
            args, kw = fleet_shape_inputs(gen, mode, b, n, m, dev)
            kw.update(spiking=spiking,
                      active=torch.rand(b, generator=gen, device=dev) < 0.75)
            for tel in (False, True):
                call = lambda: fn(*args, telemetry=tel, **kw)
                ms = device_ms(call)
                kern, other, ops = profiled_ms(call, "write", "fleet_step")
                syn_ops = OPS_Q if quant else OPS_F32
                ops_total = b * n * m * (syn_ops + (OPS_TEL_SYN if tel
                                                    else 0)) \
                    + (b * m * OPS_TEL_COL if tel else 0)
                b_ms, kind = bound(step_bytes(b, n, m, 1 if quant else eb,
                                              sb=eb, tb=eb)
                                   + (b * 3 * 4 if tel else 0), ops_total)
                key = f"{mode} {label}" + (" telemetry" if tel else "")
                out[key] = dict(ms=ms, kernel_ms=kern, other_ms=other,
                                other_ops=ops, bound_ms=b_ms, bound_by=kind)
                log(f"  {key:36s} {ms:.4f} ms a call: kernel "
                    + ("not measured" if kern is None else
                       f"{kern:.4f} ms + {ops:.0f} other ops {other:.4f} ms")
                    + f"; bound {b_ms:.4f} ms ({kind})")
    return out


# (label, B, N, M): the online learner's two layers (784-1024-10), the
# readout taught, at the per-event B = 1 and a batch of 8
SHARED_SHAPES = tuple((f"{n}->{m} B={b}", b, n, m) for n, m in
                      ((784, 1024), (1024, 10)) for b in (1, 8))
SHARED_MODES = {"float32": "shared_step", "bfloat16": "shared_step_bf16",
                "int8": "shared_step_q"}


def shared_shape_call(gen, mode, b, n, m, dev):
    """One call of #4 (float32, or bfloat16 with a bf16 rule) or #5 (a 0-d
    scale on the card and a number seed) at one `SHARED_SHAPES` shape, the
    readout (M = 10) taught; ``(wrapper, positional args, keywords)``."""
    import torch
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.kernels.plasticity.quant import QuantConfig
    quant = mode == "int8"
    x, w, theta, v, tpre, tpost, teach = shared_inputs(gen, b, n, m, quant,
                                                       dev)
    kw = dict(teach=teach if m == 10 else None)
    if quant:
        kw.update(qcfg=QuantConfig(), seed=12345)
        args = (x, w, torch.tensor(1 / 32, device=dev), theta, v, tpre,
                tpost)
        return K.shared_step_q, args, kw
    args = (x, w, theta, v, tpre, tpost)
    if mode == "bfloat16":
        args = tuple(t.to(torch.bfloat16) for t in args)
    return K.shared_step, args, kw


def shared_step_launches(dev):
    """Each `SHARED_SHAPES` launch's plan (where the wrappers have
    ``shared_step_launch``) and the registers, spills and stack ptxas gave
    each kernel of ``csrc/shared_step.cu``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.plasticity import kernel as K
    out = {"launch": {}}
    if hasattr(K, "shared_step_launch"):
        for mode in SHARED_MODES:
            for label, b, n, m in SHARED_SHAPES:
                info = K.shared_step_launch(dev, b, n, m, True, kind=mode,
                                            theta_bf16=mode == "bfloat16")
                name = f"{mode} {label}"
                out["launch"][name] = info
                log(f"  launch {name}: " + ", ".join(
                    f"{k} {v}" for k, v in info.items()))
    usage = ptxas_usage(_build.build_all()["log"].get("shared_step.cu", ""))
    out["ptxas"] = {name: dict(registers=r, spill_store_bytes=st,
                               spill_load_bytes=ld, stack_bytes=sk)
                    for name, (r, st, ld, sk) in usage.items()}
    for name, (r, st, ld, sk) in usage.items():
        log(f"  ptxas {name}: {r} registers, spills {st} B stored / {ld} B "
            f"loaded, stack {sk} B")
    if not usage:
        log("  ptxas: no compiler log for shared_step.cu")
    return out


def time_shared_shapes(dev, modes=tuple(SHARED_MODES), results=None):
    """#4 (float32, bfloat16) and #5 per `SHARED_SHAPES` shape in each of
    ``modes``: the whole wrapper call by `device_ms` (L2 flushed), the
    kernel alone and the wrapper's other device ops by `profiled_ms`, the
    bound, and the time `torch.sum` takes to read w and the rule once from
    a flushed L2 (what the card's memory path gives a launch of this
    size).  With ``results`` (the full run), each row is also filed under
    its kernel's ``shapes`` and a call that runs any device op beside the
    kernel fails."""
    import torch
    gen = torch.Generator(dev).manual_seed(SEED + 17)
    out = {}
    for mode in modes:
        name = SHARED_MODES[mode]
        quant, eb = mode == "int8", 2 if mode == "bfloat16" else 4
        for label, b, n, m in SHARED_SHAPES:
            fn, args, kw = shared_shape_call(gen, mode, b, n, m, dev)
            call = lambda: fn(*args, **kw)
            ms = device_ms(call)
            kern, other, ops = profiled_ms(call, "write", "shared_step")
            # a yardstick of the memory path, not of the function: one cold
            # read of w and the rule by PyTorch's reductions
            w, theta = args[1], args[3 if quant else 2]
            read_ms = device_ms(lambda: (w.sum(), theta.sum()))
            b_ms, kind = bound(step_bytes(b, n, m, 1 if quant else eb,
                                          sb=eb, fleet=False, tb=eb),
                               n * m * (b * OPS_ROW + (OPS_UPD_Q if quant
                                                       else OPS_UPD_F32)))
            key = f"{mode} {label}"
            out[key] = dict(kernel=name, ms=ms, kernel_ms=kern,
                            other_ms=other, other_ops=ops, bound_ms=b_ms,
                            bound_by=kind, read_ms=read_ms)
            log(f"  {key:28s} {ms:.4f} ms a call: kernel "
                + ("not measured" if kern is None else
                   f"{kern:.4f} ms + {ops:.0f} other ops {other:.4f} ms")
                + f"; bound {b_ms:.4f} ms ({kind}); reading w and the rule "
                f"{read_ms:.4f} ms")
            if results is not None:
                require(ops in (None, 0),
                        f"{name} {label}: {ops} device ops beside the kernel")
                results[name].setdefault("shapes", {})[label] = out[key]
    return out


# (label, B, K, M): the forward-only baseline's two layers (784-1024-10) at
# the per-event B = 1 and a batch of 8
LIF_SHAPES = tuple((f"{k}->{m} B={b}", b, k, m) for k, m in
                   ((784, 1024), (1024, 10)) for b in (1, 8))
LIF_MODES = {"float32": "lif_forward", "bfloat16": "lif_forward_bf16"}
# each flush's device op, which the profiled splits leave out
FLUSH_OPS = {"write": "bitwise_not", "read": "sum_functor"}


def profiled_ms(fn, flush, kernel=None, calls=PROFILE_CALLS):
    """`torch.profiler` over ``calls`` calls of ``fn``, the L2 flushed
    before each (`flush_l2`; "write" by a bitwise not of the buffer, which
    no wrapper runs): ``(kernel ms a launch, other ops ms a call, other ops
    a call)`` for the kernel whose name holds ``kernel``, or with no
    ``kernel`` ``(every device op's ms a call, 0, 0)``; Nones where the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush_l2(flush)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            if flush == "write":
                _flush_buf[0].bitwise_not_()
            else:
                flush_l2(flush)
            fn()
        torch.cuda.synchronize()
    kern = other = 0.0
    n_kern = n_other = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.self_device_time_total <= 0 or FLUSH_OPS[flush] in e.key:
            continue
        if kernel is None or kernel in e.key:
            kern += e.self_device_time_total
            n_kern += e.count
        else:
            other += e.self_device_time_total
            n_other += e.count
    if n_kern == 0:
        return None, None, None
    if kernel is None:
        return kern / 1e3 / calls, 0.0, 0
    return kern / 1e3 / n_kern, other / 1e3 / n_kern, n_other / n_kern


def lif_shape_inputs(gen, b, k, m, dtype, dev):
    """x (30% events), w (unit-variance fan-in), v, trace of one shape."""
    import torch
    return ((torch.rand(b, k, generator=gen, device=dev) < 0.3).to(dtype),
            (torch.randn(k, m, generator=gen, device=dev)
             * k ** -0.5).to(dtype),
            (0.1 * torch.randn(b, m, generator=gen, device=dev)).to(dtype),
            torch.rand(b, m, generator=gen, device=dev).to(dtype))


def ms_text(t):
    return "not measured" if t is None else f"{t:.4f}"


def time_lif_shapes(dev, modes=tuple(LIF_MODES), results=None):
    """#6 per `LIF_SHAPES` shape in each of ``modes``: the whole wrapper
    call by `device_ms`, its latency as the caller sees it (`latency_ms`)
    and the kernel alone by `profiled_ms`, beside
    `torch.matmul` of the same product (the product only: less work than
    #6), each after a flush that writes the 1 GB buffer and after one that
    reads it; the plain version and the bound.  With ``results`` (the full
    run), each row is also filed under its kernel's ``shapes``, and a call
    that runs any device op beside the kernel fails."""
    import torch
    from repro_torch.kernels.lif import kernel as L
    gen = torch.Generator(dev).manual_seed(SEED + 19)
    out = {}
    for mode in modes:
        name = LIF_MODES[mode]
        dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
        eb = 2 if mode == "bfloat16" else 4
        for label, b, k, m in LIF_SHAPES:
            x, w, v, tr = lif_shape_inputs(gen, b, k, m, dt, dev)
            call = lambda: L.lif_forward(x, w, v, tr)
            mm = lambda: torch.matmul(x, w)
            b_ms, kind = bound(eb * (b * k + k * m + 5 * b * m),
                               2 * b * k * m + 5 * b * m)
            row = dict(kernel=name, bound_ms=b_ms, bound_by=kind,
                       plain_ms=device_ms(lambda: L.lif_forward_plain(
                           x, w, v, tr), reps=5))
            if mode == "bfloat16":      # the float32 twin, same inputs
                up = [t.float() for t in (x, w, v, tr)]
                row["f32_ms"] = device_ms(lambda: L.lif_forward(*up))
            for flush in ("write", "read"):
                kern, other, ops = profiled_ms(call, flush, "lif_forward")
                cols = dict(ms=device_ms(call, flush=flush), kernel_ms=kern,
                            matmul_ms=device_ms(mm, flush=flush),
                            matmul_kernel_ms=profiled_ms(mm, flush)[0])
                if flush == "write":
                    row.update(cols, other_ms=other, other_ops=ops)
                else:
                    row["read_flush"] = cols
            row["latency_ms"] = latency_ms(call)
            key = f"{mode} {label}"
            out[key] = row
            rd = row["read_flush"]
            log(f"  {key:27s} latency {row['latency_ms']:.4f} ms, call "
                f"{row['ms']:.4f} ms, kernel "
                f"{ms_text(row['kernel_ms'])} ms (+{row['other_ops']} other "
                f"ops), torch.matmul {row['matmul_ms']:.4f} / kernels "
                f"{ms_text(row['matmul_kernel_ms'])} ms; read flush: call "
                f"{rd['ms']:.4f}, kernel {ms_text(rd['kernel_ms'])}, "
                f"torch.matmul {rd['matmul_ms']:.4f} / "
                f"{ms_text(rd['matmul_kernel_ms'])} ms; plain "
                f"{row['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({kind})")
            if results is not None:
                require(row["other_ops"] in (None, 0),
                        f"{name} {label}: {row['other_ops']} device ops "
                        f"beside the kernel")
                results[name].setdefault("shapes", {})[label] = row
    return out


def lif_row(results, shapes, mode):
    """#6's row of the kernel table in ``mode``: the means of the two
    layers' rows at B = 1 (the forward-only baseline's per-event calls);
    the library call is `torch.matmul` of the same product, the product
    only."""
    rows = [shapes[f"{mode} {label}"] for label, b, _, _ in LIF_SHAPES
            if b == 1]
    cols = (("ms", "ms"), ("plain_ms", "plain_ms"),
            ("library_ms", "matmul_ms"), ("bound_ms", "bound_ms")) + (
        (("f32_ms", "f32_ms"),) if mode == "bfloat16" else ())
    results[LIF_MODES[mode]].update(
        {key: statistics.mean(r[col] for r in rows) for key, col in cols},
        bound_by="bytes",
        library_covers=f"the {mode} (B,K)x(K,M) product only")


def lif_forward_launches(dev):
    """Each `LIF_SHAPES` launch's plan (where the wrapper plans it) and the
    registers, spills and stack ptxas gave each kernel of
    ``csrc/lif_forward.cu``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif import kernel as L
    out = {"launch": {}}
    if hasattr(L, "lif_forward_launch"):
        for mode in LIF_MODES:
            for label, b, k, m in LIF_SHAPES:
                info = L.lif_forward_launch(dev, b, k, m, mode)
                name = f"{mode} {label}"
                out["launch"][name] = info
                log(f"  launch {name}: " + ", ".join(
                    f"{k} {v}" for k, v in info.items()))
    usage = ptxas_usage(_build.build_all()["log"].get("lif_forward.cu", ""))
    out["ptxas"] = {name: dict(registers=r, spill_store_bytes=st,
                               spill_load_bytes=ld, stack_bytes=sk)
                    for name, (r, st, ld, sk) in usage.items()}
    for name, (r, st, ld, sk) in usage.items():
        log(f"  ptxas {name}: {r} registers, spills {st} B stored / {ld} B "
            f"loaded, stack {sk} B")
    if not usage:
        log("  ptxas: no compiler log for lif_forward.cu")
    return out


def profile_forward_only(dev, steps=20):
    """Where the time goes over `steps` forward-only timesteps of the online
    learner (`forward_only_step` at B = 1: one `lif_forward` launch a
    layer), float32 and bfloat16, random weights (seeded) on one input's
    events, and one timestep's latency as Table II times it; any tree's
    wrappers alike."""
    import torch
    from repro_torch.core import snn
    gen = torch.Generator(dev).manual_seed(SEED + 20)
    out = {}
    for mode, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        cfg = dataclasses.replace(mnist_cfg(False), dtype=dt)
        sizes = cfg.layer_sizes
        w = tuple((torch.randn(n, m, generator=gen, device=dev)
                   * n ** -0.5).to(dt) for n, m in zip(sizes, sizes[1:]))
        net = [dataclasses.replace(snn.init_state(cfg, batch=1, device=dev),
                                   w=w)]
        xb = (torch.rand(1, sizes[0], generator=gen, device=dev)
              < 0.3).to(dt)

        def run():
            for _ in range(steps):
                net[0] = forward_only_step(cfg, net[0], xb)[0]
        run()
        log(f"  forward-only {mode}:")
        out[mode] = profile_window(run, steps)
        out[mode]["timestep_latency_ms"] = latency_ms(
            lambda: forward_only_step(cfg, net[0], xb))
        log(f"    one timestep's latency, host included: "
            f"{out[mode]['timestep_latency_ms']:.4f} ms")
    return out


# ---- phase 2f: the bfloat16 kernels against their plain versions -----------

BF16_TOL = 3e-2                 # JAX's own bf16 tolerance (tests/test_fleet.py)
BF16_SHARE = 1e-3               # windows: share of elements outside BF16_TOL
BF16_NAMES = ("fleet_step_bf16", "fleet_step_bf16_telemetry", "rollout_bf16",
              "rollout_bf16_telemetry", "rollout_shared_bf16",
              "shared_step_bf16", "lif_forward_bf16")


def bf16_ulp(t):
    """One bfloat16 step at each element's magnitude."""
    import torch
    a = t.double().abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 7), torch.full_like(a, 2e-40))


def bf16_diff(got, want):
    """Largest difference, the share of elements more than one bf16 step
    apart and the share outside BF16_TOL, over paired tensors."""
    import torch
    torch.cuda.synchronize()
    d = [(g.double() - h.double()).abs() for g, h in zip(got, want)]
    n = sum(x.numel() for x in d)
    return (max(float(x.max()) for x in d),
            sum(int((x > bf16_ulp(h)).sum()) for x, h in zip(d, want)) / n,
            sum(int((x > BF16_TOL).sum()) for x in d) / n)


def held_bf16(name, got, want, results, what, windowed=False):
    """A bf16 launch against its plain version: bfloat16 outputs, and every
    element within BF16_TOL (a step or a one-step window) or at most
    BF16_SHARE of them outside it (a longer window); the largest
    difference and the share beyond one bf16 step are printed."""
    import torch
    require(all(g.dtype == torch.bfloat16 for g in got),
            f"{name} {what}: outputs are not bfloat16")
    err, ulp_share, tol_share = bf16_diff(got, want)
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    if windowed:
        require(tol_share <= BF16_SHARE,
                f"{name} {what}: {tol_share:.2e} of elements outside "
                f"{BF16_TOL} (limit {BF16_SHARE})")
    else:
        require(err <= BF16_TOL, f"{name} {what}: max err {err} > {BF16_TOL}")
    log(f"  {name:25s} {what}: max |err| {err:.3g}, share beyond one bf16 "
        f"step {ulp_share:.2e}, outside {BF16_TOL} {tol_share:.2e}")
    return err


def held_row(name, got, want, results, what, tol):
    """A telemetry row (float32) within ``tol`` relative to the plain
    version's, elementwise (atol = tol)."""
    err = float(((got.double() - want.double()).abs()
                 / (1 + want.double().abs())).max())
    results[name]["max_abs_err"] = max(
        results[name]["max_abs_err"],
        float((got.double() - want.double()).abs().max()))
    require(err <= tol, f"{name} {what}: row err {err} > {tol} relative")
    log(f"  {name:25s} {what}: row max relative err {err:.3g}")


def bf16_fleet_inputs(gen, b, n, m, dev, theta_bf16=True):
    """`rand_fleet_inputs` in bfloat16 (grid-valued weights and spike
    events stay exact), the rule in bfloat16 or float32."""
    import torch
    x, w, theta, v, tpre, tpost = rand_fleet_inputs(gen, b, n, m, False, dev)
    bf = torch.bfloat16
    return (x.to(bf), w.to(bf), theta.to(bf) if theta_bf16 else theta,
            v.to(bf), tpre.to(bf), tpost.to(bf))


def compare_bf16_steps(dev, results):
    """#1 (with and without telemetry), #4 and #6 in bfloat16 against their
    plain versions on the card."""
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.kernels.lif import kernel as L
    from repro_torch.kernels.plasticity import kernel as K
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    bf = torch.bfloat16
    for b, n, m, spiking, theta_bf16 in ((B, 8, 128, True, True),
                                         (B, 128, 8, False, True),
                                         (B, 17, 257, True, False),
                                         (4, 128, 128, True, True),
                                         (4, 128, 128, True, False)):
        for extras in (False, True):
            args = bf16_fleet_inputs(gen, b, n, m, dev, theta_bf16)
            kw = dict(spiking=spiking)
            if extras:
                act = torch.rand(b, generator=gen, device=dev) < 0.7
                act[0] = False
                kw.update(active=act,
                          teach=(0.5 * torch.randn(b, m, generator=gen,
                                                   device=dev)).to(bf))
            what = (f"B={b} N={n} M={m} "
                    f"theta={'bf16' if theta_bf16 else 'f32'} "
                    f"{'mask+teach' if extras else 'all, no teach'}")
            off = K.fleet_step(*args, **kw)
            held_bf16("fleet_step_bf16", off, K.fleet_step_plain(*args, **kw),
                      results, what)
            got = K.fleet_step(*args, telemetry=True, **kw)
            want = K.fleet_step_plain(*args, telemetry=True, **kw)
            torch.cuda.synchronize()
            require(all(torch.equal(g, o) for g, o in zip(got[:4], off)),
                    f"fleet_step_bf16_telemetry {what}: state differs from "
                    f"the telemetry-off launch")
            held_row("fleet_step_bf16_telemetry", got[4], want[4], results,
                     what + " (state = telemetry-off launch bit for bit)",
                     BF16_TOL)
            if extras:
                act = kw["active"]
                require(torch.equal(got[3][~act], args[1][~act])
                        and torch.equal(got[1][~act], args[3][~act])
                        and not got[0][~act].any()
                        and not got[4][~act].any(),
                        f"fleet_step_bf16 {what}: inactive slots not frozen")
    sizes = firefly_snn.MNIST.layer_sizes
    for i, (n, m) in enumerate(zip(sizes[:-1], sizes[1:])):
        for theta_bf16 in (True, False):
            x, w, theta, v, tpre, tpost, teach = shared_inputs(
                gen, 1, n, m, False, dev)
            args = (x.to(bf), w.to(bf), theta.to(bf) if theta_bf16
                    else theta, v.to(bf), tpre.to(bf), tpost.to(bf))
            kw = dict(teach=teach.to(bf) if i == 1 else None)
            held_bf16("shared_step_bf16", K.shared_step(*args, **kw),
                      K.shared_step_plain(*args, **kw), results,
                      f"{n}->{m} B=1 theta={'bf16' if theta_bf16 else 'f32'}"
                      f" teach={i == 1}")
        for b in (1, 8):
            xl = (torch.rand(b, n, generator=gen, device=dev) < 0.5).to(bf)
            wl = (torch.round(torch.randn(n, m, generator=gen, device=dev)
                              * 8) / 64).to(bf)
            vl = (0.1 * torch.randn(b, m, generator=gen, device=dev)).to(bf)
            tl = torch.rand(b, m, generator=gen, device=dev).to(bf)
            held_bf16("lif_forward_bf16", L.lif_forward(xl, wl, vl, tl),
                      L.lif_forward_plain(xl, wl, vl, tl), results,
                      f"B={b} K={n} M={m}")


def bf16_controller_cfg():
    """`firefly_snn.CONFIG` (8-128-8, T = 4) in bfloat16."""
    import torch
    from repro_torch.configs import firefly_snn
    return dataclasses.replace(firefly_snn.CONFIG, dtype=torch.bfloat16)


def bf16_net_inputs(gen, cfg, k, dev):
    """`net_inputs` in bfloat16: grid-valued weights and drives."""
    st, theta, drives = net_inputs(gen, cfg, k, dev)
    return (dataclasses.replace(st, w=tuple(w.to(cfg.dtype) for w in st.w)),
            theta, drives.to(cfg.dtype))


def compare_bf16_windows(dev, results):
    """#3 fleet (with and without telemetry) at 8-128-8, B = 4096, 90% of
    the slots active, and #3 shared at 784-1024-10, B = 1, in bfloat16."""
    import torch
    from repro_torch.core import engine, snn
    from repro_torch.kernels.plasticity import fused
    gen = torch.Generator(dev).manual_seed(SEED + 12)
    cfg = bf16_controller_cfg()
    params = [cfg.engine_params(i) for i in range(cfg.num_layers)]
    flat = lambda r: [r[1], *r[0].w, *r[0].v, *r[0].trace]
    for k in (1, 4, 32):
        st, theta, drives = bf16_net_inputs(gen, cfg, k, dev)
        active = torch.rand(B, generator=gen, device=dev) < 0.9
        got = engine.rollout(st, theta, drives, params=params, active=active,
                             block_b=cfg.block_b)
        with mock.patch.object(fused, "rollout", plain_rollout):
            want = engine.rollout(st, theta, drives, params=params,
                                  active=active, block_b=cfg.block_b)
        if k <= 4:
            held_bf16("rollout_bf16", flat(got), flat(want), results,
                      f"K={k}", windowed=k > 1)
        else:
            err, ulp_share, tol_share = bf16_diff(flat(got), flat(want))
            log(f"  {'rollout_bf16':25s} K={k}: max |err| {err:.3g}, share "
                f"beyond one bf16 step {ulp_share:.2e}, outside {BF16_TOL} "
                f"{tol_share:.2e} (not gated)")
        for a, c in zip(got[0].w + got[0].v, st.w + st.v):
            require(torch.equal(a[~active], c[~active]),
                    f"rollout_bf16 K={k}: inactive slots not frozen")
    active = torch.rand(B, generator=gen, device=dev) < 0.75
    for k in (4, 16):
        st, theta, drives = bf16_net_inputs(gen, cfg, k, dev)
        teach = (0.5 * torch.randn(B, cfg.layer_sizes[-1], generator=gen,
                                   device=dev)).to(cfg.dtype)
        kw = dict(params=params, teach=teach, active=active,
                  block_b=cfg.block_b)
        got = engine.rollout(st, theta, drives, telemetry=True, **kw)
        off = engine.rollout(st, theta, drives, **kw)
        with mock.patch.object(fused, "rollout", plain_rollout):
            want = engine.rollout(st, theta, drives, telemetry=True, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(flat(got), flat(off))),
                f"rollout_bf16_telemetry K={k}: state differs from the "
                f"telemetry-off launch")
        rows = lambda r: torch.stack([getattr(r[2], f) for f in TEL_FIELDS],
                                     1)
        held_row("rollout_bf16_telemetry", rows(got), rows(want), results,
                 f"K={k} (state = telemetry-off launch bit for bit)",
                 TEL_TOL)
        require(not rows(got)[~active, :3].any(),
                f"rollout_bf16_telemetry K={k}: a vacant slot reports "
                f"telemetry")
    mcfg = dataclasses.replace(mnist_cfg(False), dtype=torch.bfloat16)
    sizes = mcfg.layer_sizes
    mparams = [mcfg.engine_params(i) for i in range(mcfg.num_layers)]
    for k in (1, 8):
        st = snn.init_state(mcfg, device=dev)
        w = tuple((torch.round((torch.rand(
            sizes[i], sizes[i + 1], generator=gen, device=dev) * 2 - 1) * 16)
            / 64).to(mcfg.dtype) for i in range(mcfg.num_layers))
        tr = tuple((torch.rand(n, generator=gen, device=dev) * 2)
                   .to(mcfg.dtype) for n in sizes)
        st = dataclasses.replace(st, w=w, trace=tr)
        drives = (torch.rand(k, sizes[0], generator=gen, device=dev)
                  < 0.3).to(mcfg.dtype)
        teach = (0.5 * torch.randn(sizes[-1], generator=gen, device=dev)
                 ).to(mcfg.dtype)
        theta = snn.init_theta(mcfg, gen, scale=0.02)
        got = engine.rollout(st, theta, drives, params=mparams, teach=teach)
        with mock.patch.object(fused, "rollout", plain_rollout):
            want = engine.rollout(st, theta, drives, params=mparams,
                                  teach=teach)
        if k == 1:
            held_bf16("rollout_shared_bf16", flat(got), flat(want), results,
                      "784-1024-10 K=1")
        else:
            err, ulp_share, tol_share = bf16_diff(flat(got), flat(want))
            log(f"  {'rollout_shared_bf16':25s} 784-1024-10 K={k}: max |err|"
                f" {err:.3g}, share beyond one bf16 step {ulp_share:.2e}, "
                f"outside {BF16_TOL} {tol_share:.2e} (not gated)")


# ---- phase 4f and 6f: the controller and online paths in bfloat16 -----------

def bf16_counters_zero(counters):
    for c in counters:
        c.launches = c.bf16_launches = 0
        if hasattr(c, "telemetry_launches"):
            c.telemetry_launches = 0


def bf16_counts(counters, what):
    """Read the counters of a bf16 path: every launch there is bfloat16,
    and each kernel, and each telemetry variant where there is one, was
    launched."""
    counts = {}
    for c in counters:
        require(c.bf16_launches == c.launches,
                f"kernel {c.__name__}: {c.launches - c.bf16_launches} of "
                f"{c.launches} launches on the {what} not bfloat16")
        tel = getattr(c, "telemetry_launches", 0)
        counts[c.__name__ + "_bf16"] = c.bf16_launches - tel
        if hasattr(c, "telemetry_launches"):
            counts[c.__name__ + "_bf16_telemetry"] = tel
    log(f"  bf16 launches on the {what}: {json.dumps(counts)}")
    for name, n in counts.items():
        require(n > 0, f"kernel {name} was not launched on the {what}")
    return counts


def bf16_paths_held(what, kern, plain, fused_kern, fused_plain):
    """A bf16 per-event run and a fused window from the same state, each
    against the same run through the plain versions (at most BF16_SHARE of
    the elements outside BF16_TOL: several dependent steps); the
    per-event run against the window is printed, not gated.  The
    per-event path rounds to bfloat16 every step (lam too, as JAX's xla
    and pallas per-step paths do), the window carries float32 across it
    (as JAX's rollout kernel does): two contracts, whose spread spikes
    turn into whole-event differences at full width."""
    out = {}
    for name, a, c in (("per-event path", kern, plain),
                       ("fused window", fused_kern, fused_plain),
                       ("per-event vs fused", kern, fused_kern)):
        err, ulp_share, tol_share = bf16_diff(a, c)
        gated = name != "per-event vs fused"
        log(f"  {what} {name}{' against plain' if gated else ''}: max |diff|"
            f" {err:.3g}, share beyond one bf16 step {ulp_share:.2e}, "
            f"outside {BF16_TOL} {tol_share:.2e}"
            + ("" if gated else " (two contracts; not gated)"))
        if gated:
            require(tol_share <= BF16_SHARE,
                    f"{what} {name}: {tol_share:.2e} of elements outside "
                    f"{BF16_TOL} against the plain versions")
        out[name] = dict(max_diff=err, share_beyond_one_step=ulp_share,
                         share_outside_tol=tol_share)
    return out


def bf16_controller_path(dev, main, counters):
    """The 8-128-8 controller in bfloat16 for B = 4096 streams on
    `direction`: the closed loop (one bf16 rollout launch per control
    step), then one control window per event (`snn.timestep`, one bf16
    fleet-step launch per layer per timestep, with and without telemetry)
    and fused (with and without telemetry), each against the plain
    versions.  Every counter of the path is set to 0 first and read
    after."""
    import torch
    from repro_torch import envs, scenarios as S
    from repro_torch.core import snn
    env = envs.make("direction", episode_len=STEPS)
    cfg = bf16_controller_cfg()
    theta = snn.init_theta(cfg, torch.Generator(dev).manual_seed(SEED),
                           scale=0.01)
    prog = S.make_closed_loop(env, cfg, batch=B, steps=STEPS)
    bf16_counters_zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = prog.run(theta, SEED, tasks="train", device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r, a = res.rewards, res.actions
    require(tuple(r.shape) == (STEPS, B) and torch.isfinite(r).all()
            and torch.isfinite(a.float()).all() and (a.abs() <= 1).all()
            and a.dtype == torch.bfloat16,
            "closed loop bf16: bad rewards or actions")
    rate = STEPS * B / dt
    f32 = main["float32"]
    log(f"  closed loop bf16: {STEPS} steps x {B} controllers in {dt:.3f} s "
        f"= {rate:.4g} control-steps/s, mean reward {float(r.mean()):.4f} "
        f"(float32: {f32['rate']:.4g} control-steps/s, mean reward "
        f"{float(f32['result'].rewards.mean()):.4f})")
    from repro_torch.kernels.plasticity import fused, kernel as K
    drive = snn.encode(cfg, prog.venv.observe(res.env_state))
    drives = drive[None].expand(cfg.timesteps, *drive.shape)
    flat = lambda n: n.w + n.v + n.trace

    def per_event(telemetry=False):
        net = res.net
        for _ in range(cfg.timesteps):
            net = snn.timestep(cfg, net, theta, drive,
                               telemetry=telemetry)[0]
        return flat(net)

    window = lambda telemetry=False: flat(snn.rollout_window(
        cfg, res.net, theta, drives, telemetry=telemetry)[0])
    kern, kern_tel, fused_kern, fused_tel = (per_event(), per_event(True),
                                             window(), window(True))
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(kern_tel, kern))
            and all(torch.equal(a, c) for a, c in zip(fused_tel, fused_kern)),
            "bf16 telemetry launches on the controller path give other state"
            " than their telemetry-off twins")
    counts = bf16_counts(counters, "bf16 controller path")
    with mock.patch.object(K, "fleet_step", K.fleet_step_plain), \
            mock.patch.object(fused, "rollout", plain_rollout):
        plain, fused_plain = per_event(), window()
    held = bf16_paths_held("control window", kern, plain, fused_kern,
                           fused_plain)
    log("  where the bf16 closed loop's time goes (20 control steps):")
    short = dataclasses.replace(prog, steps=20)
    short.run(theta, SEED, tasks="train", device=dev)          # warm
    profile = profile_window(
        lambda: short.run(theta, SEED, tasks="train", device=dev), 20)
    return dict(rate=rate, seconds=dt, mean_reward=float(r.mean()),
                windows=held, launches=counts, profile=profile)


def bf16_recovery_gate(dev):
    """The recovery gate's two scenarios with bfloat16 controllers, printed
    and not gated (the JAX package makes no bf16 recovery claim)."""
    import torch
    from repro_torch import scenarios as S
    out = {}
    for name in S.GATE_SCENARIOS:
        spec = S.SCENARIOS[name]
        env = spec.make_env()
        scfg = dataclasses.replace(S.controller_config(env),
                                   dtype=torch.bfloat16)
        theta = S.reference_rule(spec.env_name, scfg)
        prog = S.make_closed_loop(env, scfg, batch=spec.batch,
                                  steps=spec.steps)
        sched = S.compile_schedule(
            env, spec.perturbations,
            torch.Generator(dev).manual_seed(123), spec.batch)
        rp = prog.run(theta, 7, tasks=spec.tasks, schedule=sched, device=dev)
        rf = prog.run(theta, 7, tasks=spec.tasks, schedule=sched,
                      freeze_at=spec.onset, device=dev)
        mp = S.adaptation_metrics(rp.rewards, spec.onset, spec.window)
        mf = S.adaptation_metrics(rf.rewards, spec.onset, spec.window)
        passed = (mp["drop"] >= 0.02 and mp["recovery_frac"] >= 0.5
                  and mf["recovery_frac"] <= 0.25
                  and mp["time_to_recover"] > 0)
        log(f"  {name:16s} bf16   : drop {mp['drop']:.4f}, plastic recovers "
            f"{mp['recovery_frac']:.3f} (ttr {mp['time_to_recover']}), "
            f"frozen {mf['recovery_frac']:.3f}; float32's gate would "
            f"{'pass' if passed else 'fail'} (printed, not gated)")
        out[name] = dict(plastic=mp, frozen=mf, would_pass=passed)
    return out


def bf16_online_path(dev, online, counters):
    """`firefly_snn.MNIST` (784-1024-10, T = 8, B = 1) in bfloat16 on the
    120 digits: the predict-then-learn stream (one bf16 shared-weight
    rollout launch per window), one digit per event (bf16 shared-step
    launches) and the Table II forward-only baseline (bf16 `lif_forward`
    launches).  Every counter of the path is set to 0 first and read
    after."""
    import torch
    from repro_torch.core import snn
    imgs, labels, spikes = online["data"]
    cfg = dataclasses.replace(mnist_cfg(False), dtype=torch.bfloat16)
    theta = [t.to(cfg.dtype) for t in mnist_rule(cfg, dev)]
    bf16_counters_zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, preds = online_stream(cfg, theta, imgs, labels)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    warm = MNIST_DIGITS // 5
    acc = float((preds[warm:] == labels[warm:]).float().mean())
    require(all(w.dtype == torch.bfloat16 and torch.isfinite(w.float()).all()
                and float(w.abs().max()) <= cfg.w_clip for w in state.w),
            "bf16 online stream: weights not bfloat16, not finite or outside"
            " w_clip")
    require(float(sum(w.float().abs().sum() for w in state.w)) > 0,
            "bf16 online stream: no synapse grew")
    f32 = online["float32"]
    log(f"  online stream bf16: {MNIST_DIGITS} digits in {dt:.3f} s = "
        f"{MNIST_DIGITS / dt:.1f} digits/s, accuracy {acc:.3f} (float32: "
        f"{f32['digits_per_s']:.1f} digits/s, accuracy {f32['acc']:.3f})")
    from repro_torch.kernels.plasticity import fused, kernel as K
    x = imgs[0]
    teach = TEACH * torch.nn.functional.one_hot(
        labels[0], cfg.layer_sizes[-1]).float()
    flat = lambda n: (*n.w, *n.v, *n.trace)

    def per_event():
        ev = state
        for _ in range(cfg.timesteps):
            ev, _ = snn.timestep(cfg, ev, theta, x.to(cfg.dtype),
                                 teach=teach)
        return flat(ev)

    window = lambda: flat(snn.classify_window(cfg, state, theta, x,
                                              teach=teach)[0])
    kern, fused_kern = per_event(), window()
    with mock.patch.object(K, "shared_step", K.shared_step_plain), \
            mock.patch.object(fused, "rollout", plain_rollout):
        plain, fused_plain = per_event(), window()
    held = bf16_paths_held("digit", kern, plain, fused_kern, fused_plain)
    bs, xb = batched(state), spikes[0][None].to(cfg.dtype)
    fused_state, f_out = snn.timestep(cfg, bs, theta, xb)
    fwd, o_out = forward_only_step(cfg, bs, xb)
    err_f, _, tol_f = bf16_diff((*fwd.v, *fwd.trace[1:], o_out),
                                (*fused_state.v, *fused_state.trace[1:],
                                 f_out))
    log(f"  forward-only baseline (bf16 lif_forward) against the fused "
        f"timestep's forward half: max |diff| {err_f:.3g}, outside "
        f"{BF16_TOL} {tol_f:.2e}")
    require(err_f <= BF16_TOL, f"bf16 forward-only baseline differs from the"
            f" fused timestep by {err_f} > {BF16_TOL}")
    counts = bf16_counts(counters, "bf16 online path")
    log("  where the bf16 online stream's time goes (10 digits):")
    profile = profile_window(lambda: online_stream(
        cfg, theta, imgs[:10], labels[:10]), 10)
    return dict(digits_per_s=MNIST_DIGITS / dt, seconds=dt, accuracy=acc,
                windows=held, launches=counts, profile=profile)


# ---- phase 7f: the bfloat16 kernels' times -------------------------------------

def time_bf16_kernels(dev, results):
    """Each bf16 kernel at its path's shapes, L2 flushed, beside its float32
    twin (timed in this call, same inputs rounded), its plain version and,
    for #6, a bf16 `torch.matmul` of the product (#6 per layer shape,
    `time_lif_shapes`)."""
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.kernels.plasticity import fused, kernel as K
    gen = torch.Generator(dev).manual_seed(SEED + 13)
    bf = torch.bfloat16
    up = lambda ts: [None if t is None else t.float() for t in ts]
    sizes = firefly_snn.CONFIG.layer_sizes
    active = torch.rand(B, generator=gen, device=dev) < 0.75
    for name, tel in (("fleet_step_bf16", False),
                      ("fleet_step_bf16_telemetry", True)):
        ms, f32_ms, pms, bms = [], [], [], []
        for i in range(len(sizes) - 1):
            n, m = sizes[i], sizes[i + 1]
            args = bf16_fleet_inputs(gen, B, n, m, dev)
            args32 = up(args)
            kw = dict(spiking=i < len(sizes) - 2, telemetry=tel,
                      active=active if tel else None)
            ms.append(device_ms(lambda: K.fleet_step(*args, **kw)))
            f32_ms.append(device_ms(lambda: K.fleet_step(*args32, **kw)))
            pms.append(device_ms(lambda: K.fleet_step_plain(*args, **kw),
                                 reps=5))
            ops = B * n * m * (OPS_F32 + (OPS_TEL_SYN if tel else 0)) \
                + (B * m * OPS_TEL_COL if tel else 0)
            bms.append(bound(step_bytes(B, n, m, 2, sb=2, tb=2)
                             + (B * 3 * 4 if tel else 0), ops)[0])
        results[name].update(ms=statistics.mean(ms),
                             f32_ms=statistics.mean(f32_ms),
                             plain_ms=statistics.mean(pms),
                             bound_ms=statistics.mean(bms), bound_by="bytes")
    cfg = bf16_controller_cfg()
    k = cfg.timesteps
    syn = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    for name, tel in (("rollout_bf16", False),
                      ("rollout_bf16_telemetry", True)):
        st, theta, drives = bf16_net_inputs(gen, cfg, k, dev)
        kw = dict(spiking=[cfg.engine_params(i).spiking for i in range(2)],
                  plastic=[True, True], tau_m=cfg.lif.tau_m,
                  trace_decay=cfg.trace_decay, w_clip=cfg.w_clip,
                  active=active if tel else None, telemetry=tel)
        args = (drives, st.w, theta, st.v, st.trace)
        args32 = (drives.float(), up(st.w), up(theta), up(st.v),
                  up(st.trace))
        ops = k * B * syn * OPS_F32 + ((k * B * sum(sizes[1:]) * OPS_TEL_COL
                                        + B * syn * OPS_TEL_SYN) if tel
                                       else 0)
        b_ms, kind = bound(window_bytes(B, sizes, k, 2, sb=2, tb=2)
                           + (B * 3 * 4 if tel else 0), ops)
        results[name].update(
            ms=device_ms(lambda: fused.rollout(*args, block_b=cfg.block_b,
                                               **kw)),
            f32_ms=device_ms(lambda: fused.rollout(
                *args32, block_b=cfg.block_b, **kw)),
            plain_ms=device_ms(lambda: fused.rollout_plain(*args, **kw),
                               reps=5),
            bound_ms=b_ms, bound_by=kind)
    msizes = mnist_cfg(False).layer_sizes
    layers = [(msizes[i], msizes[i + 1]) for i in range(len(msizes) - 1)]
    ms, f32_ms, pms, bms = [], [], [], []
    for n, m in layers:
        x, w, theta, v, tpre, tpost, _ = shared_inputs(gen, 1, n, m, False,
                                                       dev)
        args = tuple(t.to(bf) for t in (x, w, theta, v, tpre, tpost))
        args32 = up(args)
        ms.append(device_ms(lambda: K.shared_step(*args)))
        f32_ms.append(device_ms(lambda: K.shared_step(*args32)))
        pms.append(device_ms(lambda: K.shared_step_plain(*args), reps=5))
        bms.append(bound(step_bytes(1, n, m, 2, sb=2, fleet=False, tb=2),
                         n * m * (OPS_ROW + OPS_UPD_F32))[0])
    results["shared_step_bf16"].update(
        ms=statistics.mean(ms), f32_ms=statistics.mean(f32_ms),
        plain_ms=statistics.mean(pms), bound_ms=statistics.mean(bms),
        bound_by="bytes")
    mcfg = dataclasses.replace(mnist_cfg(False), dtype=bf)
    k = mcfg.timesteps
    msyn = sum(n * m for n, m in layers)
    w = tuple((torch.round((torch.rand(n, m, generator=gen, device=dev) * 2
                            - 1) * 16) / 64).to(bf) for n, m in layers)
    drives = (torch.rand(k, 1, msizes[0], generator=gen, device=dev)
              < 0.3).to(bf)
    from repro_torch.core import snn
    st = dataclasses.replace(snn.init_state(mcfg, batch=1, device=dev), w=w)
    theta = snn.init_theta(mcfg, gen, scale=0.02)
    kw = dict(spiking=[True, True], plastic=[True, True],
              tau_m=mcfg.lif.tau_m, trace_decay=mcfg.trace_decay,
              w_clip=mcfg.w_clip)
    args = (drives, st.w, theta, st.v, st.trace)
    args32 = (drives.float(), up(st.w), up(theta), up(st.v), up(st.trace))
    b_ms, kind = bound(window_bytes(1, msizes, k, 2, sb=2, fleet=False, tb=2),
                       k * msyn * (OPS_ROW + OPS_UPD_F32))
    results["rollout_shared_bf16"].update(
        ms=device_ms(lambda: fused.rollout_shared(*args, **kw)),
        f32_ms=device_ms(lambda: fused.rollout_shared(*args32, **kw)),
        plain_ms=device_ms(lambda: fused.rollout_plain(*args, **kw), reps=5),
        bound_ms=b_ms, bound_by=kind)
    lif_row(results, time_lif_shapes(dev, ("bfloat16",), results),
            "bfloat16")
    for name in BF16_NAMES:
        r = results[name]
        log(f"  {name:25s} {r['ms']:.4f} ms beside float32 "
            f"{r['f32_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}"
            + (f", bf16 torch.matmul {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else ""))


# ---- phase 10: session serving of the controller fleet at full width --------

POPULATION = 2 * B              # users who come and go
SERVE_WINDOWS = 8               # control windows under churn
SERVE_STEPS = 16                # per-event telemetry steps after them
DEPART_P = 0.02                 # per resident and window
PROBE_CUT = 4                   # the window before which the probe moves
VACANT = 256                    # slots left empty for the frozen check
TAIL_WINDOWS = 4                # windows of the frozen check
SERVE_PROFILED = 2              # windows under churn after it, profiled


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
    # SERVE_PROFILED more windows under churn, profiled in the main run
    tail = lambda: [run.call("window") for _ in range(SERVE_PROFILED)]
    if profile is not None:
        out["profile"] = profile(tail, SERVE_PROFILED)
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


# ---- phase 12: the rule search (PEPG, Phase 1) and Phase 2 at 11-128-2 ------

SEARCH_ENV = "position"          # the paper's third task (Brax `ur5e`)
SEARCH_GENERATIONS = 2           # of the paper's 60: the script's limit
SEARCH_SIZES = (11, 128, 2)      # position's observation, 128 hidden, torques
SEARCH_DEAD_FROM = 50            # Phase 2 stress: actuator 0 dead from here


def search_window_inputs(gen, b, k, quant, plastic, dev):
    """A random 11-128-2 fleet state of ``b`` streams, its rules (None where
    no layer is plastic) and a drive window; float weights and drives on a
    grid (exact psums at the first step)."""
    import torch
    from repro_torch.core import snn
    from repro_torch.kernels.plasticity import quant as Q
    cfg = snn.SNNConfig(layer_sizes=SEARCH_SIZES, plastic=plastic)
    cfg = snn.quant_config(cfg) if quant else cfg
    st = snn.init_state(cfg, batch=b, fleet=True, device=dev)
    sizes = SEARCH_SIZES
    if quant:
        w = tuple(torch.randint(-40, 41, (b, sizes[i], sizes[i + 1]),
                                generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
                  for i in range(2))
        st = dataclasses.replace(st, w=w)
        drives = Q.to_fixed(torch.round(torch.randn(
            k, b, sizes[0], generator=gen, device=dev) * 16) / 16, cfg.quant)
    else:
        w = tuple(torch.round((torch.rand(b, sizes[i], sizes[i + 1],
                                          generator=gen, device=dev) * 2 - 1)
                              * 32) / 64 for i in range(2))
        st = dataclasses.replace(st, w=w)
        drives = torch.round(torch.randn(k, b, sizes[0], generator=gen,
                                         device=dev) * 16) / 16
    theta = (snn.init_theta(cfg, gen, scale=0.02) if plastic
             else [None, None])
    return cfg, st, theta, drives


def search_kernel_checks(dev, results):
    """#3 fleet at the rule search's shapes against its plain version: B = 8
    (a candidate's train tasks), 72 (the eval tasks) and 384 (the
    weight-trained population), every layer plastic or none; int8 bit for
    bit at K = 4, float32 within 1e-5 at K = 1 and, at B = 8, K = 4.  Then
    its time at B = 8 (plastic) and B = 384 (no rule) beside its plain
    version and its bound."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.plasticity import fused
    gen = torch.Generator(dev).manual_seed(SEED + 25)
    err = 0.0
    for quant in (False, True):
        for plastic in (True, False):
            cases = [(b, 4 if quant else 1) for b in (8, 72, 384)]
            cases += [] if quant else [(8, 4)]
            for b, k in cases:
                plan = fused.fleet_launch(dev, SEARCH_SIZES, b, 8,
                                          (plastic, plastic), quant=quant)
                require(plan["ctas"] == -(-b // 8),
                        f"11-128-2 B = {b}: plan {plan}")
                cfg, st, theta, drives = search_window_inputs(
                    gen, b, k, quant, plastic, dev)
                params = [cfg.engine_params(i) for i in range(2)]
                got = engine.rollout(st, theta, drives, params=params,
                                     block_b=8)
                with mock.patch.object(fused, "rollout", plain_rollout):
                    want = engine.rollout(st, theta, drives, params=params,
                                          block_b=8)
                g = [got[1], *got[0].w, *got[0].v, *got[0].trace]
                h = [want[1], *want[0].w, *want[0].v, *want[0].trace]
                e, _ = drift(g, h)
                err = max(err, e)
                what = (f"rollout 11-128-2 {'int8' if quant else 'float32'} "
                        f"{'plastic' if plastic else 'no rule'} B={b} K={k}")
                if quant:
                    require(all(torch.equal(a, c) for a, c in zip(g, h)),
                            f"{what}: not bitwise equal to plain")
                else:
                    require(all(torch.allclose(a, c, rtol=1e-5, atol=1e-5)
                                for a, c in zip(g, h)),
                            f"{what}: max err {e} > 1e-5")
                if not plastic:
                    require(all(torch.equal(a, c) for a, c in
                                zip(got[0].w, st.w)),
                            f"{what}: weights moved without a rule")
                log(f"  {what}: {plan['ctas']} CTAs, max |err| {e:.3g}")
    results["rollout"]["max_abs_err"] = max(
        results["rollout"]["max_abs_err"], err)
    timed = {}
    syn = sum(SEARCH_SIZES[i] * SEARCH_SIZES[i + 1] for i in range(2))
    for label, b, plastic in (("plastic B=8", 8, True),
                              ("no rule B=384", 384, False)):
        k = 4
        cfg, st, theta, drives = search_window_inputs(gen, b, k, False,
                                                      plastic, dev)
        kw = dict(spiking=[True, False], plastic=[plastic] * 2,
                  trace_decay=cfg.trace_decay, w_clip=cfg.w_clip)
        run = lambda: fused.rollout(drives, st.w, theta, st.v, st.trace,
                                    block_b=8, **kw)
        plain = lambda: fused.rollout_plain(drives, st.w, theta, st.v,
                                            st.trace, **kw)
        # no rule: nothing of theta read, 2 operations a synapse (psum)
        nbytes = window_bytes(b, SEARCH_SIZES, k, 4, tb=4 if plastic else 0)
        b_ms, kind = bound(nbytes, k * b * syn * (OPS_F32 if plastic else 2))
        timed[label] = dict(ms=device_ms(run), plain_ms=device_ms(plain,
                                                                  reps=5),
                            bound_ms=b_ms, bound_by=kind)
        log(f"  rollout 11-128-2 {label}, K = 4: "
            f"{timed[label]['ms']:.4f} ms (plain "
            f"{timed[label]['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
            f"{kind})")
    return {"max_abs_err": err, "timed": timed}


def search_held_against_plain(dev, env, cfg, scfg, wcfg):
    """Re-score 4 candidates of the plastic search's first generation (two
    antithetic pairs) and one weight-trained candidate through the plain
    rollout, from the same resets: per-step rewards within 1e-4 over the
    first 20 control steps; the largest fitness difference over the whole
    episode is printed."""
    import torch
    from repro_torch.core import adaptation as A, es, snn
    from repro_torch.kernels.plasticity import fused
    tasks = env.train_tasks()
    out = {}
    for label, c, n in (("plastic", scfg, snn.theta_size(scfg)),
                        ("weight-trained", wcfg, A.weight_size(wcfg))):
        pcfg = es.PEPGConfig(num_params=n, pop_pairs=cfg.pop_pairs,
                             sigma_init=cfg.theta_scale)
        gen = torch.Generator(dev).manual_seed(cfg.seed)
        pop, _ = es.ask(pcfg, es.init(pcfg, gen), gen)
        seeds = A.candidate_seeds(es.fold_seed(cfg.seed, 0), pop.shape[0])
        p = cfg.pop_pairs
        pick = [0, 1, p, p + 1] if label == "plastic" else [0]
        args = (env, c, pop[pick], tasks, [seeds[i] for i in pick])
        got = A.population_rewards(*args)
        with mock.patch.object(fused, "rollout", plain_rollout):
            want = A.population_rewards(*args)
        torch.cuda.synchronize()
        by_step = (got - want).abs().flatten(1).max(dim=1).values.tolist()
        first = max(by_step[:20])
        fit = float((got.sum(0).mean(-1) - want.sum(0).mean(-1)).abs().max())
        split = next((t for t, d in enumerate(by_step) if d > 1e-3), None)
        log(f"  {label}: candidates {pick} of generation 1 through the "
            f"plain rollout: first 20 steps max |dr| {first:.3g} (by step "
            f"{', '.join(f'{d:.1e}' for d in by_step[:20])}), first step "
            f"beyond 1e-3: {split}; whole-episode fitness max |d| {fit:.3g}")
        require(first <= 1e-4, f"rule search {label}: the kernel's rewards "
                f"differ from the plain version's by {first} > 1e-4 over "
                f"the first 20 control steps")
        out[label] = {"candidates": pick, "first_20_max_abs": first,
                      "max_abs_by_step": by_step,
                      "first_step_beyond_1e-3": split,
                      "fitness_max_abs": fit}
    return out


def rule_search(dev, counters, every, results):
    """Phase 1 (`adaptation.optimize_rule`, plastic and weight-trained) and
    Phase 2 (`adaptation.evaluate_generalization` on the 72 unseen goals)
    on position at 11-128-2, through the entry points on the card; then the
    kernel's rewards against the plain version's, the new scenarios and
    where one candidate's loop spends its time."""
    import torch
    from repro_torch import envs, scenarios as S
    from repro_torch.core import adaptation as A
    # position's 150-step episodes, AdaptationConfig's defaults (11-128-2,
    # T = 4, lambda = 0.8, 24 pairs) cut to SEARCH_GENERATIONS generations
    env = envs.make(SEARCH_ENV)
    cfg = dataclasses.replace(A.AdaptationConfig(),
                              generations=SEARCH_GENERATIONS)
    steps, t_n, pop = env.episode_len, env.train_tasks().shape[0], \
        2 * cfg.pop_pairs
    out = {"kernel": search_kernel_checks(dev, results)}
    found, launches = {}, {}
    for plastic in (True, False):
        label = "plastic" if plastic else "weight-trained"
        for c in every:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, hist, scfg = A.optimize_rule(env, cfg, plastic=plastic)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[label] = {c.__name__: c.launches for c in counters}
        n = launches[label]["rollout"]
        want = cfg.generations * steps * (pop if plastic else 1)
        require(n == want, f"rule search {label}: {n} rollout launches, "
                f"expected {want}")
        hist = [float(h) for h in hist]
        require(all(math.isfinite(h) for h in hist) and params.shape[0] > 0
                and bool(torch.isfinite(params).all()),
                f"rule search {label}: non-finite fitness or parameters")
        rate = cfg.generations * pop * t_n * steps / dt
        found[label] = (params, scfg)
        out[label] = {"mean_fitness": hist, "seconds": dt,
                      "seconds_per_generation": dt / cfg.generations,
                      "control_steps_per_s": rate, "rollout_launches": n,
                      "params": int(params.shape[0])}
        log(f"  Phase 1 {label}: {cfg.generations} generations x {pop} "
            f"candidates x {t_n} tasks x {steps} steps in {dt:.2f} s = "
            f"{dt / cfg.generations:.2f} s a generation, {rate:.4g} "
            f"control-steps/s; mean fitness {hist}; {n} rollout launches")
    log(f"  launches on the rule search: {launches}")
    out["held"] = search_held_against_plain(
        dev, env, cfg, found["plastic"][1], found["weight-trained"][1])
    mask = torch.tensor([0.0, 1.0])
    phase2 = {}
    for label, (params, scfg) in found.items():
        clean = A.evaluate_generalization(env, scfg, params)
        dead = A.evaluate_generalization(env, scfg, params,
                                         actuator_mask=mask,
                                         mask_after=SEARCH_DEAD_FROM)
        require(tuple(clean.shape) == (72,) and tuple(dead.shape) == (72,)
                and bool(torch.isfinite(clean).all())
                and bool(torch.isfinite(dead).all()),
                f"Phase 2 {label}: bad returns")
        phase2[label] = {"clean_mean": float(clean.mean()),
                         "dead_mean": float(dead.mean()),
                         "damage_delta": float(dead.mean() - clean.mean())}
        log(f"  Phase 2 {label} on 72 unseen goals: clean "
            f"{phase2[label]['clean_mean']:.4f}, actuator 0 dead from step "
            f"{SEARCH_DEAD_FROM} {phase2[label]['dead_mean']:.4f} (delta "
            f"{phase2[label]['damage_delta']:.4f})")
    out["phase2"] = phase2
    scen = {}
    for name in ("arm-payload", "position-noise"):
        spec = S.SCENARIOS[name]
        senv = spec.make_env()
        for quant in (False, True):
            scfg = S.controller_config(senv, quant=quant)
            theta = S.reference_rule(spec.env_name, scfg)
            prog = S.make_closed_loop(senv, scfg, batch=spec.batch,
                                      steps=spec.steps)
            sched = S.compile_schedule(
                senv, spec.perturbations,
                torch.Generator(dev).manual_seed(123), spec.batch)
            rp = prog.run(theta, 7, tasks=spec.tasks, schedule=sched,
                          device=dev)
            rf = prog.run(theta, 7, tasks=spec.tasks, schedule=sched,
                          freeze_at=spec.onset, device=dev)
            mp = S.adaptation_metrics(rp.rewards, spec.onset, spec.window)
            mf = S.adaptation_metrics(rf.rewards, spec.onset, spec.window)
            require(bool(torch.isfinite(rp.rewards).all())
                    and bool(torch.isfinite(rf.rewards).all()),
                    f"{name}: non-finite rewards")
            mode = "int8" if quant else "float32"
            scen[f"{name} {mode}"] = {"plastic": mp, "frozen": mf}
            log(f"  {name:15s} {mode:7s}: drop {mp['drop']:.4f}, plastic "
                f"recovers {mp['recovery_frac']:.3f}, frozen "
                f"{mf['recovery_frac']:.3f} (not gated)")
    out["scenarios"] = scen
    # one candidate's loop (B = 8 train tasks, 150 control steps)
    scfg = found["plastic"][1]
    one = lambda: A.population_rewards(env, scfg, found["plastic"][0][None],
                                       env.train_tasks(), [SEED])
    one()
    log("  one candidate's loop:")
    prof = profile_window(one, steps)
    kern = [t for t in prof["top"] if "rollout" in t["name"]]
    if kern and prof["device_busy_ms"]:
        prof["rollout_ms_per_launch"] = kern[0]["ms"] / kern[0]["count"]
        log(f"    #3 at 11-128-2, B = 8: "
            f"{prof['rollout_ms_per_launch']:.4f} ms a launch (device), "
            f"idle share {prof['idle_share']:.3f}")
    out["profile"] = prof
    return out, launches


# ---- phase 2h: the recorder kernel against its plain version ---------------

REC_STEPS = 16                  # recorded steps of phase 2h
REC_TOL = 1e-6                  # float32 ring, baselines, wnorm0: rtol and
#                                 atol (the drift channel is a difference)
# planted slots of phase 2h: frozen channels and weights, spike rate 0, a
# sustained burst on channel 0 from step 10, sat outside its corridor
STUCK, DEAD, BURST, BOUND = 7, 11, 13, 17


def tol_ratio(got, want, tol):
    """Largest |got - want| / (tol + tol |want|): at most 1 where got is
    within rtol = atol = tol of want."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (tol + tol * w.abs())).max())


def tree_leaves(tree):
    """The tensors of a tree (a recorder state, a session), in flatten
    order."""
    from repro_torch.checkpoint import manager as CM
    return CM.flatten(tree)[1]


REC_DTYPES = ("float32", "bfloat16", "int8")
# the recorder's kernels by name in a trace (recorder_tiles_kernel,
# recorder_cluster_kernel)
REC_KERNEL = "::recorder_"
# the LM adapter's one layer (N x N) at B = 8: a slot spans a cluster
REC_ADAPTERS, REC_ADAPTER_B, REC_ADAPTER_STEPS = (128, 512), 8, 8


def plan_line(plan):
    """`recorder_plan`'s launch in one line."""
    return (f"{plan['route']}: {plan['slots']} slots a tile, "
            f"{plan['cluster']} CTAs a slot, {plan['ctas']} CTAs, "
            f"{plan['stages']} stage(s) of {plan['stage_bytes']} B, "
            f"{plan['smem']} B shared, loads {'/'.join(plan['loads'])}")


def recorder_leaves_held(kern, plain, quant, what):
    """The recorder state's leaves against the plain version's: int8 all
    and the integer leaves of every datapath bit for bit, float32 within
    rtol = atol = REC_TOL; returns (max |err|, tolerance ratio)."""
    import torch
    err = ratio = 0.0
    # ring, wnorm0, ewma_mean, ewma_var, last; streaks, flagged, steps
    for i, (a, b) in enumerate(zip(tree_leaves(kern), tree_leaves(plain))):
        if i >= 5 or quant:
            require(torch.equal(a, b), f"recorder {what}: leaf {i} not bit "
                    f"for bit its plain version's")
        else:
            err = max(err, float((a - b).abs().max()))
            ratio = max(ratio, tol_ratio(a, b, REC_TOL))
    return err, ratio


def compare_recorder(dev, results):
    """`record_step` (csrc/recorder.cu, one launch, laid out by
    `recorder_plan`, which is printed) against `record_step_plain` at
    8-128-8, B = 4096, float32, bfloat16 and int8, 90% of the slots
    active, over REC_STEPS steps of random telemetry rows and weights that
    move in half the slots each step, with a planted stuck, dead, bursting
    and out-of-corridor slot: flags, streaks, steps and verdicts exact,
    int8 bit for bit, float ring, baselines and wnorm0 within rtol = atol
    = REC_TOL; then the LM adapter's one layer at N = 128 and 512, B = 8
    (`compare_recorder_adapters`)."""
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    from repro_torch.obs import health as H, recorder as R
    from repro_torch.obs.telemetry import FleetTelemetry
    hcfg = H.HealthConfig(window=8, warmup=4, hysteresis=(2, 3, 4, 3))
    gen = torch.Generator(dev).manual_seed(SEED + 30)
    active = torch.rand(B, generator=gen, device=dev) < 0.9
    active[[STUCK, DEAD, BURST, BOUND]] = True
    span = torch.tensor([0.6, 0.02, 0.5], device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for mode in REC_DTYPES:
        quant = mode == "int8"
        cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
               else firefly_snn.CONFIG)
        st = snn.init_state(cfg, batch=B, fleet=True, device=dev)
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}[mode]
        log(f"  recorder {mode} plan at 8-128-8, B = {B}: " + plan_line(
            R.recorder_plan(B, [w.shape[1] * w.shape[2] for w in st.w], dt,
                            sms)))

        def draw():
            if quant:
                return [torch.randint(-128, 128, tuple(w.shape),
                                      generator=gen, device=dev,
                                      dtype=torch.int32).to(torch.int8)
                        for w in st.w]
            return [(0.1 * torch.randn(tuple(w.shape), generator=gen,
                                       device=dev)).to(dt) for w in st.w]
        w = draw()
        scales = tuple(torch.rand(B, generator=gen, device=dev) / 16 + 1 / 64
                       for _ in st.w) if quant else ()
        kern = R.init_recorder(hcfg, B, device=dev)
        plain = R.init_recorder(hcfg, B, device=dev)
        rows = None
        err, ratio = 0.0, 0.0
        for t in range(REC_STEPS):
            move = torch.rand(B, generator=gen, device=dev) < 0.5
            move[STUCK] = False
            w = [torch.where(move[:, None, None], n, o)
                 for n, o in zip(draw(), w)]
            state = dataclasses.replace(st, w=tuple(w), w_scale=scales)
            new = torch.rand(B, 3, generator=gen, device=dev) * span
            if rows is not None:
                new[STUCK] = rows[STUCK]
            new[DEAD, 0] = 0.0
            if t >= 10:
                new[BURST, 0] = 7.5
            new[BOUND, 2] = 1.5
            rows = new
            tel = FleetTelemetry(spike_rate=rows[:, 0],
                                 mean_abs_dw=rows[:, 1], sat_frac=rows[:, 2],
                                 occupancy=active.float())
            n0 = R.record_step.launches
            kern, kv = R.record_step(hcfg, kern, state, tel, t, active, quant)
            require(R.record_step.launches == n0 + 1,
                    "recorder: record_step did not launch its kernel")
            plain, pv = R.record_step_plain(hcfg, plain, state, tel, t,
                                            active, quant)
            torch.cuda.synchronize()
            e, q = recorder_leaves_held(kern, plain, quant,
                                        f"{mode} step {t}")
            err, ratio = max(err, e), max(ratio, q)
            require(torch.equal(kv, pv),
                    f"recorder {mode} step {t}: verdict differs")
        require(ratio <= 1, f"recorder {mode}: max |err| {err} outside rtol = "
                f"atol = {REC_TOL}")
        flags = kern.health.flagged
        require(bool(flags[STUCK, 2]) and bool(flags[DEAD, 3])
                and bool(flags[BURST, 0]) and bool(flags[BOUND, 1]),
                f"recorder {mode}: a planted fault was not flagged "
                f"({flags[[STUCK, DEAD, BURST, BOUND]].tolist()})")
        r = results["recorder"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log(f"  recorder {mode}: {REC_STEPS} steps at 8-128-8, B = {B}, "
            f"{int(active.sum())} active: flags, streaks, steps and "
            f"verdicts exact, " + ("every leaf bit for bit" if quant else
                                   f"floats max |err| {err:.3g}")
            + f"; planted faults flagged, {int(kv.sum())} slots flagged "
            f"in all")
    compare_recorder_adapters(dev, results, hcfg, sms)
    usage = R.recorder_attrs()
    results["recorder"]["registers"] = usage
    log(f"  recorder kernels' registers and local (spill) bytes: "
        f"{json.dumps(usage)}")
    require(all(u["local_bytes"] == 0 for u in usage.values()),
            f"a recorder kernel uses local memory: {json.dumps(usage)}")


def compare_recorder_adapters(dev, results, hcfg, sms):
    """The LM adapter's recorded step: one N x N layer at B = 8 for N in
    REC_ADAPTERS (a slot on a cluster of CTAs), float32, bfloat16 and int8,
    REC_ADAPTER_STEPS steps of moving weights and random telemetry, all
    slots active but one, against `record_step_plain`: as phase 2h's fleet.
    int8 weights lie in [-40, 40] with -128 planted in every slot, so a
    slot's sum of |w| (N = 512: at most 262144 * 40) stays under 2^24,
    where the plain version's float32 sum is exact."""
    import torch
    from repro_torch.core.engine import NetworkState
    from repro_torch.obs import recorder as R
    from repro_torch.obs.telemetry import FleetTelemetry
    b = REC_ADAPTER_B
    gen = torch.Generator(dev).manual_seed(SEED + 34)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[b - 1] = False
    for n in REC_ADAPTERS:
        for mode in REC_DTYPES:
            quant = mode == "int8"
            dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}[mode]

            def draw():
                if quant:
                    w = torch.randint(-40, 41, (b, n, n), generator=gen,
                                      device=dev, dtype=torch.int32
                                      ).to(torch.int8)
                    w.view(b, -1)[:, ::97] = -128
                    return w
                return (0.05 * torch.randn(b, n, n, generator=gen,
                                           device=dev)).to(dt)
            w = draw()
            scales = ((torch.rand(b, generator=gen, device=dev) / 16
                       + 1 / 64,) if quant else ())
            kern = R.init_recorder(hcfg, b, device=dev)
            plain = R.init_recorder(hcfg, b, device=dev)
            err = ratio = 0.0
            for t in range(REC_ADAPTER_STEPS):
                move = torch.rand(b, generator=gen, device=dev) < 0.5
                w = torch.where(move[:, None, None], draw(), w)
                st = NetworkState(w=(w,), v=(), trace=(),
                                  t=torch.zeros((), dtype=torch.int32,
                                                device=dev),
                                  w_scale=scales)
                raw = torch.rand(b, 3, generator=gen, device=dev)
                tel = FleetTelemetry(raw[:, 0], raw[:, 1], raw[:, 2],
                                     active.float())
                n0 = R.record_step.launches
                kern, kv = R.record_step(hcfg, kern, st, tel, t, active,
                                         quant)
                require(R.record_step.launches == n0 + 1,
                        "recorder: record_step did not launch its kernel")
                plain, pv = R.record_step_plain(hcfg, plain, st, tel, t,
                                                active, quant)
                torch.cuda.synchronize()
                e, q = recorder_leaves_held(
                    kern, plain, quant, f"adapter N = {n} {mode} step {t}")
                err, ratio = max(err, e), max(ratio, q)
                require(torch.equal(kv, pv), f"recorder adapter N = {n} "
                        f"{mode} step {t}: verdict differs")
            require(ratio <= 1, f"recorder adapter N = {n} {mode}: max "
                    f"|err| {err} outside rtol = atol = {REC_TOL}")
            r = results["recorder"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            plan = R.recorder_plan(b, [n * n], dt, sms)
            log(f"  recorder adapter N = {n}, B = {b}, {mode}: "
                f"{REC_ADAPTER_STEPS} steps, " +
                ("every leaf bit for bit" if quant else
                 f"floats max |err| {err:.3g}") + "; " + plan_line(plan))


# ---- phase 13: session health of the controller fleet at full width --------

HEALTH_SICK = 64                # sessions given dead input
HEALTH_WARM, HEALTH_CONT = 12, 6
HEALTH_MAX_ANOM = 10            # windows within which each must flag
HEALTH_PROFILED = 8             # windows profiled of each kind
HEALTH_EQUAL = 4                # record-on windows held against record-off
HEALTH_AB_ROUNDS = 3            # turns of kernel against plain walls


def health_config():
    """The incident drill's detectors (tests/test_health.py:365): only
    `dead` is on, two windows running below a spike rate of 1e-2."""
    from repro_torch.obs import HealthConfig
    off, never = 1e9, 9999
    return HealthConfig(warmup=8, z_threshold=off, bounds=((0.0, off),) * 4,
                        dead_floor=1e-2, hysteresis=(never, never, never, 2))


class HealthRun:
    """A 4096-slot FleetScheduler at 8-128-8 with a RAM SessionStore, every
    slot filled, drives keyed on each session's own step counter (so a
    rolled-back session replays the stream its control twin sees)."""

    def __init__(self, dev, quant, health=True):
        import numpy as np
        import torch
        from repro_torch.configs import firefly_snn
        from repro_torch.core import snn
        from repro_torch.serving import FleetScheduler, SessionStore
        cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
               else firefly_snn.CONFIG)
        # the rule drawn on the host, so every run gets the same one
        theta = [t.to(dev) for t in snn.init_theta(
            cfg, torch.Generator().manual_seed(SEED + 31), scale=0.05)]
        self.s = FleetScheduler(cfg, theta, slots=B, device=dev,
                                store=SessionStore(),
                                health=health_config() if health else None)
        self.base = np.random.default_rng(SEED + 32).standard_normal(
            (B, cfg.layer_sizes[0])).astype(np.float32)
        self.sick = {f"u{i}" for i in range(0, B, B // HEALTH_SICK)}
        for i in range(B):
            self.s.admit(f"u{i}")

    def drives(self, dead=False):
        import numpy as np
        from repro_torch.scenarios import AnomalyPreset, inject_anomaly
        preset = AnomalyPreset("dead_input")
        out = {}
        for u, slot in self.s.user_slot.items():
            t = int(self.s._steps[slot])
            d = (np.sin(0.5 * t + self.base[int(u[1:])]) * 1.5).astype(
                np.float32)
            out[u] = inject_anomaly(preset, d, t) if dead and u in self.sick \
                else d
        return out

    def window(self, **kw):
        return self.s.pool_step(self.drives(kw.pop("dead", False)), **kw)

    def rows(self, uids):
        """The listed sessions' rows of every fleet leaf, stacked."""
        slots = [self.s.user_slot[u] for u in sorted(uids)]
        f = self.s.fleet
        return [t[slots].clone() for t in f.w + f.v + f.trace + f.w_scale]


def profile_ops(fn, windows, expect):
    """Device ops, kernels, device-to-host copies and the recorder kernel's
    device time over `windows` calls of ``fn`` (torch.profiler, device
    activity only, after one warm-up call under the profiler).  `expect`
    maps a kernel-name fragment to the launches the windows must show; a
    trace that lacks some fails the run.  Late in the whole script's
    process the profiler has lost the first windows' launches, the same
    ones at every retake, and in a fresh process it never has: phase 13
    takes these traces in one (`Fresh`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(windows):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    seen = {k: sum(e.count for e in ev if k in e.key) for k in expect}
    require(seen == expect, f"the profiler's trace lacks launches: "
            f"{json.dumps(seen)} of {json.dumps(expect)}")
    ops = sum(e.count for e in ev)
    d2h = sum(e.count for e in ev if "DtoH" in e.key)
    copies = sum(e.count for e in ev if e.key.startswith(("Memcpy",
                                                           "Memset")))
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    rec = [e for e in ev if REC_KERNEL in e.key]
    out = {"windows": windows, "wall_ms": wall,
           "device_busy_ms": busy,
           "idle_share": 1 - busy / wall if busy else None,
           "device_ops": ops, "device_ops_per_window": ops / windows,
           "kernels": ops - copies, "kernels_per_window": (ops - copies)
           / windows,
           "d2h_copies": d2h, "d2h_per_window": d2h / windows,
           "counts": {e.key[:80]: e.count for e in ev},
           "top": [{"name": e.key[:60], "count": e.count,
                    "ms": e.self_device_time_total / 1e3}
                   for e in sorted(ev, key=lambda e:
                                   -e.self_device_time_total)[:5]]}
    if rec:
        out["recorder_ms_per_launch"] = (
            sum(e.self_device_time_total for e in rec) / 1e3
            / sum(e.count for e in rec))
        out["recorder_launches"] = sum(e.count for e in rec)
    return out


def recorder_bytes(b, sizes, wb, quant):
    """One recorder launch: the weights (and int8 scales), the telemetry
    and mask read once, the detector state read and written, a ring row
    and the verdict written."""
    syn = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    layers = len(sizes) - 1
    state = 4 + 3 * 4 * 4 + 4 * 4 + 4 + 4   # wnorm0, mean/var/last, streaks,
    #                                         flagged, steps
    return (b * syn * wb + (b * 4 * layers if quant else 0) + b * 3 * 4 + b
            + 2 * b * state + b * 4 * 4 + b)


def time_recorder(dev, results):
    """`record_step`'s device time (`device_ms`, L2 flushed by writing,
    the default of every timing here, and by reading, which leaves no
    dirty lines for the kernel to write back) beside its plain version and its bound by bytes:
    8-128-8, B = 4096, in float32, bfloat16 and int8, and the LM adapter's
    one N x N layer at B = 8 for N in REC_ADAPTERS, float32 and int8; and
    an empty kernel's time by the same `device_ms`, a launch's floor."""
    import ctypes
    import torch
    from repro_torch.core.engine import NetworkState
    from repro_torch.kernels import _build
    from repro_torch.obs import recorder as R
    from repro_torch.obs.telemetry import FleetTelemetry
    gen = torch.Generator(dev).manual_seed(SEED + 33)
    hcfg = health_config()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.library("recorder.cu")
    lib.recorder_empty.argtypes, lib.recorder_empty.restype = \
        [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    timed = {"launch_floor": {
        f: device_ms(lambda: lib.recorder_empty(stream), flush=f)
        for f in ("write", "read")}}
    shapes = [("float32", B, (8, 128, 8)), ("bfloat16", B, (8, 128, 8)),
              ("int8", B, (8, 128, 8))]
    shapes += [(f"adapter{n}-{m}", REC_ADAPTER_B, (n, n))
               for n in REC_ADAPTERS for m in ("float32", "int8")]
    for key, b, sizes in shapes:
        mode = key.split("-")[-1]
        quant = mode == "int8"
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}[mode]
        w = tuple((torch.randint(-40, 41, (b, sizes[i], sizes[i + 1]),
                                 generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.int8)
                   if quant else
                   torch.randn((b, sizes[i], sizes[i + 1]), generator=gen,
                               device=dev).to(dt))
                  for i in range(len(sizes) - 1))
        scales = tuple(torch.rand(b, generator=gen, device=dev) / 16
                       for _ in w) if quant else ()
        state = NetworkState(w=w, v=(), trace=(),
                             t=torch.zeros((), dtype=torch.int32,
                                           device=dev), w_scale=scales)
        raw = torch.rand(b, 3, generator=gen, device=dev)
        active = torch.rand(b, generator=gen, device=dev) < 0.9
        tel = FleetTelemetry(raw[:, 0], raw[:, 1], raw[:, 2],
                             active.float())
        rec = R.init_recorder(hcfg, b, device=dev)
        pos = [0]

        def call(fn=R.record_step):
            fn(hcfg, rec, state, tel, pos[0], active, quant)
            pos[0] += 1
        ms = device_ms(call)
        ms_read = device_ms(call, flush="read")
        plain = device_ms(lambda: call(R.record_step_plain), reps=5)
        wb = torch.empty((), dtype=dt).element_size()
        syn = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
        b_ms, kind = bound(recorder_bytes(b, sizes, wb, quant), 2 * b * syn)
        plan = R.recorder_plan(b, [x.shape[1] * x.shape[2] for x in w], dt,
                               sms)
        timed[key] = dict(ms=ms, ms_read_flush=ms_read, plain_ms=plain,
                          bound_ms=b_ms, bound_by=kind, b=b,
                          sizes=list(sizes), plan=plan_line(plan))
    fleet = {k: timed.pop(k) for k in REC_DTYPES}
    timed["adapter"] = {k: timed.pop(k) for k in list(timed)
                        if k.startswith("adapter")}
    timed.update(fleet)
    floor = timed["launch_floor"]
    log(f"  an empty kernel (a launch's floor): {floor['write']:.4f} ms "
        f"(L2 flushed by writing), {floor['read']:.4f} ms (by reading)")
    for key, r in list(fleet.items()) + list(timed["adapter"].items()):
        log(f"  recorder {key} (B = {r['b']}, {r['sizes']}): {r['ms']:.4f} "
            f"ms a launch (L2 flushed by writing), {r['ms_read_flush']:.4f} "
            f"ms (by reading), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['ms'] / r['bound_ms']:.1f}x); {r['plan']}")
    return timed


def profile_recorded_windows(run, quant):
    """HEALTH_PROFILED telemetry-on windows beside as many recorded ones
    (record=True, telemetry=True: the same telemetry kernels, then the
    recorder) on a full 4096-slot pool: device ops, kernels and
    device-to-host copies of each; the recorded side must launch exactly
    one more kernel a window (the recorder) and make the same copies."""
    run.window(telemetry=True)                      # warm both variants
    run.window(telemetry=True, record=True)
    # each window launches one rollout and copies its gauges to the host
    # once; a recorded one launches the recorder too
    n = HEALTH_PROFILED
    tel = profile_ops(lambda: run.window(telemetry=True), n,
                      {"rollout_kernel": n, "DtoH": n, REC_KERNEL: 0})
    rec = profile_ops(lambda: run.window(telemetry=True, record=True), n,
                      {"rollout_kernel": n, "DtoH": n, REC_KERNEL: n})
    mode = "int8" if quant else "float32"
    for name, p in (("telemetry-on", tel), ("recorded", rec)):
        log(f"  {mode} {name}: {p['kernels_per_window']:g} kernels, "
            f"{p['device_ops_per_window']:g} device ops with copies and "
            f"{p['d2h_per_window']:g} device-to-host copies a window, busy "
            f"{p['device_busy_ms']:.3f} ms of {p['wall_ms']:.1f} ms wall "
            f"(idle {p['idle_share']:.3f})")
    require(rec["kernels"] == tel["kernels"] + HEALTH_PROFILED
            and rec["d2h_copies"] == tel["d2h_copies"]
            and rec.get("recorder_launches") == HEALTH_PROFILED,
            f"{mode}: a recorded window is not a telemetry-on window plus "
            f"one launch ({rec['kernels']} vs {tel['kernels']} kernels, "
            f"{rec['d2h_copies']} vs {tel['d2h_copies']} copies over "
            f"{HEALTH_PROFILED} windows; by name {json.dumps(tel['counts'])}"
            f" vs {json.dumps(rec['counts'])})")
    log(f"  {mode}: the recorder by the profiler "
        f"{rec['recorder_ms_per_launch']:.4f} ms a launch")
    return {"telemetry_on": tel, "recorded": rec}


def recorded_walls(run, quant):
    """Wall time of HEALTH_PROFILED recorded windows with the recorder's
    kernel and with its plain version (`record_step_plain`, ~40 small ops)
    in its place, in HEALTH_AB_ROUNDS alternating turns of each, on the
    same pool."""
    import torch
    from repro_torch.obs import recorder as R
    steps = {"kernel": R.record_step, "plain": R.record_step_plain}
    walls = {k: [] for k in steps}
    for turn in range(HEALTH_AB_ROUNDS + 1):
        for name, fn in steps.items():
            with mock.patch.object(R, "record_step", fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HEALTH_PROFILED if turn else 1):
                    run.window(telemetry=True, record=True)
                torch.cuda.synchronize()
                if turn:                  # turn 0 warms both
                    walls[name].append((time.perf_counter() - t0) * 1e3)
    mode = "int8" if quant else "float32"
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"  {mode}: {HEALTH_PROFILED} recorded windows' wall, in "
        f"alternating turns: the kernel {[round(w, 1) for w in walls['kernel']]}"
        f" ms (median {med['kernel']:.1f}), the plain version "
        f"{[round(w, 1) for w in walls['plain']]} ms (median "
        f"{med['plain']:.1f})")
    return {"windows": HEALTH_PROFILED, "kernel_ms": walls["kernel"],
            "plain_ms": walls["plain"], "kernel_median_ms": med["kernel"],
            "plain_median_ms": med["plain"]}


def health_drill(dev, quant, flight_dir):
    """Phase 13's drill on one datapath: returns its report."""
    import torch
    from repro_torch.obs import recorder as R
    from repro_torch.obs.watchdog import watchdog
    mode = "int8" if quant else "float32"
    t0 = time.perf_counter()
    a, b = HealthRun(dev, quant), HealthRun(dev, quant, health=False)
    t_admit = time.perf_counter() - t0
    n0 = R.record_step.launches
    for w in range(HEALTH_WARM):
        d = a.drives()
        out_a = a.s.pool_step(d, record=True)
        out_b = b.s.pool_step(d)
        if w < HEALTH_EQUAL:
            fa, fb = a.s.fleet, b.s.fleet
            require(all(torch.equal(x, y) for x, y in zip(
                fa.w + fa.v + fa.trace + fa.w_scale,
                fb.w + fb.v + fb.trace + fb.w_scale))
                and torch.equal(torch.stack(list(out_a.values())),
                                torch.stack(list(out_b.values()))),
                f"{mode}: record=True changed window {w}'s state or "
                f"outputs")
    require(a.s.flagged_sessions() == [],
            f"{mode}: clean sessions flagged after warm-up: "
            f"{a.s.flagged_sessions()[:8]}")
    # a steady pool has churned: one round trip warms the recorder reset
    a.s.evict("u1")
    a.s.admit("u1")
    t1 = time.perf_counter()
    ckpt = a.s.health_checkpoint()
    t_ckpt = time.perf_counter() - t1
    require(ckpt == B, f"{mode}: health_checkpoint persisted {ckpt}")
    watchdog.install()
    watchdog.reset()
    with watchdog.armed():
        n_anom = 0
        while n_anom < HEALTH_MAX_ANOM:
            a.s.pool_step(a.drives(dead=True), record=True)
            n_anom += 1
            flagged = set(a.s.flagged_sessions())
            require(flagged <= a.sick, f"{mode}: clean sessions flagged: "
                    f"{sorted(flagged - a.sick)[:8]}")
            if flagged == a.sick:
                break
        require(flagged == a.sick, f"{mode}: {len(flagged)} of "
                f"{HEALTH_SICK} flagged within {HEALTH_MAX_ANOM} windows")
        t2 = time.perf_counter()
        reports = a.s.remediate(flight_dir=str(flight_dir / mode))
        t_rem = time.perf_counter() - t2
        require(len(reports) == HEALTH_SICK
                and {r["uid"] for r in reports} == a.sick
                and all(r["steps_lost"] == a.s.cfg.timesteps * n_anom
                        and r["to_slot"] == r["from_slot"]
                        and Path(r["incident"]).exists() for r in reports),
                f"{mode}: remediation reports {reports[:2]}")
        require(a.s.flagged_sessions() == [] and not a.s.quarantined_slots,
                f"{mode}: sessions still flagged or quarantined")
        outs_a = []
        for _ in range(HEALTH_CONT):
            o = a.window(record=True)
            outs_a.append(torch.stack([o[u] for u in sorted(a.sick)]))
        armed = {"violations": watchdog.violations,
                 "compiles": watchdog.compiles}
    require(watchdog.violations == 0,
            f"{mode}: watchdog violations {watchdog.violation_signatures}")
    launches = R.record_step.launches - n0
    windows = HEALTH_WARM + n_anom + HEALTH_CONT
    programs = a.s.compiled_programs()
    log(f"  {mode}: {B} sessions, {HEALTH_WARM} recorded windows bit for "
        f"bit record-off for the first {HEALTH_EQUAL} (state and outputs), "
        f"no clean session flagged; health_checkpoint of {ckpt} sessions "
        f"in {t_ckpt:.2f} s")
    log(f"  {mode}: all {HEALTH_SICK} dead-input sessions flagged after "
        f"{n_anom} windows; remediate (quarantine, incident dump, rollback) "
        f"in {t_rem:.2f} s under the armed watchdog, "
        f"{watchdog.violations} violations, {watchdog.compiles} compiles; "
        f"steps lost {reports[0]['steps_lost']} each")
    log(f"  {mode}: compiled_programs() = {json.dumps(programs)}")
    # the control pool: the sick evicted and re-admitted by hand at the
    # checkpoint, never given dead input
    for u in sorted(b.sick):
        b.s.evict(u)
    for u in sorted(b.sick):
        b.s.admit(u)
    for i in range(HEALTH_CONT):
        o = b.window()
        require(torch.equal(outs_a[i],
                            torch.stack([o[u] for u in sorted(b.sick)])),
                f"{mode}: continuation window {i} differs from the control")
    require(all(torch.equal(x, y) for x, y in zip(a.rows(a.sick),
                                                   b.rows(b.sick))),
            f"{mode}: the rolled-back sessions' state differs from the "
            f"control's")
    log(f"  {mode}: {HEALTH_CONT} windows after the rollback equal the "
        f"control pool bit for bit (outputs and state of all "
        f"{HEALTH_SICK}); {launches} recorder launches for {windows} "
        f"recorded windows")
    require(launches == windows, f"{mode}: {launches} recorder launches for "
            f"{windows} recorded windows")
    report = {"admit_seconds": t_admit, "checkpoint_seconds": t_ckpt,
            "remediate_seconds": t_rem, "windows_to_flag": n_anom,
            "steps_lost": reports[0]["steps_lost"],
            "recorder_launches": launches, "compiled_programs": programs,
            "watchdog_armed": armed}
    return report, a


def health_path(dev, results):
    """Phase 13: the drill on both datapaths, the recorder's launch count
    set to 0 just before the drills and read just after them; then its
    timings and profiles in a fresh process (`Fresh`)."""
    import tempfile
    import torch
    from repro_torch.obs import recorder as R
    work = ROOT / "build" / "chip_smoke_health"
    work.mkdir(parents=True, exist_ok=True)
    fresh = Fresh("health", work)
    out = {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        R.record_step.launches = 0
        for quant in (False, True):
            report, run = health_drill(dev, quant, Path(tmp))
            out["int8" if quant else "float32"] = report
            del run
            gc.collect()
            torch.cuda.empty_cache()
        results["recorder"]["launches"] = R.record_step.launches
    timed = fresh.result(lambda line: line.startswith("  ")
                         and not line.startswith("  ("))
    timing = timed["timing"]
    results["recorder"].update(timing["float32"])
    for key in ("bfloat16", "int8", "adapter", "launch_floor"):
        results["recorder"][key] = timing[key]
    for mode in ("float32", "int8"):
        out[mode]["profile"] = timed[mode]
    out["timing"] = timed["timing"]
    return out


def only_health(dev):
    """``--only health``: phase 13's timings (the recorder's time, and on
    a fresh full pool the profiled windows and the walls of recorded
    windows with the kernel and with its plain version)."""
    import torch
    results = {"recorder": {}}
    out = {"timing": time_recorder(dev, results)}
    for quant in (False, True):
        run = HealthRun(dev, quant)
        mode = "int8" if quant else "float32"
        out[mode] = profile_recorded_windows(run, quant)
        out[mode]["walls"] = recorded_walls(run, quant)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---- phase 14: the LM decode pool (serving.lm.LMScheduler) ------------------

POOL_SLOTS, POOL_MAX_LEN = 8, 1024
POOL_PROMPTS = (64, 256, 512)   # prompt lengths, user i takes i % 3
POOL_USERS = 20                 # the probe and u1..u19
POOL_RESIDENTS = 6              # beside the probe: the last slot stays vacant
POOL_STEPS, POOL_CHURN_EVERY = 32, 4
POOL_WINDOWS, POOL_K = 6, 4
POOL_DISK_BEFORE = 3            # the window before which the probe moves
POOL_WINDOW_KW = {1: dict(telemetry=True), 4: dict(record=True)}
POOL_SCALE = 0.5                # the adapter's readout scale (0 at init)
POOL_TOL_F32 = 1e-4             # float32 adapter: window against steps
POOL_LOGIT_TOL = 2e-2           # float32 logits, of the largest, if not equal
PHASE8_P50 = 78.7               # phase 8's float32 lockstep step p50, B = 4


def pool_model(dev, arch="qwen3-4b", cut=False):
    """``arch`` at full width (``cut``: at `shallow` depth) with the
    adapter at N = 128 and its readout scale set, random weights from
    `SEED`."""
    import torch
    from repro_torch.models import factory
    cfg = lm_config(arch)[0]
    if cut:
        cfg = shallow(cfg)
    cfg = cfg.with_(plastic_adapter=True, adapter_neurons=128)
    model = factory.build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 27))
    params["adapter"]["scale"].fill_(POOL_SCALE)
    return model, params


def pool_prompts(vocab, dev):
    import torch
    gen = torch.Generator(dev).manual_seed(SEED + 28)
    users = ["probe"] + [f"u{i}" for i in range(1, POOL_USERS)]
    return {u: torch.randint(0, vocab, (POOL_PROMPTS[(i + 1) % 3],),
                             generator=gen, device=dev)
            for i, u in enumerate(users)}


def first_diff(a, b):
    """The first leaf path where two session trees differ, or None."""
    import torch
    from repro_torch.checkpoint import manager as TM
    for path, x, y in zip(*TM.flatten(a), TM.flatten(b)[1]):
        if not torch.equal(x, y):
            return path
    return None


def sessions_match(got, want, quant, what):
    """int8: bit for bit.  float32: the backbone rows and integers bit for
    bit, the adapter's float leaves within `POOL_TOL_F32` (the window
    kernel's float32 rounding, ROADMAP.md Queue 3)."""
    import torch
    from repro_torch.checkpoint import manager as TM
    for path, x, y in zip(*TM.flatten(got), TM.flatten(want)[1]):
        if quant or "adapter" not in path or not y.is_floating_point():
            require(torch.equal(x, y), f"{what}: {path} differs")
        else:
            err = float((x - y).abs().max())
            require(err <= POOL_TOL_F32, f"{what}: {path} differs by {err}")


class PoolTimer:
    """Host clock around pool calls that end in a device synchronise."""

    def __init__(self):
        self.times = {}

    def __call__(self, kind, fn, *a, **kw):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        self.times.setdefault(kind, []).append(time.perf_counter() - t0)
        return out

    def p50_ms(self, kind):
        return statistics.median(self.times[kind]) * 1e3


def lm_pool_run(dev, model, params, prompts, quant, counters, tmp,
                results):
    """One datapath of the pool: the churned pool C (health recorder on),
    the quiet pool Q (the probe alone, stepped) and the window pool W (the
    probe restored from Q's boundary, windowed).  Every counter is set to
    0 just before C's first admission and read just after its last
    window.  Each attention launch of C's admissions (B = 1 prefills of
    every prompt length) is then held against its plain version on its
    own inputs, at phase 2c's bfloat16 tolerance."""
    import numpy as np
    import torch
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.plasticity import fused
    from repro_torch.models import attention as MA, factory
    from repro_torch.obs import HealthConfig
    from repro_torch.serving import LMScheduler, SessionStore
    mode = "int8" if quant else "float32"
    model = factory.build(model.cfg.with_(adapter_quant=quant))
    cfg = model.cfg
    vocab, n_layers = cfg.vocab, cfg.n_layers

    def make(store, health=None):
        return LMScheduler(model, params, POOL_SLOTS, POOL_MAX_LEN,
                           store=store, health=health)

    rng = np.random.default_rng(SEED + 29)
    forced = rng.integers(0, vocab, (POOL_WINDOWS, POOL_K))
    # Q: the probe alone for the steps, then through the shared RAM store
    # into W at the boundary; 4 more steps give window 0's tokens
    ram = SessionStore()
    q = make(ram)
    q.admit_prompt("probe", prompts["probe"])
    q_toks = [q.step()["probe"] for _ in range(POOL_STEPS)]
    q_sess = q.session_view("probe")
    q.evict("probe")
    q.admit_prompt("probe", prompts["probe"])        # the warm copy
    w = make(ram)
    w.admit_prompt("probe", prompts["probe"])        # the archived copy
    require(ram.restores == 1 and ram.warm_hits == 1,
            f"{mode}: the boundary state did not move through the store")
    first = q.pending("probe")
    q_next = [q.step()["probe"] for _ in range(POOL_K)]
    forced[0] = [first] + q_next[:-1]
    q_after = q.session_view("probe")
    del q
    w_logits, w_after0 = [], None
    for i in range(POOL_WINDOWS):
        w_logits.append(w.decode_window({"probe": forced[i]})["probe"])
        if i == 0:
            w_after0 = w.session_view("probe")
    w_final = w.session_view("probe")
    del w
    require(w_logits[0].argmax(-1).tolist() == q_next,
            f"{mode}: decode_window(K = {POOL_K}) gives other greedy tokens "
            f"than {POOL_K} steps")
    sessions_match(w_after0, q_after, quant,
                   f"{mode} window against {POOL_K} steps")
    log(f"  {mode}: decode_window(K = {POOL_K}) against {POOL_K} steps: the "
        f"same greedy tokens, the session "
        f"{'bit for bit' if quant else 'with the backbone bit for bit and the adapter within 1e-4'}")
    del q_after, w_after0

    # C: the probe and 6 residents, slot 7 vacant; every 4 steps the 2
    # least recently admitted residents leave and the next 2 users arrive
    timer = PoolTimer()
    c = make(SessionStore(), health=HealthConfig())
    ring = [f"u{i}" for i in range(1, POOL_USERS)]
    nxt = iter(ring + ring)
    fresh = 0

    attns, held = [], {"n": 0, "err": 0.0, "shapes": set()}

    def arrive(uid):
        nonlocal fresh
        known = c.store.known(uid)
        slot = timer("admit" if not known else "restore", c.admit_prompt,
                     uid, prompts[uid])
        fresh += not known
        # this admission's attention launches against the plain version,
        # outside the timed call
        held["n"] += len(attns)
        held["shapes"].update(tuple(a[0].shape) for a, _, _ in attns)
        held["err"] = max(held["err"], replay_launches(
            attns, TA.flash_attention_plain, "flash_attention", results,
            f"lm pool {mode}", False, ATTN_TOL["bfloat16"], quiet=True))
        attns.clear()
        return slot

    def leave_lru():
        lru = min((s for u, s in c.user_slot.items() if u != "probe"),
                  key=lambda s: c._admit_seq[s])
        c.evict(c.slot_user[lru])

    watch = contextlib.ExitStack()
    watch.enter_context(recording(MA, "attn_op", attns))
    for cnt in counters:
        cnt.launches = 0
    t_run = time.perf_counter()
    require(arrive("probe") == 0, "the probe is not in slot 0")
    for _ in range(POOL_RESIDENTS):
        arrive(next(nxt))
    vacant = c._take(c.pool, POOL_SLOTS - 1)
    toks, records = [], 0
    for t in range(POOL_STEPS):
        if t and t % POOL_CHURN_EVERY == 0:
            for _ in range(2):
                leave_lru()
            for _ in range(2):
                arrive(next(nxt))
        kw = {3: dict(record=True), 7: dict(telemetry=True)}.get(t % 8, {})
        records += bool(kw.get("record"))
        out = timer("step" if not kw else "step_variant", c.step, **kw)
        toks.append((out[0] if kw.get("telemetry") else out)["probe"])
    require(toks == q_toks, f"{mode}: the probe's tokens under churn differ "
            f"from the probe alone")
    c_sess = c.session_view("probe")
    diff = first_diff(c_sess, q_sess)
    require(not quant or diff is None,
            f"int8: the probe's session under churn differs at {diff}")
    out_row = {"neighbour_first_diff": diff}
    log(f"  {mode}: the probe under churn ({fresh} prefills so far): tokens "
        f"equal to the probe alone, session "
        f"{'bit for bit' if diff is None else 'differs first at ' + diff}")
    del c_sess, q_sess
    c_logits = []
    for i in range(POOL_WINDOWS):
        if i == POOL_DISK_BEFORE:
            # the probe through disk into another slot, between windows
            leave_lru()
            ram_c, disk = c.store, SessionStore(root=str(tmp / mode))
            c.store = disk
            c.evict("probe")
            disk._warm.clear()
            c.store = ram_c
            arrive(next(nxt))                   # takes the probe's slot
            c.store = disk
            slot = c.admit_prompt("probe", prompts["probe"])
            c.store = ram_c
            require(slot != 0 and disk.restores == 1,
                    f"{mode}: the probe did not come back from disk into "
                    f"another slot (slot {slot})")
        kw = POOL_WINDOW_KW.get(i, {})
        records += bool(kw.get("record"))
        windows = {u: np.full(POOL_K, c.pending(u)) for u in c.user_slot}
        windows["probe"] = forced[i]
        out = timer("window" if not kw else "window_variant",
                    c.decode_window, windows, **kw)
        c_logits.append((out[0] if kw.get("telemetry") else out)["probe"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {cnt.__name__: cnt.launches for cnt in counters}
    watch.close()
    step = "fleet_step_q" if quant else "fleet_step"
    want = {"flash_attention": n_layers * fresh, step: POOL_STEPS,
            "rollout": POOL_WINDOWS, "record_step": records,
            "silu": silu_per_forward(cfg) * (fresh + POOL_STEPS
                                             + POOL_WINDOWS * POOL_K)}
    for name, n in want.items():
        require(launches[name] == n, f"{mode}: {launches[name]} {name} "
                f"launches in the pool's run, want {n}")
    require(launches["ssd_scan"] == 0 and launches[
        "fleet_step" if quant else "fleet_step_q"] == 0,
        f"{mode}: launches of kernels off the path: {launches}")
    require(held["n"] == launches["flash_attention"],
            f"{mode}: {held['n']} attention calls held against the plain "
            f"version, {launches['flash_attention']} launches")
    log(f"  {mode}: all {held['n']} attention launches of the admissions "
        f"(B = 1 prefills at (B, S, H, D) {sorted(held['shapes'])}) against "
        f"the plain version on their inputs, max |err| {held['err']:.3g}")
    out_row["admission_attention_max_abs_err"] = held["err"]
    for x, y in zip(tree_leaves(vacant), tree_leaves(c._take(c.pool,
                                                     POOL_SLOTS - 1))):
        require(torch.equal(x, y), f"{mode}: the vacant slot's row moved")
    # the probe's windows in C (disk move, telemetry, record, neighbours)
    # against W's (alone, plain)
    same = all(torch.equal(a, b) for a, b in zip(c_logits, w_logits))
    c_final = c.session_view("probe")
    diff = first_diff(c_final, w_final)
    if quant:
        require(same and diff is None,
                f"int8: the probe's windows differ from the pool alone "
                f"(logits {'equal' if same else 'differ'}, session at "
                f"{diff})")
    else:
        err = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(c_logits, w_logits))
        require(err <= POOL_LOGIT_TOL,
                f"float32: the probe's window logits differ from the pool "
                f"alone by {err} of the largest")
        out_row["window_logit_rel_diff"] = err
    out_row["windows_first_diff"] = diff
    log(f"  {mode}: the probe's {POOL_WINDOWS} windows (through disk into "
        f"slot {c.user_slot['probe']} before window {POOL_DISK_BEFORE}, "
        f"telemetry and record "
        f"variants among them) against the probe alone: logits "
        f"{'bit for bit' if same else 'differ'}, session "
        f"{'bit for bit' if diff is None else 'differs first at ' + diff}")
    want_programs = {
        "slot_put": 1, "slot_take": 1, "recorder_reset": 1,
        "prefill": len(POOL_PROMPTS), "decode_step": 1,
        "decode_window": 1, "decode_step_telemetry": 1,
        "decode_window_telemetry": 1, "decode_step_record": 1,
        "decode_window_record": 1}
    require(c.compiled_programs() == want_programs,
            f"{mode}: compiled_programs() {c.compiled_programs()}")
    plan = fused.rollout.last_plan
    out_row.update(
        launches=launches, fresh_admissions=fresh, run_s=run_s,
        admit_ms_p50=timer.p50_ms("admit"), step_ms_p50=timer.p50_ms("step"),
        window_ms_per_token=timer.p50_ms("window") / POOL_K,
        pool_nbytes=c.pool_nbytes(), plan=plan,
        compiled_programs=c.compiled_programs())
    log(f"  {mode}: {fresh} admissions, admission p50 "
        f"{out_row['admit_ms_p50']:.1f} ms (B = 1 prefill + slot copy), "
        f"step p50 {out_row['step_ms_p50']:.1f} ms at B = {POOL_SLOTS}, "
        f"window {out_row['window_ms_per_token']:.1f} ms a token (K = "
        f"{POOL_K}), pool {c.pool_nbytes() / 2**30:.2f} GiB; launches "
        f"{launches}; #3's plan: tile {plan['tile']}, {plan['warps']} warps "
        f"a stream, {plan['buffers']} buffer, theta via {plan['theta']}, "
        f"{plan['smem']} B shared, {plan.get('ctas')} CTAs")
    compare_pool_recorder(c, quant, out_row)
    del c, c_final, w_final, vacant
    return out_row


def compare_pool_recorder(c, quant, row):
    """The recorded step of the pool (`record_step`, csrc/recorder.cu, on
    the adapter's one-layer view) against `record_step_plain` on copies of
    the pool's recorder and its adapter: int8 bit for bit, float32 within
    rtol = atol = `REC_TOL` (phase 2h's; the adapter's 16384-term weight
    norm sums in another order than the plain version's)."""
    import torch
    from repro_torch.checkpoint import manager as TM
    from repro_torch.obs import FleetTelemetry
    from repro_torch.obs import recorder as R
    gen = torch.Generator(c.device).manual_seed(SEED + 30)
    b = c.slots
    tel = FleetTelemetry(*(torch.rand(b, generator=gen, device=c.device)
                           for _ in range(3)),
                         occupancy=torch.ones(b, device=c.device))
    active = c._active_mask()
    layers = R.AdapterLayers.of(c.pool["cache"]["adapter"], quant)
    copy = lambda: TM.tree_map(torch.clone, c._rec)
    got, v1 = R.record_step(c.health_cfg, copy(), layers, tel, c._rec_pos,
                            active, quant)
    want, v2 = R.record_step_plain(c.health_cfg, copy(), layers, tel,
                                   c._rec_pos, active, quant)
    torch.cuda.synchronize()
    err = 0.0
    for path, x, y in zip(*TM.flatten(got), TM.flatten(want)[1]):
        if x.is_floating_point() and not quant:
            e = float((x - y).abs().max())
            err = max(err, e)
            require(tol_ratio(x, y, REC_TOL) <= 1, f"float32 recorder "
                    f"{path}: {e} from its plain version")
        else:
            require(torch.equal(x, y), f"{'int8' if quant else 'float32'} "
                    f"recorder {path} differs from its plain version")
    require(torch.equal(v1, v2), "the recorder's verdict differs")
    row["recorder_max_abs_err"] = err
    log(f"  {'int8' if quant else 'float32'}: the pool's recorded step "
        f"against its plain version: " + ("bit for bit" if quant else
                                           f"max |err| {err:.3g}"))
    if quant:
        return
    # the weight norm each route computes, latched into wnorm0 by a
    # recorder whose slots have no recorded step yet, against the norm in
    # float64: both float32 sums are as close to it as to each other
    def unlatched():
        r = copy()
        r.health.steps.zero_()
        return r
    k_rec, _ = R.record_step(c.health_cfg, unlatched(), layers, tel,
                             c._rec_pos, active, quant)
    p_rec, _ = R.record_step_plain(c.health_cfg, unlatched(), layers, tel,
                                   c._rec_pos, active, quant)
    w = c.pool["cache"]["adapter"]["w_fast"]
    exact = w.double().abs().sum(dim=(-2, -1)) / (w.shape[-2] * w.shape[-1])
    on = active.bool()
    dev_of = lambda x, y: float((x.double() - y.double())[on].abs().max())
    norm = row["recorder_norm"] = dict(
        terms=w.shape[-2] * w.shape[-1],
        largest=float(exact[on].max()),
        kernel_vs_float64=dev_of(k_rec.wnorm0, exact),
        plain_vs_float64=dev_of(p_rec.wnorm0, exact),
        kernel_vs_plain=dev_of(k_rec.wnorm0, p_rec.wnorm0))
    log(f"  float32: the adapter's mean |w| over {norm['terms']} terms "
        f"(largest {norm['largest']:.6g}): the kernel's sum is "
        f"{norm['kernel_vs_float64']:.3g} from the float64 sum, the plain "
        f"version's {norm['plain_vs_float64']:.3g}, and they are "
        f"{norm['kernel_vs_plain']:.3g} apart")


def compare_adapter_window(dev, results):
    """#3 fleet at the adapter's one 128 -> 128 layer, B = 8 pool slots,
    slot 5 vacant, through `plastic.decode_rollout` (the hidden states at
    qwen3-4b's width 2560): against the plain window at K = 1 and 4 (int8
    bit for bit across the step counter's int32 wrap; float32 within 1e-5
    at K = 1 and 1e-4 at K = 4), and #1/#2 at the same shape against the
    plain step; then #3's time at K = 4 beside its plain version and its
    bound."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.kernels.plasticity import fused, kernel as K
    from repro_torch.models import plastic
    rng = np.random.default_rng(SEED + 33)
    b, n, d = POOL_SLOTS, 128, 2560
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    params = {"p_in": on(rng.normal(0, 1.5 / np.sqrt(d), (d, n))
                         .astype(np.float32)),
              "p_out": on(rng.normal(0, 0.3, (n, d)).astype(np.float32)),
              "theta": on(rng.normal(0, 0.02, (4, n, n)).astype(np.float32)),
              "scale": torch.tensor(POOL_SCALE, device=dev)}
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[5] = False
    timed, err = {}, 0.0
    for quant in (False, True):
        mode = "int8" if quant else "float32"
        cfg = get_config("qwen3-4b").with_(
            plastic_adapter=True, adapter_neurons=n, adapter_quant=quant)
        if quant:
            st = {"w_fast": on(rng.integers(-40, 41, (b, n, n))
                               .astype(np.int8)),
                  "v2": on(rng.integers(-300, 300, (b, n)).astype(np.int32)),
                  "tr1": on(rng.integers(0, 900, (b, n)).astype(np.int32)),
                  "tr2": on(rng.integers(0, 900, (b, n)).astype(np.int32)),
                  "w_scale": on(np.where(np.arange(b) % 2, 1 / 16, 1 / 32)
                                .astype(np.float32))}
        else:
            st = {k: on(rng.uniform(lo, hi, shape).astype(np.float32))
                  for k, lo, hi, shape in (
                      ("w_fast", -0.5, 0.5, (b, n, n)),
                      ("v2", -0.5, 0.9, (b, n)), ("tr1", 0, 2, (b, n)),
                      ("tr2", 0, 2, (b, n)))}
        st["v1"] = on(rng.uniform(-0.5, 0.9, (b, n)).astype(np.float32))
        st["t"] = on(np.full((b,), 2 ** 31 - 2, np.int32))
        for k in (1, POOL_K):
            h = on(rng.normal(0, 1, (b, k, d)).astype(np.float32))
            launches = fused.rollout.launches
            got_h, got = plastic.decode_rollout(params, st, h, cfg,
                                                active=active)
            require(fused.rollout.launches == launches + 1,
                    f"{mode}: decode_rollout made "
                    f"{fused.rollout.launches - launches} rollout launches")
            with mock.patch.object(fused, "rollout", plain_rollout):
                want_h, want = plastic.decode_rollout(params, st, h, cfg,
                                                      active=active)
            torch.cuda.synchronize()
            tol = 1e-5 if k == 1 else 1e-4
            for key in want:
                e = float((got[key].double() - want[key].double()).abs()
                          .max())
                err = max(err, e)
                require(torch.equal(got[key], want[key]) if quant
                        and key != "v1" else e <= tol,
                        f"#3 at the adapter shape, {mode}, K = {k}: {key} "
                        f"differs from the plain window (max err {e})")
                require(torch.equal(got[key][5], st[key][5]),
                        f"#3 at the adapter shape: the vacant slot's {key} "
                        f"moved")
            require(torch.allclose(got_h, want_h, rtol=tol, atol=tol),
                    f"#3 at the adapter shape, {mode}, K = {k}: the readout "
                    f"differs")
        plan = dict(fused.rollout.last_plan)
        # #1/#2: one adapter step at the same shape
        step = K.fleet_step_q if quant else K.fleet_step
        h1 = on(rng.normal(0, 1, (b, 1, d)).astype(np.float32))
        launches = step.launches
        got_h, got = plastic.decode_step(params, st, h1, cfg, active=active)
        require(step.launches == launches + 1, f"{mode}: no fleet step")
        want_h, want = plain_adapter_step(params, st, h1, cfg, active=active)
        torch.cuda.synchronize()
        for key in want:
            require(torch.equal(got[key], want[key]) if quant else
                    torch.allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5),
                    f"#{'2' if quant else '1'} at 128x128, B = {b}, {mode}: "
                    f"{key} differs from the plain step")
            require(torch.equal(got[key][5], st[key][5]),
                    f"{step.__name__}: the vacant slot's {key} moved")
        # the window kernel's time at K = 4
        net = engine.NetworkState(
            w=(st["w_fast"],), v=(st["v2"],), trace=(st["tr1"], st["tr2"]),
            t=torch.zeros((), dtype=torch.int32, device=dev),
            w_scale=(st["w_scale"],) if quant else ())
        drives = on(rng.integers(0, 2, (POOL_K, b, n)).astype(np.float32))
        if quant:
            from repro_torch.kernels.plasticity import quant as Q
            drives = Q.to_fixed(drives, plastic.QUANT)
        ep = plastic._engine_params(cfg, 0.8, 4.0)
        kw = dict(params=ep, active=active,
                  seed=st["t"] if quant else None)
        run = lambda: engine.rollout(net, [params["theta"]], drives,
                                     block_b=plan["tile"], **kw)
        with mock.patch.object(fused, "rollout", plain_rollout):
            plain_ms = device_ms(run, reps=5)
        b_ms, kind = bound(window_bytes(b, (n, n), POOL_K,
                                        1 if quant else 4),
                           POOL_K * b * n * n * (OPS_Q if quant else OPS_F32))
        timed[mode] = dict(ms=device_ms(run), plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=kind, plan=plan)
        log(f"  #3 at the adapter shape (128 -> 128, B = {b}, K = {POOL_K}), "
            f"{mode}: {timed[mode]['ms']:.4f} ms a launch (plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms by {kind}); plan: tile "
            f"{plan['tile']}, {plan['warps']} warps a stream, "
            f"{plan['buffers']} buffer, theta via {plan['theta']}, "
            f"{plan['smem']} B shared, {plan.get('ctas')} CTAs")
    results["rollout"]["max_abs_err"] = max(results["rollout"]["max_abs_err"],
                                            err)
    results["rollout"]["adapter_shape"] = timed
    return timed


def ssd_blocks(cfg):
    """Mamba2 blocks of ``cfg``: the SSD-scan launches of one prefill."""
    from repro_torch.models.transformer import segments
    return sum(count * (1 if kind == "ssm" else cfg.ssm.attn_every - 1)
               for kind, count in segments(cfg) if kind != "dense")


def pool_small_layout(dev, arch, results):
    """``arch`` at `shallow` depth and full width in a 4-slot pool, float32
    and int8: slot 1 vacant over 4 steps and a K = 4 window; the window
    against the 4 steps (the same greedy tokens; sessions bit for bit in
    int8, in float32 the backbone bit for bit and the adapter within
    1e-4); the SSD-scan launches of each admission, one rollout launch for
    the window.  Each SSD-scan and attention launch of the admissions (B =
    1 prefills of every prompt length) is held against its plain version
    on its own inputs, at phase 2d's and 2c's tolerances."""
    import numpy as np
    import torch
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.plasticity import fused
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import attention as MA, factory, ssm as MS
    from repro_torch.serving import LMScheduler
    model, params = pool_model(dev, arch, cut=True)
    prompts = pool_prompts(model.cfg.vocab, dev)
    n_ssd = ssd_blocks(model.cfg)
    out = {}
    for quant in (False, True):
        mode = "int8" if quant else "float32"
        m = factory.build(model.cfg.with_(adapter_quant=quant))

        def pool():
            s = LMScheduler(m, params, 4, POOL_MAX_LEN)
            for u in ("probe", "u1", "u2"):
                s.admit_prompt(u, prompts[u])
            s.evict("u1")
            return s

        launches = SK.ssd_scan.launches
        scans, attns = [], []
        with recording(MS, "ssd_op", scans), recording(MA, "attn_op", attns):
            a = pool()
        require(SK.ssd_scan.launches == launches + 3 * n_ssd
                and len(scans) == 3 * n_ssd,
                f"{arch} {mode}: {SK.ssd_scan.launches - launches} SSD-scan "
                f"launches in 3 prefills, want {3 * n_ssd}")
        lengths = sorted({a_[0].shape[1] for a_, _, _ in scans})
        replay_launches(scans, SK.ssd_scan_plain, "ssd_scan", results,
                        f"{arch} pool {mode}, B = 1 prefills at L "
                        f"{lengths}", False, None, close=ssd_close)
        if attns:
            replay_launches(attns, TA.flash_attention_plain,
                            "flash_attention", results,
                            f"{arch} pool {mode}, B = 1 prefills",
                            False, ATTN_TOL["bfloat16"])
        del scans, attns
        b = pool()
        vacant = a._take(a.pool, 1)
        first = {u: a.pending(u) for u in ("probe", "u2")}
        seq = [a.step() for _ in range(POOL_K)]
        windows = {u: np.array([first[u]] + [t[u] for t in seq[:-1]])
                   for u in first}
        launches = fused.rollout.launches
        got = b.decode_window(windows)
        require(fused.rollout.launches == launches + 1,
                f"{arch} {mode}: the window made "
                f"{fused.rollout.launches - launches} rollout launches")
        for u in first:
            require(got[u].argmax(-1).tolist() == [t[u] for t in seq],
                    f"{arch} {mode}: the window's greedy tokens differ from "
                    f"the steps'")
            sessions_match(b.session_view(u), a.session_view(u), quant,
                           f"{arch} {mode} window against steps")
        for s in (a, b):
            for x, y in zip(tree_leaves(vacant), tree_leaves(s._take(s.pool, 1))):
                require(torch.equal(x, y),
                        f"{arch} {mode}: the vacant slot's row moved")
        out[mode] = {"plan": dict(fused.rollout.last_plan)}
        del a, b
    axes = sorted(set(tree_leaves(model.cache_axes(POOL_MAX_LEN))))
    out["slot_axes"] = axes
    log(f"  {arch} ({model.cfg.n_layers} layers at full width, 4 slots): "
        f"{n_ssd} SSD scans an admission, the vacant slot frozen and the "
        f"window equal to the steps in float32 and int8; slot axes {axes}")
    del params
    torch.cuda.empty_cache()
    return out


# tests/test_torch_serving_lm.py::test_pinned_program_counts, its sequence
# and its dict
AUDIT_PROGRAMS = {
    "slot_put": 1, "slot_take": 1, "recorder_reset": 0, "prefill": 2,
    "decode_step": 1, "decode_step_telemetry": 1, "decode_window": 1,
    "decode_window_telemetry": 1, "decode_step_record": 0,
    "decode_window_record": 0}


def pool_compile_audit(dev):
    """The CPU test's compile-audit sequence on the card (smoke qwen3-4b,
    int8 adapter): `compiled_programs()` equals the dict it pins, and a
    new window length grows only ``decode_window``."""
    import numpy as np
    import torch
    from repro_torch.models import factory
    from repro_torch.serving import LMScheduler
    model = factory.build("qwen3-4b", smoke=True, plastic_adapter=True,
                          adapter_neurons=8, adapter_quant=True)
    params = model.init(torch.Generator(dev).manual_seed(SEED))
    s = LMScheduler(model, params, slots=3, max_len=24)
    rng = np.random.default_rng(SEED + 34)
    s.admit_prompt("a", rng.integers(0, model.cfg.vocab, 6))
    s.admit_prompt("b", rng.integers(0, model.cfg.vocab, 4))
    for _ in range(2):
        s.step()
    s.step(telemetry=True)
    k2 = {u: np.full((2,), s.pending(u)) for u in ("a", "b")}
    s.decode_window(k2)
    s.decode_window(k2, telemetry=True)
    s.evict("b")
    require(s.compiled_programs() == AUDIT_PROGRAMS,
            f"compile audit on the card: {s.compiled_programs()}")
    s.decode_window({"a": np.full((3,), s.pending("a"))})
    require(s.compiled_programs() == dict(AUDIT_PROGRAMS, decode_window=2),
            f"compile audit, a new window length: {s.compiled_programs()}")
    log("  compile audit (the CPU test's sequence, smoke qwen3-4b on the "
        "card): compiled_programs() equals the pinned dict")
    return s.compiled_programs()


def lm_pool_profile(dev):
    """``--only lm-pool-profile``: a fresh process's `torch.profiler` of
    `PROFILED_STEPS` pool steps of full-width qwen3-4b, float32 adapter,
    B = 8 slots with 7 streams of 64-token prompts (after 2 warm-up
    steps): device busy time, idle share and device ops a step."""
    from repro_torch.serving import LMScheduler
    model, params = pool_model(dev)
    prompts = pool_prompts(model.cfg.vocab, dev)
    s = LMScheduler(model, params, POOL_SLOTS, POOL_MAX_LEN)
    for u in ["probe"] + [f"u{i}" for i in range(1, POOL_RESIDENTS + 2)]:
        s.admit_prompt(u, prompts[u][:64])
    for _ in range(2):
        s.step()
    log(f"  {PROFILED_STEPS} pool steps, B = 8, float32 adapter:")
    return profile_window(lambda: [s.step() for _ in range(PROFILED_STEPS)],
                          PROFILED_STEPS)


def lm_pool(dev, results, lm=None):
    """Phase 14: the LM decode pool on full-width qwen3-4b (float32 then
    int8 adapter), then mamba2-1.3b and zamba2-7b at `shallow` depth, the
    adapter window's kernel checks and time, and the fresh process's
    profile.  ``lm``: phase 8's results, for its lockstep p50 beside."""
    import tempfile
    import torch
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.plasticity import fused, kernel as K
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import layers as ML
    from repro_torch.obs import recorder as R
    counters = (TA.flash_attention, SK.ssd_scan, ML.silu, K.fleet_step,
                K.fleet_step_q, fused.rollout, R._record_step)
    work = ROOT / "build" / "chip_smoke_lm_pool"
    work.mkdir(parents=True, exist_ok=True)
    fresh = Fresh("lm-pool-profile", work)
    out = {"adapter_window": compare_adapter_window(dev, results)}
    gc.collect()
    torch.cuda.empty_cache()
    model, params = pool_model(dev)
    prompts = pool_prompts(model.cfg.vocab, dev)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        for quant in (False, True):
            out["int8" if quant else "float32"] = lm_pool_run(
                dev, model, params, prompts, quant, counters, Path(tmp),
                results)
            gc.collect()
            torch.cuda.empty_cache()
    del model, params, prompts
    gc.collect()
    torch.cuda.empty_cache()
    lockstep = (lm or {}).get("qwen3-4b", {}).get("float32", {}).get(
        "decode_ms_p50")
    log(f"  step p50 at B = {POOL_SLOTS}: float32 "
        f"{out['float32']['step_ms_p50']:.1f} ms, int8 "
        f"{out['int8']['step_ms_p50']:.1f} ms; phase 8's lockstep p50 at "
        f"B = 4: " + (f"{lockstep:.1f} ms (this run)" if lockstep else
                      f"{PHASE8_P50} ms (an earlier full run; phase 8 not run)"))
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        out[arch] = pool_small_layout(dev, arch, results)
        gc.collect()
        torch.cuda.empty_cache()
    out["compile_audit"] = pool_compile_audit(dev)
    out["profile"] = prof = fresh.result(
        lambda line: line.startswith("    "))
    smi = nvidia_smi()
    for mode in ("float32", "int8"):
        r, t = out[mode], out["adapter_window"][mode]
        log(f"  lm pool {mode} ({smi}): admission p50 "
            f"{r['admit_ms_p50']:.1f} ms, step p50 {r['step_ms_p50']:.1f} "
            f"ms at B = {POOL_SLOTS}, window {r['window_ms_per_token']:.1f} "
            f"ms a token, pool_nbytes {r['pool_nbytes']}; #3 at the adapter "
            f"shape {t['ms']:.4f} ms against its bound {t['bound_ms']:.5f} "
            f"ms ({t['bound_by']})")
    if prof.get("idle_share") is not None:
        log(f"  lm pool profile ({smi}): {PROFILED_STEPS} steps, idle share "
            f"{prof['idle_share']:.3f}, "
            f"{prof['kernel_launches_per_step']:.0f} device ops a step")
    return out


# ---- phase 15: the MoE layout on deepseek-moe-16b ---------------------------

MOE_ARCH = "deepseek-moe-16b"
MOE_ATTN = (LM_BATCH, 2048, 16, 16, 128)       # B, S, H, HKV, D at deepseek
MOE_VACANT_STEPS = 4            # steps of each default-capacity pool
MOE_CHURN_STEPS = 24            # steps of the probe, alone and under churn
MOE_RANGES = ("route", "dispatch", "experts", "combine")


def arch_attention(dev, results, arch=MOE_ARCH, shape=MOE_ATTN,
                   key="moe_shape", seed=SEED + 31):
    """#7 at ``arch``'s prefill ``shape`` (B, S, H, HKV, D; phase 15:
    deepseek-moe-16b's 16 query over 16 KV heads of 128) against its plain
    version, bfloat16 and float32, within phase 2c's tolerances; the bf16
    kernel timed (L2 flushed) beside its plain version,
    `scaled_dot_product_attention` and its bound.  Filed under ``key`` in
    the kernels line's #7 row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel as TA
    gen = torch.Generator(dev).manual_seed(seed)
    b, s, h, hkv, d = shape
    out = {"shape": dict(zip(("B", "S", "H", "HKV", "D"), shape))}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        rtol, atol = ATTN_TOL[dname]
        q, k, v = attention_inputs(gen, b, s, s, h, hkv, d, dtype, dev)
        got = TA.flash_attention(q, k, v)
        want = TA.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        results["flash_attention"]["max_abs_err"] = max(
            results["flash_attention"]["max_abs_err"], err)
        require(got.dtype == dtype and got.shape == q.shape
                and torch.allclose(got.float(), want.float(), rtol=rtol,
                                   atol=atol),
                f"flash_attention {dname} at {arch}'s prefill shape: max "
                f"err {err} outside rtol {rtol} atol {atol}")
        out[f"{dname}_max_abs_err"] = err
        log(f"  flash_attention  {dname:8s} {arch} B={b} S={s} "
            f"H={h}/{hkv} D={d}: max |err| {err:.3g}")
        if dtype == torch.bfloat16:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            ms = device_ms(lambda: TA.flash_attention(q, k, v))
            plain = device_ms(lambda: TA.flash_attention_plain(q, k, v),
                              reps=5)
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            bms, kind, tb, to = attention_bound(b, s, s, h, hkv, d, 2)
            out.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                       bound_by=kind,
                       tflops=to * BF16_OPS_PER_S / 1e3 / ms / 1e9)
            log(f"  flash_attention bf16 {arch}: {ms:.4f} ms (plain "
                f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {bms:.4f} ms by "
                f"{kind}), {out['tflops']:.1f} TFLOP/s, {ms / lib:.2f}x SDPA, "
                f"{ms / bms:.2f}x the bound")
            del qt, kt, vt
        del q, k, v, got, want
    results["flash_attention"][key] = out
    torch.cuda.empty_cache()
    return out


def moe_pool(dev, results):
    """(d) An `LMScheduler` on full-width deepseek-moe-16b, 8 slots of 1024
    positions, one vacant, int8 adapter.  At the default capacity (one row
    an expert at decode) slot 0 is vacant and two pools differ only in its
    pending token: over 4 steps the 7 active streams' logits, tokens and
    sessions are bit for bit equal and the vacant row frozen.  At
    ``capacity_factor = num_experts`` the probe under churn (2 of 6
    residents replaced every 4 of 24 steps, slot 7 vacant) gives the same
    tokens as the probe alone and the same session bit for bit.  The
    attention launches (28 an admission) and fleet steps (one a step) are
    counted; admission and step p50 on the host clock."""
    import torch
    from repro_torch.checkpoint import manager as TM
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.models import factory, moe as MoE
    from repro_torch.serving import LMScheduler
    model, params = pool_model(dev, MOE_ARCH)
    model = factory.build(model.cfg.with_(adapter_quant=True))
    cfg = model.cfg
    prompts = pool_prompts(cfg.vocab, dev)
    users = [f"u{i}" for i in range(1, POOL_USERS)]
    timer, out = PoolTimer(), {}
    require(MoE.capacity(cfg, POOL_SLOTS) == 1,
            "deepseek-moe-16b's decode capacity is not 1")

    def vacant_run(tok):
        s = LMScheduler(model, params, POOL_SLOTS, POOL_MAX_LEN)
        for u in ["probe"] + users[:POOL_SLOTS - 1]:
            timer("admit", s.admit_prompt, u, prompts[u])
        s.evict("probe")
        s.pool["tok"][0] = tok
        frozen = s._take(s.pool, 0)
        seen, real = [], model.decode_step

        def decode_step(*a, **kw):
            logits, cache = real(*a, **kw)
            seen.append(logits[1:].clone())
            return logits, cache

        with mock.patch.object(model, "decode_step", decode_step):
            toks = [timer("step", s.step) for _ in range(MOE_VACANT_STEPS)]
        for x, y in zip(TM.flatten(frozen)[1],
                        TM.flatten(s._take(s.pool, 0))[1]):
            require(torch.equal(x, y), "the vacant slot's row moved")
        sessions = {u: s.session_view(u) for u in s.user_slot}
        del s
        return seen, toks, sessions

    for c in (TA.flash_attention, K.fleet_step_q):
        c.launches = 0
    base = vacant_run(0)
    other = vacant_run(cfg.vocab - 1)
    n_admit = 2 * POOL_SLOTS
    require(TA.flash_attention.launches == n_admit * cfg.n_layers
            and K.fleet_step_q.launches == 2 * MOE_VACANT_STEPS,
            f"default-capacity pools: {TA.flash_attention.launches} "
            f"attention launches for {n_admit} admissions, "
            f"{K.fleet_step_q.launches} fleet steps for "
            f"{2 * MOE_VACANT_STEPS} steps")
    require(base[1] == other[1] and all(
        torch.equal(a, b) for a, b in zip(base[0], other[0])),
        "the vacant slot's pending token moved an active stream's logits")
    for u, sess in base[2].items():
        require(first_diff(sess, other[2][u]) is None,
                f"the vacant slot's pending token moved {u}'s session "
                f"(first at {first_diff(sess, other[2][u])})")
    log(f"  default capacity (1 row an expert at decode): {POOL_SLOTS - 1} "
        f"streams, slot 0 vacant holding token 0 or {cfg.vocab - 1}: the "
        f"active logits, tokens and sessions bit for bit over "
        f"{MOE_VACANT_STEPS} steps, the vacant row frozen")
    out["default_capacity"] = dict(
        admit_ms_p50=timer.p50_ms("admit"), step_ms_p50=timer.p50_ms("step"))
    del base, other

    raised = factory.build(cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts))))
    ctimer = PoolTimer()
    alone = LMScheduler(raised, params, POOL_SLOTS, POOL_MAX_LEN)
    alone.admit_prompt("probe", prompts["probe"])
    a_toks = [alone.step()["probe"] for _ in range(MOE_CHURN_STEPS)]
    a_sess = alone.session_view("probe")
    del alone
    c = LMScheduler(raised, params, POOL_SLOTS, POOL_MAX_LEN)
    ring = iter(users)
    ctimer("admit", c.admit_prompt, "probe", prompts["probe"])
    for _ in range(POOL_RESIDENTS):
        u = next(ring)
        ctimer("admit", c.admit_prompt, u, prompts[u])
    vacant = c._take(c.pool, POOL_SLOTS - 1)
    c_toks = []
    for t in range(MOE_CHURN_STEPS):
        if t and t % POOL_CHURN_EVERY == 0:
            for _ in range(2):
                lru = min((s for u, s in c.user_slot.items()
                           if u != "probe"), key=lambda s: c._admit_seq[s])
                c.evict(c.slot_user[lru])
                u = next(ring)
                ctimer("admit", c.admit_prompt, u, prompts[u])
        c_toks.append(ctimer("step", c.step)["probe"])
    require(c_toks == a_toks,
            "capacity_factor = num_experts: the probe's tokens under churn "
            "differ from the probe alone")
    diff = first_diff(c.session_view("probe"), a_sess)
    require(diff is None, f"capacity_factor = num_experts: the probe's "
            f"session under churn differs from the probe alone at {diff}")
    require(first_diff(vacant, c._take(c.pool, POOL_SLOTS - 1)) is None,
            "the churned pool's vacant slot moved")
    log(f"  capacity_factor = {cfg.moe.num_experts}: the probe beside 6 "
        f"residents, 2 replaced every {POOL_CHURN_EVERY} of "
        f"{MOE_CHURN_STEPS} steps, equals the probe alone: tokens and "
        f"session bit for bit; the vacant slot frozen")
    out["raised_capacity"] = dict(
        admit_ms_p50=ctimer.p50_ms("admit"),
        step_ms_p50=ctimer.p50_ms("step"))
    smi = nvidia_smi()
    for what, r in out.items():
        log(f"  moe pool, {what} ({smi}): admission p50 "
            f"{r['admit_ms_p50']:.1f} ms, step p50 {r['step_ms_p50']:.1f} ms "
            f"at B = {POOL_SLOTS}")
    del c, vacant, a_sess, params, model, raised
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def moe_ranges():
    """`moe.route`, `dispatch`, `experts` and `combine` each inside a
    `torch.profiler.record_function` range ``moe.<name>``."""
    from torch.profiler import record_function
    from repro_torch.models import moe as MoE
    with contextlib.ExitStack() as stack:
        for name in MOE_RANGES:
            real = getattr(MoE, name)

            def ranged(*a, _real=real, _name=name, **kw):
                with record_function(f"moe.{_name}"):
                    return _real(*a, **kw)
            stack.enter_context(mock.patch.object(MoE, name, ranged))
        yield


def moe_split(prof):
    """Device ms of each MoE range in a `profile_window` report and its
    share of the device's busy time."""
    ranges = prof.get("annotated_ranges", {})
    busy = prof["device_busy_ms"]
    out = {}
    for name in MOE_RANGES:
        ms = ranges.get(f"moe.{name}", {}).get("device_ms", 0.0)
        out[name] = dict(device_ms=ms, share=ms / busy if busy else None)
    return out


def moe_profile(dev):
    """``--only moe-profile``: a fresh process's `torch.profiler` of one
    prefill of 4 x 2048 tokens and `PROFILED_STEPS` decode steps after it
    (after one untimed prefill and step) of full-width deepseek-moe-16b,
    float32 adapter: idle share, device ops a step, and the device time of the
    routing, the dispatch, the experts (their GEMMs and silu) and the
    combine, each beside the busy time."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill
    from repro_torch.models import factory
    cfg = lm_config(MOE_ARCH)[0].with_(plastic_adapter=True,
                                        adapter_neurons=128)
    model = factory.build(cfg)
    gen = torch.Generator(dev).manual_seed(SEED)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    prefill = make_prefill(cfg, LM_PROMPT + 8)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, prompts)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    decode(params, cache, tok)
    del cache
    made, out = [], {}
    with moe_ranges():
        log("  one prefill of 4 x 2048 tokens:")
        out["prefill"] = profile_window(
            lambda: made.append(prefill(params, prompts)), 1)
        _, cache = made.pop()

        def steps():
            nonlocal cache
            for _ in range(PROFILED_STEPS):
                _, cache = decode(params, cache, tok)

        log(f"  {PROFILED_STEPS} decode steps, float32 adapter:")
        out["decode"] = profile_window(steps, PROFILED_STEPS)
    for what in ("prefill", "decode"):
        out[what]["moe"] = split = moe_split(out[what])
        log(f"  {what}: " + ", ".join(
            f"{n} {r['device_ms']:.3f} ms"
            + (f" ({r['share']:.3f} of busy)" if r["share"] is not None
               else "") for n, r in split.items()))
    return out


def moe_path(dev, results, counters, every):
    """Phase 15: deepseek-moe-16b at full width.  (a) #7 at its prefill
    shape; (b) lockstep serving at full depth (`lm_path`: 4 x 2048 + 32,
    float32 then int8 adapter, exact launch counts, the first prefill's #7
    launches on their inputs, the bf16 comparison with the plain path as
    statistics); (c) 2 layers (the dense one and a MoE one) in float32
    against the plain path (`lm_depth2_matches`: 1e-4 of the largest
    logit, the same tokens and expert choices); (d) the pool's two
    contracts (`moe_pool`); (e) the serve CLI at its defaults; (f) a fresh
    process's profile (`moe_profile`).  Returns (report, the timed
    lockstep runs' launches)."""
    import torch
    work = ROOT / "build" / "chip_smoke_moe"
    work.mkdir(parents=True, exist_ok=True)
    fresh = Fresh("moe-profile", work)
    out = {"attention": arch_attention(dev, results)}
    gc.collect()
    torch.cuda.empty_cache()
    out["lockstep"], launches = lm_path(dev, counters, every, results,
                                        MOE_ARCH, profile=False)
    gc.collect()
    torch.cuda.empty_cache()
    lm_depth2_matches(dev, MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    out["pool"] = moe_pool(dev, results)
    out["serve_cli_default"] = serve_cli_default(results, MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    out["profile"] = prof = fresh.result(lambda line: line.startswith(
        ("    ", "  prefill", "  decode")))
    smi = nvidia_smi()
    for mode in ("float32", "int8"):
        r = out["lockstep"][mode]
        log(f"  {MOE_ARCH} serve {mode} ({smi}): prefill "
            f"{r['prefill_ms']:.1f} ms, decode p50 {r['decode_ms_p50']:.2f} "
            f"ms, {r['tokens_per_s']:.1f} tokens/s")
    for what in ("prefill", "decode"):
        p = prof.get(what, {})
        if p.get("idle_share") is not None:
            log(f"  {MOE_ARCH} profile ({smi}), {what}: idle share "
                f"{p['idle_share']:.3f}, {p['kernel_launches_per_step']:.0f} "
                f"device ops a step")
    return out, launches


# ---- phase 16: the int8 KV cache on qwen1.5-32b, and the other dense archs --

KVQ_ARCH = "qwen1.5-32b"
KVQ_ATTN = (LM_BATCH, 2048, 40, 40, 128)       # B, S, H, HKV, D at qwen1.5
KVQ_OTHERS = ("internlm2-20b", "pixtral-12b", "musicgen-medium")
KVQ_B_GEN = 16                  # (b): one prompt of 2048, 16 tokens
KVQ_OTHER_GEN = 8               # (e): 4 x 2048 + 8 on each other arch
KVQ_POOL_STEPS = 8              # (d): the probe's steps, alone and churned
KVQ_CODE_SHARE = 1e-3           # (c): codes off the plain path's, at most
KVQ_RANGES = ("quantize_kv", "dequantize_kv", "_decode_attend")


def tree_bytes(plan):
    """Bytes of every leaf of a plan (nothing allocated)."""
    from repro_torch.models.config import torch_dtype
    from repro_torch.models.layers import leaves
    return sum(math.prod(d.shape) * torch_dtype(d.dtype).itemsize
               for d in leaves(plan))


def cache_bytes(cfg, batch, max_len):
    """Bytes of the attention caches (K/V and, int8, their scale planes)
    of the decode cache `cache_plan` plans."""
    from repro_torch.models.transformer import cache_plan
    return tree_bytes([seg for seg in cache_plan(cfg, batch, max_len)[
        "segments"] if "k" in seg])


def gib(n):
    return n / 2**30


def host_copy(tree):
    """A session tree copied to the host, to compare later without
    holding its device memory."""
    from repro_torch.checkpoint import manager as TM
    return TM.tree_map(lambda t: t.cpu(), tree)


def host_diff(tree, want):
    """`first_diff` of a device tree against a host copy."""
    return first_diff(host_copy(tree), want)


@contextlib.contextmanager
def attention_held(results, what):
    """Every attention launch inside against `flash_attention_plain` on
    its own inputs, as it happens (a full-width prefill's 64 launches'
    inputs would not fit beside the weights if kept), one stream at a time
    (the plain version's float32 scores of all 4 streams of 40 heads over
    2048 positions, 2.5 GiB, would not fit either), at phase 2c's bf16
    tolerance.  Yields {"n": launches held, "err": max |err|}."""
    import torch
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.models import attention as MA
    real, held = MA.attn_op, {"n": 0, "err": 0.0}
    rtol, atol = ATTN_TOL["bfloat16"]

    def check(q, k, v, **kw):
        got = real(q, k, v, **kw)
        for b in range(q.shape[0]):
            want = TA.flash_attention_plain(q[b:b + 1], k[b:b + 1],
                                            v[b:b + 1], **kw)
            g = got[b:b + 1].float()
            err = float((g - want.float()).abs().max())
            require(torch.allclose(g, want.float(), rtol=rtol, atol=atol),
                    f"flash_attention {what}: launch {held['n']} at "
                    f"{tuple(q.shape)} differs from the plain version in "
                    f"stream {b} (max err {err})")
            held["err"] = max(held["err"], err)
            del want, g
        held["n"] += 1
        return got

    with mock.patch.object(MA, "attn_op", check):
        yield held
    results["flash_attention"]["max_abs_err"] = max(
        results["flash_attention"]["max_abs_err"], held["err"])
    log(f"  flash_attention  {what}: all {held['n']} launches against the "
        f"plain version on their inputs, max |err| {held['err']:.3g}")


def kvq_model(dev, arch=KVQ_ARCH, **over):
    """``arch`` at full width with the int8 adapter at N = 128 (readout
    scale set) and ``over``; random weights from `SEED`."""
    import torch
    from repro_torch.models import factory
    cfg = lm_config(arch)[0].with_(plastic_adapter=True, adapter_neurons=128,
                                   adapter_quant=True, **over)
    model = factory.build(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED + 41))
    params["adapter"]["scale"].fill_(POOL_SCALE)
    torch.cuda.synchronize()
    log(f"  {arch}: {model.n_params() / 1e9:.3f} B parameters "
        f"({gib(torch.cuda.memory_allocated()):.2f} GiB allocated), random "
        f"init in {time.perf_counter() - t0:.1f} s")
    return model, params


def kvq_prompts(cfg, batch, length, dev, seed=SEED + 42):
    """Random prompts; an embeddings arch's through the stub frontend."""
    import torch
    from repro_torch.launch import serve
    toks = torch.randint(0, cfg.vocab, (batch, length),
                         generator=torch.Generator(dev).manual_seed(seed),
                         device=dev)
    return (serve.embed_stub(toks, cfg) if cfg.input_mode == "embeddings"
            else toks)


def kvq_generate(cfg, params, prompts, gen, counters, results=None,
                 held=None):
    """One untimed `serve.generate` of 2 tokens (``held``: its prefill's
    attention launches held against the plain version, `attention_held`),
    then a timed one of ``gen``: counters set to 0 just before it and read
    just after, the peak memory of the timed run.  Returns (tokens,
    report, cache)."""
    import torch
    from repro_torch.launch import serve
    s = prompts.shape[1]
    with (attention_held(results, held) if held
          else contextlib.nullcontext({"n": 0})) as h:
        serve.generate(cfg, params, prompts, s + 2, 2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    toks, lats, cache, prefill_s = serve.generate(cfg, params, prompts,
                                                  s + gen, gen)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    p50 = sorted(lats)[len(lats) // 2] * 1e3
    return toks, dict(prefill_ms=prefill_s * 1e3, decode_ms_p50=p50,
                      decode_ms_mean=sum(lats) / len(lats) * 1e3,
                      tokens_per_s=prompts.shape[0] * len(lats) / sum(lats),
                      peak_bytes=torch.cuda.max_memory_allocated(),
                      launches=launches, prefill_attention_held=h["n"]), \
        cache


def kvq_launches_exact(cfg, launches, gen, what):
    """Exact launches of a prefill and ``gen`` decode steps: #7 as
    `lm_config` counts it, silu per forward, one fleet step a step."""
    _, mixers = lm_config(cfg.name)
    want = {m.__name__: n for m, n in mixers.items()}
    want.update(silu=silu_per_forward(cfg) * (1 + gen),
                fleet_step_q=gen, fleet_step=0, ssd_scan=0)
    for name, n in want.items():
        require(launches.get(name, 0) == n,
                f"{what}: {launches.get(name, 0)} {name} launches, want {n}")


def kvq_lockstep(dev, model, params, counters, results):
    """(a) 4 x 2048 + 32 on full-depth qwen1.5-32b, bf16, the int8 cache
    and the int8 adapter: the warm-up's prefill holds every #7 launch
    against its plain version; the timed run's launches exact, its peak
    memory beside the cache's bytes by the plan."""
    import torch
    cfg = model.cfg
    prompts = kvq_prompts(cfg, LM_BATCH, LM_PROMPT, dev)
    toks, out, cache = kvq_generate(cfg, params, prompts, LM_GEN, counters,
                                    results, f"{KVQ_ARCH} int8-cache prefill")
    require(out["prefill_attention_held"] == cfg.n_layers,
            f"{out['prefill_attention_held']} attention launches held in "
            f"one prefill, want {cfg.n_layers}")
    kvq_launches_exact(cfg, out["launches"], LM_GEN, "(a)")
    seg = cache["segments"][0]
    require(seg["k"].dtype == torch.int8 and seg["k_scale"].dtype ==
            torch.float32 and int(cache["index"]) == LM_PROMPT + LM_GEN,
            "(a): the cache is not the int8 cache at its length")
    require(tuple(toks.shape) == (LM_BATCH, LM_GEN)
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
            and float(cache["adapter"]["w_fast"].float().abs().max()) > 0,
            "(a): bad tokens, or the adapter did not move")
    out.update(cache_bytes=cache_bytes(cfg, LM_BATCH, LM_PROMPT + LM_GEN),
               cache_bytes_bf16=cache_bytes(cfg.with_(kv_quant=False),
                                            LM_BATCH, LM_PROMPT + LM_GEN))
    del cache
    log(f"  (a) {KVQ_ARCH} int8 cache, 4 x {LM_PROMPT} + {LM_GEN}: prefill "
        f"{out['prefill_ms']:.1f} ms, decode p50 {out['decode_ms_p50']:.2f} "
        f"ms, {out['tokens_per_s']:.1f} tokens/s, peak "
        f"{gib(out['peak_bytes']):.2f} GiB (cache {gib(out['cache_bytes']):.2f}"
        f" GiB by the plan; bf16 {gib(out['cache_bytes_bf16']):.2f} GiB); "
        f"launches {out['launches']}")
    return out


def kvq_against_bf16(dev, model, params, counters, lock, weights, free):
    """(b) one prompt of 2048 and 16 tokens with the int8 cache and with
    the bf16 cache: decode p50, peak memory and greedy agreement; then
    what (a) would need with the bf16 cache beside the card's free memory
    after the weights, computed, and (a) run with the bf16 cache."""
    cfg = model.cfg
    prompts = kvq_prompts(cfg, 1, LM_PROMPT, dev, seed=SEED + 43)
    out, toks = {}, {}
    for kv in (True, False):
        mode = "int8" if kv else "bfloat16"
        toks[mode], out[mode], cache = kvq_generate(
            cfg.with_(kv_quant=kv), params, prompts, KVQ_B_GEN, counters)
        out[mode]["cache_bytes"] = cache_bytes(cfg.with_(kv_quant=kv), 1,
                                               LM_PROMPT + KVQ_B_GEN)
        del cache
        r = out[mode]
        log(f"  (b) {mode:8s} cache, 1 x {LM_PROMPT} + {KVQ_B_GEN}: decode "
            f"p50 {r['decode_ms_p50']:.2f} ms, peak {gib(r['peak_bytes']):.2f}"
            f" GiB (cache {gib(r['cache_bytes']):.3f} GiB)")
    out["greedy_agreement"] = float(
        (toks["int8"] == toks["bfloat16"]).float().mean())
    # (a) with the bf16 cache: its cache, and what (a)'s run held beyond
    # the weights and the int8 cache
    work = lock["peak_bytes"] - weights - lock["cache_bytes"]
    need = lock["cache_bytes_bf16"] + work
    out["a_with_bf16"] = dict(cache_bytes=lock["cache_bytes_bf16"],
                              work_bytes=work, need_bytes=need,
                              free_after_weights=free, fits=need < free)
    log(f"  (b) greedy agreement int8 vs bf16 cache: "
        f"{out['greedy_agreement']:.3f}; (a) with the bf16 cache would need "
        f"{gib(lock['cache_bytes_bf16']):.2f} GiB of cache + "
        f"{gib(work):.2f} GiB of work = {gib(need):.2f} GiB beside "
        f"{gib(free):.2f} GiB free after the weights: computed "
        f"{'fits' if need < free else 'does not fit'}")
    out["a_with_bf16"]["run"] = kvq_lockstep_bf16(dev, cfg, params, counters)
    return out


def kvq_lockstep_bf16(dev, cfg, params, counters):
    """(a)'s 4 x 2048 + 32 with the bf16 cache, run: its peak memory and
    decode p50, or the allocation it failed on."""
    import torch
    prompts = kvq_prompts(cfg, LM_BATCH, LM_PROMPT, dev)
    try:
        _, r, cache = kvq_generate(cfg.with_(kv_quant=False), params,
                                   prompts, LM_GEN, counters)
        del cache
        run = dict(fits=True, peak_bytes=r["peak_bytes"],
                   prefill_ms=r["prefill_ms"],
                   decode_ms_p50=r["decode_ms_p50"])
        log(f"  (b) (a) with the bf16 cache, run: fits, peak "
            f"{gib(r['peak_bytes']):.2f} GiB, prefill {r['prefill_ms']:.1f} "
            f"ms, decode p50 {r['decode_ms_p50']:.2f} ms")
    except torch.cuda.OutOfMemoryError as e:
        run = dict(fits=False, error=str(e).splitlines()[0][:300])
        log(f"  (b) (a) with the bf16 cache, run: out of memory "
            f"({run['error']})")
    del prompts
    gc.collect()
    torch.cuda.empty_cache()
    return run


def kvq_copy_ms(dev, cfg):
    """Device ms of the decode attention's per-layer passes over the
    whole cache at (a)'s 4 x 2080: the float32 copy of one layer's bf16
    K (what `_decode_attend` makes of K and of V), and the dequantisation
    of one layer's int8 K; times 2 x n_layers for a step."""
    import torch
    from repro_torch.models import attention as MA
    gen = torch.Generator(dev).manual_seed(SEED + 44)
    shape = (LM_BATCH, LM_PROMPT + LM_GEN, cfg.n_kv_heads, cfg.hd)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q, sc = MA.quantize_kv(x)
    f32 = device_ms(lambda: x.float())
    deq = device_ms(lambda: MA.dequantize_kv(q, sc, torch.bfloat16))
    n = 2 * cfg.n_layers
    out = dict(float_copy_ms_per_layer=f32, dequantize_ms_per_layer=deq,
               float_copy_ms_per_step=f32 * n,
               dequantize_ms_per_step=deq * n)
    log(f"  (b) at 4 x {LM_PROMPT + LM_GEN}, one layer's K: float32 copy "
        f"{f32:.4f} ms, int8 dequantisation {deq:.4f} ms (L2 flushed); "
        f"x {n} a step: {f32 * n:.2f} ms and {deq * n:.2f} ms")
    del x, q, sc
    return out


def kvq_shallow(dev):
    """(c) qwen1.5-32b at `shallow` depth, full width, float32, int8
    cache, int8 adapter: the kernel path against the plain path, the same
    greedy tokens, logits within 1e-4 of the largest, and the share of
    int8 codes that differ at most `KVQ_CODE_SHARE` (float32 sums in
    another order move a code only at a rounding tie), each by one."""
    import torch
    from repro_torch.models import factory
    cfg = shallow(lm_config(KVQ_ARCH)[0]).with_(
        dtype="float32", kv_quant=True, plastic_adapter=True,
        adapter_neurons=128, adapter_quant=True)
    gen = torch.Generator(dev).manual_seed(SEED + 45)
    params = factory.build(cfg).init(gen)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    got, toks, gc_ = serve_logits(cfg, params, prompts, LM_GEN,
                                  keep_cache=True)
    with contextlib.ExitStack() as stack:
        for p in plain_kernels():
            stack.enter_context(p)
        want, _, wc = serve_logits(cfg, params, prompts, LM_GEN, toks,
                                   keep_cache=True)
    err = rel_err(got, want)
    same = all(torch.equal(g.argmax(-1), w.argmax(-1))
               for g, w in zip(got, want))
    differ = total = worst = 0
    for name in ("k", "v"):
        a = gc_["segments"][0][name].int()
        b = wc["segments"][0][name].int()
        differ += int((a != b).sum())
        total += a.numel()
        worst = max(worst, int((a - b).abs().max()))
    share = differ / total
    require(err <= 1e-4 and same,
            f"(c) {cfg.n_layers}-layer float32 int8 cache: kernel path "
            f"differs from the plain path (max rel logit diff {err:.3g}, "
            f"greedy tokens {'equal' if same else 'differ'})")
    require(share <= KVQ_CODE_SHARE and worst <= 1,
            f"(c): {share:.3g} of the int8 codes differ from the plain "
            f"path's (by up to {worst}), bound {KVQ_CODE_SHARE}")
    log(f"  (c) {KVQ_ARCH}, {cfg.n_layers} layers, float32, int8 cache: max "
        f"rel logit diff {err:.3g} over prefill + {LM_GEN} steps, greedy "
        f"tokens equal; {differ} of {total} int8 codes ({share:.3g}) differ "
        f"from the plain path's, by at most {worst} (bound "
        f"{KVQ_CODE_SHARE})")
    del params, got, want, gc_, wc
    torch.cuda.empty_cache()
    return dict(max_rel_logit_diff=err, codes_differ=differ,
                codes=total, share=share)


def kvq_pool(dev, model, params, counters, results, tmp):
    """(d) An `LMScheduler` on full-width qwen1.5-32b with the int8 cache
    and the int8 adapter, 8 slots of 1024: Q serves the probe alone for 8
    steps, then 4 more; W takes the probe's session at Q's boundary
    through a RAM store and runs one window of those 4 tokens; C serves
    the probe beside 6 residents (slot 7 vacant), 2 replaced after 4
    steps, then moves the probe through disk into the slot a resident
    left and runs the same window.  Held bit for bit: the probe's tokens and session
    under churn equal Q's, the window equals the 4 steps (greedy tokens
    and session), the session back from disk equals the one that left, C's
    window equals W's, and the vacant slot's codes and scales stay
    frozen.  Launches exact; every admission's #7 launch held against
    its plain version as it happens."""
    import numpy as np
    import torch
    from repro_torch.serving import LMScheduler, SessionStore
    cfg = model.cfg
    prompts = pool_prompts(cfg.vocab, dev)
    steps, k = KVQ_POOL_STEPS, POOL_K

    def make(store):
        return LMScheduler(model, params, POOL_SLOTS, POOL_MAX_LEN,
                           store=store)

    mem = {}

    def note(what):
        mem[what] = torch.cuda.memory_allocated()

    note("start")
    ram = SessionStore(capacity=1)
    q = make(ram)
    q.admit_prompt("probe", prompts["probe"])
    q_toks = [q.step()["probe"] for _ in range(steps)]
    q_sess = host_copy(q.session_view("probe"))
    q.evict("probe")
    q.admit_prompt("probe", prompts["probe"])        # the warm copy
    first = q.pending("probe")
    q_next = [q.step()["probe"] for _ in range(k)]
    q_after = host_copy(q.session_view("probe"))
    note("q")
    del q
    gc.collect()
    w = make(ram)
    w.admit_prompt("probe", prompts["probe"])        # the archived copy
    require(ram.restores == 1 and ram.warm_hits == 1,
            "(d): the boundary state did not move through the store")
    window = np.array([first] + q_next[:-1])
    w_logits = w.decode_window({"probe": window})["probe"].clone()
    w_after = host_copy(w.session_view("probe"))
    note("w")
    del w
    gc.collect()
    torch.cuda.empty_cache()
    note("before_c")
    require(w_logits.argmax(-1).tolist() == q_next
            and first_diff(w_after, q_after) is None,
            f"(d): the window of {k} differs from {k} steps (tokens "
            f"{w_logits.argmax(-1).tolist()} vs {q_next}, session at "
            f"{first_diff(w_after, q_after)})")
    del q_after

    timer = PoolTimer()
    c = make(SessionStore(capacity=0))       # evicted sessions to the host
    note("c")
    users = iter(f"u{i}" for i in range(1, POOL_USERS))
    fresh = 0

    def arrive(uid):
        nonlocal fresh
        fresh += not c.store.known(uid)
        slot = timer("admit", c.admit_prompt, uid, prompts[uid])
        note(f"admitted {uid}")
        return slot

    for cnt in counters:
        cnt.launches = 0
    with attention_held(results, f"{KVQ_ARCH} pool admissions") as held:
        require(arrive("probe") == 0, "(d): the probe is not in slot 0")
        for _ in range(POOL_RESIDENTS):
            arrive(next(users))
        note("admitted")
        vacant = host_copy(c._take(c.pool, POOL_SLOTS - 1))
        toks = []
        def leave_lru():
            lru = min((s for u, s in c.user_slot.items() if u != "probe"),
                      key=lambda s: c._admit_seq[s])
            c.evict(c.slot_user[lru])

        for t in range(steps):
            if t == steps // 2:
                for _ in range(2):
                    leave_lru()
                for _ in range(2):
                    arrive(next(users))
            toks.append(timer("step", c.step)["probe"])
        note("churned")
        require(toks == q_toks and host_diff(c.session_view("probe"),
                                             q_sess) is None,
                f"(d): the probe under churn differs from the probe alone "
                f"(tokens {'equal' if toks == q_toks else 'differ'})")
        # the probe through disk into the slot a resident leaves
        before = host_copy(c.session_view("probe"))
        leave_lru()
        note("left")
        ram_c, disk = c.store, SessionStore(root=str(tmp))
        c.store = disk
        c.evict("probe")
        disk._warm.clear()
        c.store = ram_c
        arrive(next(users))                         # takes the probe's slot
        c.store = disk
        slot = c.admit_prompt("probe", prompts["probe"])
        c.store = ram_c
        require(slot != 0 and disk.restores == 1
                and host_diff(c.session_view("probe"), before) is None,
                f"(d): the probe did not come back from disk bit for bit "
                f"into another slot (slot {slot})")
        # C's window from Q's boundary state: the probe's session is Q's
        # at the boundary, so the probe's window must equal W's
        windows = {u: np.full(k, c.pending(u)) for u in c.user_slot}
        windows["probe"] = window
        c_logits = timer("window", c.decode_window, windows)["probe"]
        torch.cuda.synchronize()
    launches = {cnt.__name__: cnt.launches for cnt in counters}
    require(torch.equal(c_logits, w_logits)
            and host_diff(c.session_view("probe"), w_after) is None,
            "(d): the probe's window under churn differs from W's")
    for x, y in zip(tree_leaves(vacant), tree_leaves(host_copy(c._take(
            c.pool, POOL_SLOTS - 1)))):
        require(torch.equal(x, y), "(d): the vacant slot's row moved")
    seg = vacant["cache"]["segments"][0]
    want = {"flash_attention": cfg.n_layers * fresh, "fleet_step_q": steps,
            "rollout": 1, "silu": silu_per_forward(cfg) * (fresh + steps
                                                           + k)}
    for name, n in want.items():
        require(launches[name] == n, f"(d): {launches[name]} {name} "
                f"launches in the pool's run, want {n}")
    require(held["n"] == launches["flash_attention"],
            f"(d): {held['n']} attention launches held, "
            f"{launches['flash_attention']} launched")
    out = dict(launches=launches, fresh_admissions=fresh,
               admit_ms_p50=timer.p50_ms("admit"),
               step_ms_p50=timer.p50_ms("step"),
               window_ms_per_token=timer.p50_ms("window") / k,
               pool_nbytes=c.pool_nbytes(),
               vacant_frozen=[tuple(seg["k"].shape), tuple(
                   seg["k_scale"].shape)],
               allocated_gib={k: gib(v) for k, v in mem.items()})
    log(f"  (d) {KVQ_ARCH} pool, int8 cache and adapter, {POOL_SLOTS} x "
        f"{POOL_MAX_LEN}: the probe under churn equals the probe alone, "
        f"the window of {k} its steps, the session back from disk and C's "
        f"window W's, bit for bit; the vacant slot's codes and scales "
        f"frozen; {fresh} admissions (p50 {out['admit_ms_p50']:.1f} ms), "
        f"step p50 {out['step_ms_p50']:.1f} ms, window "
        f"{out['window_ms_per_token']:.1f} ms a token, pool "
        f"{gib(c.pool_nbytes()):.2f} GiB; launches {launches}; allocated "
        f"{gib(min(mem.values())):.2f}-{gib(max(mem.values())):.2f} GiB "
        f"over the {len(mem)} stages and admissions")
    del c, vacant, before, q_sess, w_after
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kvq_other_archs(dev, counters, results):
    """(e) internlm2-20b with the int8 cache, pixtral-12b and
    musicgen-medium through the embeddings prompt: one 4 x 2048 + 8 each
    at full width, every #7 launch of the warm-up's prefill held against
    its plain version, launches exact, each model freed before the next; then
    qwen2-72b at smoke scale on the card beside its full-width plan's
    bytes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import factory, transformer
    out = {}
    for arch in KVQ_OTHERS:
        over = {"kv_quant": True} if arch == "internlm2-20b" else {}
        model, params = kvq_model(dev, arch, **over)
        cfg = model.cfg
        prompts = kvq_prompts(cfg, LM_BATCH, LM_PROMPT, dev)
        toks, r, cache = kvq_generate(cfg, params, prompts, KVQ_OTHER_GEN,
                                      counters, results, f"{arch} prefill")
        require(r["prefill_attention_held"] == cfg.n_layers,
                f"(e) {arch}: {r['prefill_attention_held']} attention "
                f"launches held in one prefill, want {cfg.n_layers}")
        kvq_launches_exact(cfg, r["launches"], KVQ_OTHER_GEN, f"(e) {arch}")
        require(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
                f"(e) {arch}: bad tokens")
        r.update(kv_quant=cfg.kv_quant, input_mode=cfg.input_mode,
                 n_params=model.n_params())
        out[arch] = r
        log(f"  (e) {arch} ({'int8' if cfg.kv_quant else 'bf16'} cache, "
            f"{cfg.input_mode} prompt), 4 x {LM_PROMPT} + {KVQ_OTHER_GEN}: "
            f"prefill {r['prefill_ms']:.1f} ms, decode p50 "
            f"{r['decode_ms_p50']:.2f} ms, {r['tokens_per_s']:.1f} tokens/s, "
            f"peak {gib(r['peak_bytes']):.2f} GiB; launches {r['launches']}")
        del model, params, prompts, cache, toks
        gc.collect()
        torch.cuda.empty_cache()
    # qwen2-72b: its full-width plan, then its smoke config on the card
    full = get_config("qwen2-72b")
    plan_bytes = tree_bytes(transformer.plan(full))
    total = torch.cuda.mem_get_info()[1]
    model = factory.build("qwen2-72b", smoke=True, kv_quant=True)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 46))
    prompts = kvq_prompts(model.cfg, LM_BATCH, 64, dev)
    for c in counters:
        c.launches = 0
    _, _, cache, _ = serve.generate(model.cfg, params, prompts,
                                   64 + KVQ_OTHER_GEN, KVQ_OTHER_GEN)
    torch.cuda.synchronize()
    n = {c.__name__: c.launches for c in counters}
    require(n["flash_attention"] == model.cfg.n_layers
            and cache["segments"][0]["k"].dtype == torch.int8,
            f"(e) qwen2-72b smoke: launches {n}")
    out["qwen2-72b"] = dict(
        full_param_bytes=plan_bytes, card_bytes=total,
        full_cache_bytes_int8=cache_bytes(full.with_(kv_quant=True),
                                          LM_BATCH, LM_PROMPT + LM_GEN),
        full_cache_bytes_bf16=cache_bytes(full, LM_BATCH,
                                          LM_PROMPT + LM_GEN),
        smoke_launches=n)
    log(f"  (e) qwen2-72b: {gib(plan_bytes):.1f} GiB of bf16 weights at full "
        f"width beside the card's {gib(total):.1f} GiB (its cache at 4 x "
        f"{LM_PROMPT + LM_GEN}: int8 "
        f"{gib(out['qwen2-72b']['full_cache_bytes_int8']):.2f} GiB, bf16 "
        f"{gib(out['qwen2-72b']['full_cache_bytes_bf16']):.2f} GiB), so it "
        f"runs at smoke scale: int8 cache, 4 x 64 + {KVQ_OTHER_GEN}, "
        f"launches {n}")
    del model, params, cache
    return out


@contextlib.contextmanager
def kvq_ranges():
    """`attention.quantize_kv`, `dequantize_kv` and `_decode_attend` each
    inside a `torch.profiler.record_function` range ``kvq.<name>``."""
    from torch.profiler import record_function
    from repro_torch.models import attention as MA
    with contextlib.ExitStack() as stack:
        for name in KVQ_RANGES:
            real = getattr(MA, name)

            def ranged(*a, _real=real, _name=name, **kw):
                with record_function(f"kvq.{_name}"):
                    return _real(*a, **kw)
            stack.enter_context(mock.patch.object(MA, name, ranged))
        yield


def kvq_profile(dev):
    """``--only kv-quant-profile``: a fresh process's `torch.profiler` of
    `PROFILED_STEPS` decode steps of full-width qwen1.5-32b at (b)'s one
    prompt of 2048, int8 adapter, with the int8 cache and then the bf16
    cache (after a prefill and one untimed step each): idle share, device
    ops a step, and the device time of the quantisation, the
    dequantisation and the decode attention (with its float32 copies of
    the cache), each beside the busy time."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill
    model, params = kvq_model(dev, kv_quant=True)
    prompts = kvq_prompts(model.cfg, 1, LM_PROMPT, dev, seed=SEED + 43)
    out = {}
    for kv in (True, False):
        mode = "int8" if kv else "bfloat16"
        cfg = model.cfg.with_(kv_quant=kv)
        logits, cache = make_prefill(cfg, LM_PROMPT + 8)(params, prompts)
        decode = make_decode_step(cfg)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        _, cache = decode(params, cache, tok)

        def steps():
            nonlocal cache
            for _ in range(PROFILED_STEPS):
                _, cache = decode(params, cache, tok)

        log(f"  {PROFILED_STEPS} decode steps, {mode} cache:")
        with kvq_ranges():
            out[mode] = r = profile_window(steps, PROFILED_STEPS)
        ranges = r.get("annotated_ranges", {})
        busy = r["device_busy_ms"]
        r["kvq"] = {n: dict(device_ms=ranges.get(f"kvq.{n}", {}).get(
            "device_ms", 0.0)) for n in KVQ_RANGES}
        for n, x in r["kvq"].items():
            x["share"] = x["device_ms"] / busy if busy else None
        log(f"  {mode}: " + ", ".join(
            f"{n} {x['device_ms']:.3f} ms"
            + (f" ({x['share']:.3f} of busy)" if x["share"] is not None
               else "") for n, x in r["kvq"].items()))
        del cache
        torch.cuda.empty_cache()
    return out


def kvq_path(dev, results, counters):
    """Phase 16: #7 at qwen1.5-32b's prefill shape; (a) lockstep with the
    int8 cache at full depth; (b) int8 against bf16 cache at one prompt,
    and the cache passes' device time; (d) the pool's contracts; (c) two
    layers in float32 against the plain path; a fresh process's profile;
    (e) the other dense archs.  Returns (report, (a)'s launches)."""
    import tempfile
    import torch
    from repro_torch.kernels.plasticity import fused
    work = ROOT / "build" / "chip_smoke_kv_quant"
    work.mkdir(parents=True, exist_ok=True)
    fresh = Fresh("kv-quant-profile", work)
    out = {"attention": arch_attention(dev, results, KVQ_ARCH, KVQ_ATTN,
                                       "kvq_shape", SEED + 47)}
    _flush_buf.clear()              # its 1 GiB is wanted beside 66 GiB
    gc.collect()
    torch.cuda.empty_cache()
    free0, before = torch.cuda.mem_get_info()[0], torch.cuda.memory_allocated()
    model, params = kvq_model(dev, kv_quant=True)
    torch.cuda.empty_cache()
    weights = torch.cuda.memory_allocated() - before
    free = torch.cuda.mem_get_info()[0]
    out.update(weights_bytes=weights, free_before_weights=free0,
               free_after_weights=free)
    out["lockstep"] = lock = kvq_lockstep(dev, model, params, counters,
                                          results)
    out["against_bf16"] = kvq_against_bf16(dev, model, params, counters,
                                           lock, weights, free)
    out["cache_passes"] = kvq_copy_ms(dev, model.cfg)
    _flush_buf.clear()
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        out["pool"] = kvq_pool(dev, model, params,
                               counters + (fused.rollout,), results, tmp)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    out["profile"] = fresh.result(lambda line: line.startswith(
        ("    ", "  int8", "  bfloat16", f"  {PROFILED_STEPS} ")))
    out["shallow"] = kvq_shallow(dev)
    out["others"] = kvq_other_archs(dev, counters, results)
    smi = nvidia_smi()
    log(f"  {KVQ_ARCH} int8 cache ({smi}): prefill "
        f"{lock['prefill_ms']:.1f} ms, decode p50 "
        f"{lock['decode_ms_p50']:.2f} ms, {lock['tokens_per_s']:.1f} "
        f"tokens/s, peak {gib(lock['peak_bytes']):.2f} GiB")
    return out, lock["launches"]


# ---- phase 17: LM training on the dense layout -------------------------------

TRAIN_ARCH = "qwen3-4b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 3   # train_4k's S; B cut
TRAIN_ATTN = (1, TRAIN_SEQ, 32, 8, 128)    # one microbatch at qwen3-4b
TRAIN_WIDTH_S = 512                        # (a)'s head-width sweep
TRAIN_CLI_STEPS = 6


def attention_bwd_bound(b, sq, skv, h, hkv, d, itemsize):
    """Least time (ms) for the backward of causal attention: q, k, v, o,
    dO and lse read once, dq, dk, dv written once, against 10·D FLOP for
    every visible (query, key) pair (recomputing S, then dP, dV, dK and
    dQ: the five products of the FA2 backward) at the bf16 tensor-core
    peak."""
    off = skv - sq
    pairs = sum(min(skv, i + off + 1) for i in range(sq))
    nbytes = ((4 * b * sq * h * d + 4 * b * skv * hkv * d) * itemsize
              + 4 * b * h * sq)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = 10 * d * b * h * pairs / BF16_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations", tb, to


def bwd_close(got, want, dtype):
    """#7's backward gate: float32 within 1e-5 of each gradient's largest
    |x|, bf16 within rtol 2e-2 / atol 2e-3 (the forward's)."""
    import torch
    if dtype == torch.float32:
        return bool((got - want).abs().max() <= 1e-5 * want.abs().max())
    return torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-3)


def train_attention_case(gen, dev, shape, dtype, results, what):
    """One #7 training case: the forward kernel's o and lse against
    `mha_lse` (o within `ATTN_TOL`, lse within 1e-4), then the backward
    kernel twice (the same bits) against its plain version on that o and
    lse.  Returns the inputs for timing."""
    import torch
    from repro_torch.kernels.attention import kernel as TA
    b, s, h, hkv, d = shape
    q, k, v = attention_inputs(gen, b, s, s, h, hkv, d, dtype, dev)
    do = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    o, lse = TA._forward(q, k, v, True, None, None, with_lse=True)
    o_plain, lse_plain = TA._ref.mha_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    rtol, atol = ATTN_TOL[str(dtype)[6:]]
    o_err = float((o.double() - o_plain.double()).abs().max())
    lse_err = float((lse.double() - lse_plain.double()).abs().max())
    require(torch.allclose(o.float(), o_plain.float(), rtol=rtol, atol=atol),
            f"flash_attention {what} with lse: o differs from the plain "
            f"version (max |err| {o_err:.3g})")
    require(torch.allclose(lse, lse_plain, rtol=1e-4, atol=1e-4),
            f"flash_attention {what}: lse differs from the plain version "
            f"(max |err| {lse_err:.3g})")
    row = results["flash_attention"]
    row["max_abs_err"] = max(row["max_abs_err"], o_err)
    log(f"  flash_attention {what} with lse: o against the plain version, "
        f"max |err| {o_err:.3g}; lse max |err| {lse_err:.3g}")
    del o_plain, lse_plain
    got = TA.flash_attention_bwd(q, k, v, o, lse, do)
    again = TA.flash_attention_bwd(q, k, v, o, lse, do)
    want = TA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        e = float((g.double() - w.double()).abs().max())
        err = max(err, e)
        require(torch.equal(g, a),
                f"flash_attention_bwd {what} {name}: a second launch gave "
                f"other bits")
        require(bwd_close(g, w, dtype),
                f"flash_attention_bwd {what} {name}: differs from the plain "
                f"version (max |err| {e:.3g}, largest |x| "
                f"{float(w.abs().max()):.3g})")
    row = results["flash_attention_bwd"]
    row["max_abs_err"] = max(row["max_abs_err"], err)
    log(f"  flash_attention_bwd {what}: dq, dk, dv against the plain "
        f"version, max |err| {err:.3g}; a second launch the same bits")
    del got, again, want
    return q, k, v, o, lse, do


def bwd_kernel_usage():
    """Each kernel of csrc/flash_attention_bwd.cu as compiled: its
    registers, local (spill) bytes a thread, shared bytes and threads
    from ``cudaFuncGetAttributes`` (through the C entry
    ``flash_attention_bwd_attrs``), and ptxas's spill stores and loads
    from the build's log."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as TA
    usage = TA.flash_attention_bwd_attrs()
    text = _build.build_all()["log"].get("flash_attention_bwd.cu", "")
    spills = {f"{m.group(1)}<{m.group(2)}>": v
              for k, v in ptxas_usage(text).items()
              for m in [re.search(r"(dq_wgmma_kernel|dkdv_wgmma_kernel|"
                                  r"dq_kernel|dkdv_kernel)ILi(\d+)E", k)]
              if m}
    for name, u in usage.items():
        st, ld = spills.get(name, (None, None, None))[1:3]
        u.update(ptxas_spill_stores=st, ptxas_spill_loads=ld)
        log(f"  {name}: {u['registers']} registers at launch, "
            f"{u['local_bytes']} local (spill) bytes a thread, "
            f"{u['shared_bytes']} shared bytes, {u['threads']} threads; "
            f"ptxas spills {st} bytes stored, {ld} loaded")
    return usage


def train_attention(dev, results):
    """(a): #7's backward at qwen3-4b's training shape in bf16, and at
    every head width at S = 512 in float32 and bf16, against its plain
    version; its time per layer (L2 flushed) beside its plain version,
    the bound by operations and the backward of
    `scaled_dot_product_attention` on the same inputs (timed only, never
    on the path); the forward with its lse beside it; each kernel's
    registers and spills."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel as TA
    results["flash_attention_bwd"]["kernels"] = bwd_kernel_usage()
    gen = torch.Generator(dev).manual_seed(SEED + 60)
    for d in TA.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            train_attention_case(gen, dev, (2, TRAIN_WIDTH_S, 8, 2, d),
                                 dtype, results,
                                 f"{str(dtype)[6:]} D={d} S={TRAIN_WIDTH_S}")
    torch.cuda.empty_cache()
    q, k, v, o, lse, do = train_attention_case(
        gen, dev, TRAIN_ATTN, torch.bfloat16, results,
        f"bf16 {TRAIN_ARCH} training {TRAIN_ATTN}")
    ms = device_ms(lambda: TA.flash_attention_bwd(q, k, v, o, lse, do),
                   reps=5)
    plain = device_ms(lambda: TA.flash_attention_bwd_plain(q, k, v, o, lse,
                                                           do), reps=3)
    fwd = device_ms(lambda: TA._forward(q, k, v, True, None, None,
                                        with_lse=True), reps=5)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    lib = device_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                retain_graph=True), reps=5)
    # each of the two kernels alone, by `torch.profiler` (None where the
    # profiler saw no launch of it)
    by_kernel = {name: profiled_ms(
        lambda: TA.flash_attention_bwd(q, k, v, o, lse, do), "write",
        kernel=name, calls=5)[0]
        for name in ("dq_wgmma_kernel", "dkdv_wgmma_kernel")}
    bms, kind, tb, to = attention_bwd_bound(*TRAIN_ATTN[:1], TRAIN_SEQ,
                                            TRAIN_SEQ, *TRAIN_ATTN[2:], 2)
    tflops = to * BF16_OPS_PER_S / 1e3 / ms / 1e9
    results["flash_attention_bwd"].update(
        shape=dict(zip(("B", "S", "H", "HKV", "D"), TRAIN_ATTN)), ms=ms,
        plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=kind,
        tflops=tflops, forward_with_lse_ms=fwd, by_kernel_ms=by_kernel)
    log("  flash_attention_bwd bf16 by kernel (torch.profiler, L2 "
        "flushed): " + ", ".join(
            f"{n} " + ("not seen" if t is None else f"{t:.4f} ms")
            for n, t in by_kernel.items()))
    log(f"  flash_attention_bwd bf16 {TRAIN_ATTN} (one layer of a "
        f"microbatch): {ms:.4f} ms (bound {bms:.4f} ms by {kind}: bytes "
        f"{tb:.4f} ms, operations {to:.4f} ms at 10·D FLOP a pair), "
        f"{tflops:.1f} TFLOP/s, {ms / bms:.1f}x the bound; plain "
        f"{plain:.4f} ms; SDPA's backward {lib:.4f} ms ({ms / lib:.2f}x); "
        f"the forward with lse {fwd:.4f} ms")
    del q, k, v, o, lse, do, qt, kt, vt, out, dot
    torch.cuda.empty_cache()


def train_silu(dev, results):
    """(b): silu's backward bit for bit against `silu_bwd_plain` at the
    MLP of one training microbatch (4096 rows) of qwen3-4b and of the
    other dense archs, bf16 and float32 at qwen3-4b; timed at qwen3-4b
    beside its plain version and its bound by bytes (g, u and dy read
    once, dg and du written once)."""
    import torch
    from repro_torch.models import layers as ML
    gen = torch.Generator(dev).manual_seed(SEED + 61)
    cases = [(TRAIN_ARCH, "bfloat16"), (TRAIN_ARCH, "float32")] + [
        (a, "bfloat16") for a in ("qwen2-72b", "internlm2-20b",
                                  "qwen1.5-32b", "musicgen-medium",
                                  "pixtral-12b")]
    for arch, dt in cases:
        d_ff = lm_config(arch)[0].d_ff
        dtype = getattr(torch, dt)
        g, u, dy = (torch.randn(TRAIN_SEQ, d_ff, generator=gen,
                                device=dev).mul_(s).to(dtype)
                    for s in (4, 1, 0.5))
        got = ML.silu_bwd(g, u, dy)
        want = ML.silu_bwd_plain(g, u, dy)
        torch.cuda.synchronize()
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        results["silu_bwd"]["max_abs_err"] = max(
            results["silu_bwd"]["max_abs_err"], err)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"silu_bwd {arch} {dt} ({TRAIN_SEQ}, {d_ff}): differs from "
                f"its plain version (max err {err})")
        log(f"  silu_bwd {arch} mlp {dt} ({TRAIN_SEQ}, {d_ff}): dg and du "
            f"bit for bit")
        if arch == TRAIN_ARCH and dt == "bfloat16":
            ms = device_ms(lambda: ML.silu_bwd(g, u, dy))
            plain = device_ms(lambda: ML.silu_bwd_plain(g, u, dy))
            n = TRAIN_SEQ * d_ff
            # neg, exp, add, divide, 8 multiplies and adds, the rounding
            bms, kind = bound(5 * 2 * n, 14 * n)
            results["silu_bwd"].update(
                shape=dict(rows=TRAIN_SEQ, d_ff=d_ff, dtype=dt), ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=bms,
                bound_by=kind)
            log(f"  silu_bwd bf16 ({TRAIN_SEQ}, {d_ff}): {ms:.4f} ms (bound "
                f"{bms:.4f} ms by {kind}, {bms / ms:.0%} of the memory "
                f"rate); plain {plain:.4f} ms")
        del g, u, dy, got, want
    torch.cuda.empty_cache()


def train_adamw(dev, results):
    """(b): AdamW's kernel bit for bit against `adamw_leaf_plain` (the
    parameter and both moments, two steps) at qwen3-4b's leaves as the
    step hands them over (bf16 parameters, float32 grads and moments,
    clipped, weight decay): the stacked MLP weight (36 x 2560 x 9728),
    the embedding and a stacked norm; and at 10^6 + 3 elements with a
    float32 master copy and bf16 moments.  Timed at the largest leaf (L2
    flushed) beside its plain version and its bound by bytes (p, g, m, v
    read once, p, m, v written once).  ``library_ms`` is null:
    ``torch._fused_adamw_`` takes grads and moments only in the
    parameters' dtype."""
    import torch
    from repro_torch.optim import optimizers as O
    cfg = lm_config(TRAIN_ARCH)[0]
    gen = torch.Generator(dev).manual_seed(SEED + 63)
    f32, bf16 = torch.float32, torch.bfloat16
    big = cfg.n_layers * cfg.d_model * cfg.d_ff
    cases = [(big, bf16, f32, f32, False), (cfg.vocab * cfg.d_model, bf16,
                                            f32, f32, False),
             (cfg.n_layers * cfg.d_model, bf16, f32, f32, False),
             (10 ** 6 + 3, f32, f32, bf16, True)]

    def scalars(step):
        st = torch.full((), step, dtype=f32, device=dev)
        return dict(scale=torch.full((), 0.37, device=dev),
                    bc1=1 - 0.9 ** st, bc2=1 - 0.95 ** st,
                    lr=torch.full((), 3e-4, device=dev), b1=0.9, b2=0.95,
                    eps=1e-8, wd=0.1)

    for n, pdt, gdt, mdt, master in cases:
        p = torch.randn(n, generator=gen, device=dev).to(pdt)
        m = (1e-3 * torch.randn(n, generator=gen, device=dev)).to(mdt)
        v = (1e-3 * torch.randn(n, generator=gen, device=dev)).square_() \
            .to(mdt)
        w = p.float().clone() if master else None
        twin = [None if t is None else t.clone() for t in (p, m, v, w)]
        for step in (1, 2):
            g = (1e-2 * torch.randn(n, generator=gen, device=dev)).to(gdt)
            O.adamw_leaf(p, g, m, v, w, **scalars(step))
            O.adamw_leaf_plain(twin[0], g, *twin[1:], **scalars(step))
            torch.cuda.synchronize()
            for name, a, b in zip("pmvw", (p, m, v, w), twin):
                if a is None:
                    continue
                err = float((a.double() - b.double()).abs().max())
                results["adamw"]["max_abs_err"] = max(
                    results["adamw"]["max_abs_err"], err)
                require(torch.equal(a, b),
                        f"adamw n={n} {pdt}/{gdt}/{mdt} master={master} "
                        f"step {step}: {name} differs from its plain "
                        f"version (max err {err})")
        log(f"  adamw n={n} (p {str(pdt)[6:]}, g {str(gdt)[6:]}, moments "
            f"{str(mdt)[6:]}, master {master}): p, m, v bit for bit, two "
            f"steps")
        if n == big:
            kw = scalars(3)
            ms = device_ms(lambda: O.adamw_leaf(p, g, m, v, w, **kw))
            plain = device_ms(lambda: O.adamw_leaf_plain(
                twin[0], g, *twin[1:], **kw), reps=3)
            # bf16 p read and written, float32 g read, float32 m and v
            # read and written; a dozen float and four double operations
            bms, kind = bound(n * (2 * 2 + 4 + 2 * 4 * 2), 16 * n)
            results["adamw"].update(
                shape=dict(n=n, params="bfloat16", grads="float32",
                           moments="float32"),
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms,
                bound_by=kind)
            log(f"  adamw n={n} ({cfg.n_layers} x {cfg.d_model} x "
                f"{cfg.d_ff}): {ms:.4f} ms (bound {bms:.4f} ms by {kind}, "
                f"{bms / ms:.0%} of the memory rate); plain {plain:.4f} ms")
        del p, m, v, w, g, twin
        torch.cuda.empty_cache()


def train_counts():
    """(#8 forward, #8 backward, #7 forward, #7 backward, silu, silu
    backward, AdamW) launches so far."""
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import layers as ML
    from repro_torch.optim import optimizers as O
    return (SK.ssd_scan.launches, SK.ssd_scan.bwd_launches,
            TA.flash_attention.launches, TA.flash_attention.bwd_launches,
            ML.silu.launches, ML.silu.bwd_launches, O.adamw_leaf.launches)


def zero_train_counts():
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import layers as ML
    from repro_torch.optim import optimizers as O
    for fn in (TA.flash_attention, SK.ssd_scan, ML.silu):
        fn.launches = fn.bwd_launches = 0
    O.adamw_leaf.launches = 0


def train_launches(cfg, microbatches, leaves):
    """`train_counts` a step with remat on, each microbatch: every dense
    block and every use of a zsuper's shared block #7 and silu twice (its
    forward and the recompute) and their backwards once; a MoE block #7
    the same and silu twice for each of its SwiGLUs (the routed experts',
    and the shared experts' if it has them); every Mamba2 block #8 twice
    and its backward once, silu 4 times (the conv's and the gate's,
    twice) and its backward twice; AdamW once a leaf."""
    from repro_torch.models.transformer import segments
    n_ssm = n_attn = n_mlp = 0
    for kind, count in segments(cfg):
        if kind == "ssm":
            n_ssm += count
            continue
        n_attn += count
        n_mlp += count * (1 + bool(cfg.moe.n_shared) if kind == "moe" else 1)
        if kind == "zsuper":
            n_ssm += count * (cfg.ssm.attn_every - 1)
    mb = microbatches
    return (2 * mb * n_ssm, mb * n_ssm, 2 * mb * n_attn, mb * n_attn,
            mb * (4 * n_ssm + 2 * n_mlp), mb * (2 * n_ssm + n_mlp), leaves)


def smoke_leaves(arch):
    """The number of parameter leaves of ``arch``'s smoke config (AdamW
    launches once a leaf a step), counted on its init on the CPU."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.models import factory
    from repro_torch.optim.optimizers import _leaves
    return len(_leaves(factory.build(get_smoke(arch)).init(
        torch.Generator().manual_seed(0))))


def train_model(dev, steps_=TRAIN_STEPS):
    """Full-width qwen3-4b's training run as `launch.train.build` makes it
    (the arch's TRAIN_SETUP: 2 microbatches, float32 accumulator and
    moments, remat per block, warmup-cosine), random init from the seed:
    (cfg, step_fn, params, opt_state, the token pipeline)."""
    import torch
    from repro_torch.data import TokenPipelineConfig
    from repro_torch.launch import train
    from repro_torch.models import factory
    cfg, opt, step_fn = train.build(TRAIN_ARCH, False, TRAIN_BATCH,
                                    TRAIN_SEQ, 3e-4, steps_)
    params = factory.build(cfg).init(torch.Generator(dev).manual_seed(SEED))
    opt_state = opt.init(params)
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=SEED)
    return cfg, step_fn, params, opt_state, pipe


def train_steps(dev, cfg, step_fn, params, opt_state, pipe, rows, mb,
                final=None):
    """`TRAIN_STEPS` steps of ``step_fn`` from the token pipeline: each
    step's launches exact (`train_launches`), finite losses, the first near
    ln(vocab); step seconds, tokens/s, model FLOP/s and its share of the
    bf16 peak, peak memory (from the caller's `reset_peak_memory_stats`
    and ``base``).  ``final``: a list that receives the parameters and
    the optimizer state the last step handed back."""
    import torch
    from repro_torch.data import batch_at_step
    from repro_torch.launch.steps import model_flops
    from repro_torch.models import factory
    from repro_torch.optim.optimizers import _leaves
    base = torch.cuda.memory_allocated() - sum(
        t.numel() * t.element_size() for t in _leaves((params, opt_state)))
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in _leaves(tree))
    p_bytes, o_bytes = nbytes(params), nbytes(opt_state)
    want = train_launches(cfg, mb, len(_leaves(params)))
    steps_, total = [], [0] * len(want)
    for step in range(TRAIN_STEPS):
        batch = batch_at_step(pipe, step, device=dev)
        torch.cuda.synchronize()
        zero_train_counts()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = train_counts()
        require(got == want,
                f"{cfg.name} train step {step}: launches (#8, #8 backward, "
                f"#7, #7 backward, silu, silu backward, AdamW) {got}, want "
                f"{want}")
        total = [a + b for a, b in zip(total, got)]
        require(math.isfinite(loss), f"{cfg.name} train step {step}: loss "
                                     f"{loss}")
        steps_.append(dict(step=step, loss=loss, seconds=dt))
        log(f"  step {step}: loss {loss:.4f}, {dt:.3f} s, launches {got}")
        del batch
    if final is not None:
        final[:] = [params, opt_state]
    first = steps_[0]["loss"]
    require(abs(first - math.log(cfg.vocab)) < 1.0,
            f"{cfg.name} first loss {first:.4f}, want near ln({cfg.vocab}) "
            f"= {math.log(cfg.vocab):.4f}")
    steady = statistics.median(r["seconds"] for r in steps_[1:])
    tokens = rows * TRAIN_SEQ
    flops = model_flops(cfg, "train", rows, TRAIN_SEQ)
    peak = torch.cuda.max_memory_allocated() - base
    out = dict(arch=cfg.name, n_layers=cfg.n_layers,
               params=factory.build(cfg).n_params(), batch=rows,
               seq=TRAIN_SEQ, microbatches=mb, steps=steps_,
               step_seconds_steady=steady, tokens_per_s=tokens / steady,
               model_flops=flops, model_flops_per_s=flops / steady,
               mfu=flops / steady / BF16_OPS_PER_S, params_bytes=p_bytes,
               opt_state_bytes=o_bytes, peak_bytes=peak,
               launches_per_step=list(want), launches=total)
    log(f"  {cfg.name} at full width ({nvidia_smi()}): {steady:.3f} s a "
        f"step (median of steps 1-{TRAIN_STEPS - 1}), {tokens / steady:.0f} "
        f"tokens/s, {flops / steady / 1e12:.1f} TFLOP/s of model FLOPs "
        f"({flops / steady / BF16_OPS_PER_S:.1%} of 989); peak "
        f"{gib(peak):.2f} GiB (params {gib(p_bytes):.2f}, optimizer "
        f"{gib(o_bytes):.2f})")
    return out


def train_path(dev, results):
    """(c): 3 steps of full-width qwen3-4b at 2 x 4096 tokens through
    `train.build` and its step function (`train_steps`: with remat 2 x 36
    x 2 #7 forwards, 2 x 36 backwards, the same for silu, and AdamW's
    kernel once a parameter leaf)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    cfg, step_fn, params, opt_state, pipe = train_model(dev)
    torch.cuda.synchronize()
    out = train_steps(dev, cfg, step_fn, params, opt_state, pipe,
                      TRAIN_BATCH, 2)           # TRAIN_SETUP["qwen3-4b"]
    for name, k in (("flash_attention_bwd", 3), ("silu_bwd", 5),
                    ("adamw", 6)):
        results[name]["launches"] = out["launches"][k]
    del params, opt_state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def routing_log(into):
    """Append each `moe.route` call's (expert ids, kept assignments, rows,
    the top-(k+1) router probabilities of every token) to ``into``."""
    import torch
    from repro_torch.models import moe as MoE
    real = MoE.route

    def route(h, router, cfg, *a, **kw):
        r = real(h, router, cfg, *a, **kw)
        with torch.no_grad():
            probs = torch.softmax(h.reshape(r.expert_idx.shape[:2] + (-1,))
                                  .float() @ router.float(), dim=-1)
            top = probs.topk(cfg.moe.top_k + 1, dim=-1).values
        into.append((r.expert_idx, r.keep, r.row, top))
        return r

    with mock.patch.object(MoE, "route", route):
        yield into


def routings_equal(got, want, what):
    """Fail unless two runs' `routing_log`s route alike call by call:
    expert ids, kept assignments and rows.  A differing token is printed
    with its k-th and (k+1)-th router probabilities in each run."""
    import torch
    require(len(got) == len(want), f"{what}: {len(got)} MoE calls against "
                                   f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if all(torch.equal(a, b) for a, b in zip(g[:3], w[:3])):
            continue
        bad = (g[0] != w[0]).any(-1).nonzero().tolist()
        for grp, t in bad[:8]:
            log(f"  {what}: call {i} token {t} (group {grp}) experts "
                f"{g[0][grp, t].tolist()} / {w[0][grp, t].tolist()}, k-th and "
                f"(k+1)-th probabilities {g[3][grp, t, -2:].tolist()} / "
                f"{w[3][grp, t, -2:].tolist()}")
        require(False, f"{what}: MoE call {i} routes {len(bad)} tokens "
                        f"otherwise than the plain path")
    return len(got)


def train_shallow_matches(dev, arch):
    """(d): ``arch`` at full width and `shallow` depth (2 layers; a hybrid
    4, a super-block of 3 and a trailing Mamba2 block, since it needs its
    shared block; deepseek-moe-16b its dense first layer and one MoE
    layer), float32, remat on, one microbatch of 4096 tokens: the loss and
    every gradient leaf through the kernels against the plain path (the
    plain attention, SSD scan and silu, and the MoE dispatch and combine
    as indexing, differentiated by autograd), the loss within 1e-5
    relative and each leaf within 1e-4 of its largest |g|; launches
    exact; in a MoE layer both paths route alike first (`routings_equal`,
    every call: the forward and remat's recompute)."""
    import torch
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch import steps
    from repro_torch.models import attention as MA, factory, layers as ML
    from repro_torch.models import ssm as MS
    cfg = shallow(lm_config(arch)[0]).with_(dtype="float32")
    gen = torch.Generator(dev).manual_seed(SEED + 62)
    params = factory.build(cfg).init(gen)
    toks = torch.randint(0, cfg.vocab, (1, TRAIN_SEQ + 1), generator=gen,
                         device=dev)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def run():
        tree, slots = steps._layer_leaves(params)
        loss = steps.make_loss_fn(cfg)(tree, batch)
        loss.backward()
        return loss.detach(), [t.grad for t, _ in slots]

    want = train_launches(cfg, 1, 0)
    zero_train_counts()
    routes, routes_p = [], []
    with routing_log(routes):
        loss, grads = run()
    got = train_counts()
    require(got == want, f"{arch} {cfg.n_layers} layers float32: launches "
                         f"{got}, want {want}")
    with contextlib.ExitStack() as stack:
        for p in (mock.patch.object(MA, "attn_op", TA.flash_attention_plain),
                  mock.patch.object(MS, "ssd_op", SK.ssd_scan_plain),
                  mock.patch.object(MS, "silu", ML.silu_plain),
                  mock.patch.object(ML, "silu", ML.silu_plain),
                  *(moe_indexing_forms() if cfg.moe else ()),
                  routing_log(routes_p)):
            stack.enter_context(p)
        loss_p, grads_p = run()
    calls = routings_equal(routes, routes_p,
                           f"{arch} {cfg.n_layers} layers float32") \
        if cfg.moe else 0
    rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    worst = max(float((g - w).abs().max() / w.abs().max())
                for g, w in zip(grads, grads_p))
    require(rel <= 1e-5 and worst <= 1e-4,
            f"{arch} {cfg.n_layers} layers float32: loss rel diff {rel:.3g}, "
            f"largest leaf diff {worst:.3g} of its largest |g| (want 1e-5, "
            f"1e-4)")
    log(f"  {cfg.name}, {cfg.n_layers} layers at full width, float32, 1 x "
        f"{TRAIN_SEQ}: loss {float(loss):.6f}, rel diff {rel:.3g}; every "
        f"gradient leaf within {worst:.3g} of its largest |g| of the plain "
        f"path's; launches {got}"
        + (f"; {calls} MoE calls routed alike (expert ids, kept "
           f"assignments, rows)" if calls else ""))
    del params, grads, grads_p, routes, routes_p
    torch.cuda.empty_cache()
    return dict(n_layers=cfg.n_layers, loss=float(loss), loss_rel_diff=rel,
                worst_leaf=worst, moe_calls_routed_alike=calls)


def train_cli():
    """(e): the train CLI on the card, smoke qwen3-4b, 6 steps saved every
    3, then the same command again: it resumes at step 6 and runs none.
    Launches exact (one microbatch, and no remat in the smoke config, as
    in the JAX package's: one #7 forward and one backward a layer a step,
    silu the same, and AdamW's kernel once a parameter leaf a step)."""
    import tempfile
    work = ROOT / "build" / "chip_smoke_train"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = []
    with tempfile.TemporaryDirectory(dir=work) as ckpt:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               TRAIN_ARCH, "--smoke", "--steps", str(TRAIN_CLI_STEPS),
               "--global-batch", "4", "--seq-len", "32", "--ckpt", ckpt,
               "--save-every", "3"]
        for _ in range(2):
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=240, env=env, cwd=str(ROOT))
            require(p.returncode == 0,
                    f"train CLI exited {p.returncode}: {p.stderr[-2000:]}")
            out.append(json.loads(p.stdout[p.stdout.index("{"):]))
    first, again = out
    n = 2 * TRAIN_CLI_STEPS              # the smoke config's 2 layers
    want = {"flash_attention": n, "flash_attention_bwd": n, "ssd_scan": 0,
            "ssd_scan_bwd": 0, "silu": n, "silu_bwd": n,
            "adamw": TRAIN_CLI_STEPS * smoke_leaves(TRAIN_ARCH)}
    require(first["steps"] == TRAIN_CLI_STEPS and first["start_step"] == 0
            and math.isfinite(first["last_loss"])
            and first["launches"] == want,
            f"train CLI: {first}, want {TRAIN_CLI_STEPS} steps from 0, "
            f"launches {want}")
    require(again["start_step"] == TRAIN_CLI_STEPS and again["steps"] == 0,
            f"train CLI again: {again}, want a resume at step "
            f"{TRAIN_CLI_STEPS}")
    log(f"  train CLI --smoke: {first['steps']} steps, loss "
        f"{first['first_loss']:.4f} -> {first['last_loss']:.4f}, launches "
        f"{first['launches']}; again: resumed at step {again['start_step']}")
    return dict(first=first, again=again)


# the step's kernels by name: the hand kernels (launched through ctypes,
# so a `record_function` range does not see them) and cuBLAS's GEMMs
TRAIN_GROUPS = {"#7 backward": r"dkdv_(wgmma_)?kernel|dq_(wgmma_)?kernel",
                "#7 forward": r"flash_wgmma_kernel|flash_kernel",
                "silu backward": r"silu_bwd_kernel",
                "silu": r"silu_kernel",
                "AdamW": r"adamw_kernel",
                "GEMMs": r"gemm|sm90_xmma|nvjet|cutlass",
                "elementwise": r"elementwise_kernel",
                "reductions": r"reduce_kernel"}


@contextlib.contextmanager
def optimizer_range(opt):
    """The optimizer's update inside a `torch.profiler.record_function`
    range ``train.optimizer``."""
    from torch.profiler import record_function
    real = type(opt).update

    def ranged(*a, **kw):
        with record_function("train.optimizer"):
            return real(*a, **kw)
    with mock.patch.object(type(opt), "update", ranged):
        yield


def train_profile(dev):
    """``--only train-profile``: a fresh process's `torch.profiler` of one
    full-width qwen3-4b training step (2 x 4096 tokens) after one untimed
    step: device busy time and idle share, the top kernels, the device
    time of each family of kernels by kernel name (`TRAIN_GROUPS`: #7's
    forward and backward, silu's, AdamW's, the GEMMs, the elementwise
    kernels and the reductions), and the optimizer's update (AdamW's
    kernel, the clip's norm and the scalars) in a range."""
    import torch
    from repro_torch.data import batch_at_step
    from repro_torch.optim import adamw
    cfg, step_fn, params, opt_state, pipe = train_model(dev, steps_=2)
    state = {"p": params, "o": opt_state}

    def one(step):
        batch = batch_at_step(pipe, step, device=dev)
        state["p"], state["o"], m = step_fn(state["p"], state["o"], batch)
        return float(m["loss"])

    one(0)
    log("  one training step, profiled:")
    with optimizer_range(adamw()):
        out = profile_window(lambda: one(1), 1, TRAIN_GROUPS)
    busy = out["device_busy_ms"]
    parts = {n: r["ms"] for n, r in out.get("groups", {}).items()}
    parts["optimizer"] = out.get("annotated_ranges", {}).get(
        "train.optimizer", {}).get("device_ms", 0.0)
    out["shares"] = {n: ms / busy if busy else None
                     for n, ms in parts.items()}
    log("  shares of the device's busy time: " + ", ".join(
        f"{n} {ms:.1f} ms"
        + (f" ({out['shares'][n]:.3f})" if busy else "")
        for n, ms in parts.items()))
    return out


def train_all(dev, results):
    """Phase 17: (a) #7's backward, (b) silu's, (c) 3 full-width steps,
    (d) 2 layers in float32 against the plain path, (e) the CLI and its
    resume; then a fresh process's profile of one step."""
    import torch
    work = ROOT / "build" / "chip_smoke_train"
    work.mkdir(parents=True, exist_ok=True)
    fresh = Fresh("train-profile", work)
    _flush_buf.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    train_attention(dev, results)
    train_silu(dev, results)
    train_adamw(dev, results)
    _flush_buf.clear()              # its 1 GiB is wanted beside ~66 GiB
    gc.collect()
    torch.cuda.empty_cache()
    out["path"] = train_path(dev, results)
    out["depth2"] = train_shallow_matches(dev, TRAIN_ARCH)
    out["cli"] = train_cli()
    gc.collect()
    torch.cuda.empty_cache()
    out["profile"] = fresh.result(lambda line: line.startswith(
        ("    ", "  one ", "  shares")), timeout=360)
    return out


# ---- phase 18: ssm and hybrid training ---------------------------------------

# full-width mamba2-1.3b at train_4k's S with its global batch of 256 cut to
# 2 rows (as phase 17 cuts qwen3-4b's); zamba2-7b (~6.05 B parameters,
# ~85 GB of weights, accumulator and moments) cut to 3 of its 9
# super-blocks (27 layers, ~2.3 B) to fit one card, 4 rows
SSM_TRAIN = {"mamba2-1.3b": dict(batch=2, layers=None),
             "zamba2-7b": dict(batch=4, layers=27)}
# (B, L, H, P, S) of one microbatch's Mamba2 block at each arch
SSM_TRAIN_SHAPES = {"mamba2-1.3b": (1, TRAIN_SEQ, 64, 64, 128),
                    "zamba2-7b": (1, TRAIN_SEQ, 112, 64, 64)}
SSM_TRAIN_GROUPS = {"#8 backward": r"ssd_bwd",
                    "#8 forward": r"ssd_wgmma_kernel|ssd_kernel",
                    "silu backward": r"silu_bwd_kernel",
                    "silu": r"silu_kernel",
                    "AdamW": r"adamw_kernel",
                    "GEMMs": r"gemm|sm90_xmma|nvjet|cutlass",
                    "elementwise": r"elementwise_kernel",
                    "reductions": r"reduce_kernel"}


def ssd_bwd_bound(b, length, h, p, s, g, itemsize):
    """Least time (ms) for #8's backward: x, dy, B, C, dt and a read once,
    dx, dB, dC, ddt and da written once, at the memory rate, against the
    FLOP of each (b, h, chunk of q rows): the causal triangles of C B^T,
    dy x^T, G^T dy, dG' B and dG'^T C, q(q+1)(3S + 2P), and the five
    products with a chunk state (its contribution, its gradient's, B
    dS_out, dy S_in^T and x dS_out^T), 10qSP, at the dense bf16
    tensor-core peak; also that FLOP at the 67 TFLOP/s of the CUDA cores,
    where the float32 kernels run them."""
    nbytes = ((3 * b * length * h * p + 4 * b * length * g * s) * itemsize
              + 4 * (2 * b * length * h + 2 * h))
    qs = [min(64, length - i) for i in range(0, length, 64)]
    flops = b * h * sum(q * (q + 1) * (3 * s + 2 * p) + 10 * q * s * p
                        for q in qs)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / BF16_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations", tb, to,
            flops / FP32_OPS_PER_S * 1e3)


def ssd_bwd_usage():
    """Each bf16 kernel of csrc/ssd_bwd.cu as compiled: registers, local
    (spill) bytes a thread, shared bytes and threads from
    ``cudaFuncGetAttributes``, and ptxas's spill stores and loads; none
    may spill."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import kernel as SK
    usage = SK.ssd_scan_bwd_attrs()
    text = _build.build_all()["log"].get("ssd_bwd.cu", "")
    spills = ptxas_usage(text)
    # each reported kernel's mangled name (its bf16 instantiation)
    mangled = {"ssd_bwd_walk_kernel": "ssd_bwd_walk_kernel",
               "ssd_bwd_grad_kernel<S<=128>": "ssd_bwd_grad_kernelILi2E",
               "ssd_bwd_grad_kernel<S<=64>": "ssd_bwd_grad_kernelILi1E",
               "ssd_bwd_finish_kernel": "ssd_bwd_finish_kernel",
               "ssd_bwd_slab_kernel": "ssd_bwd_slab_kernel"}
    for name, u in usage.items():
        hit = [v for k, v in spills.items() if mangled[name] in k]
        st, ld = (hit[0][1], hit[0][2]) if hit else (None, None)
        u.update(ptxas_spill_stores=st, ptxas_spill_loads=ld)
        log(f"  {name}: {u['registers']} registers, {u['local_bytes']} "
            f"local (spill) bytes a thread, {u['shared_bytes']} shared "
            f"bytes, {u['threads']} threads; ptxas spills {st} B stored, "
            f"{ld} B loaded")
        require(u["local_bytes"] == 0 and not st and not ld,
                f"{name} spills: {u}")
    return usage


def ssd_bwd_close(got, want):
    """#8's backward gate against its plain version at the model's chunk
    (256 rows; the kernel's are 64): bf16 dx, dB, dC within one bf16 step
    of the largest |g| (a float32 sum rounded once in both); every float32
    gradient within 1e-4 of its largest |g|: the sums over 4096 steps run
    in other sub-blocks and orders (measured 3.0e-5 at most)."""
    import torch
    err = float((got.double() - want.double()).abs().max())
    if got.dtype == torch.bfloat16:
        return err, err <= bf16_step(want)
    return err, err <= 1e-4 * float(want.abs().max())


def ssm_train_bwd(dev, results):
    """(a): #8's backward (csrc/ssd_bwd.cu) against `ssd_scan_bwd_plain`
    (the chunked form at the model's chunk) on x, B and C cut from a packed
    projection: mamba2-1.3b's and zamba2-7b's training shapes (one
    microbatch of 4096 tokens), G = 2 at a ragged L = 300 and zamba2's
    heads at L = 1000, with and without a final-state gradient, in bf16 and
    float32; a second launch the same bits.  Timed per layer in bf16 (L2
    flushed) beside its plain version and its bound, each of its four
    bf16 kernels by `torch.profiler`, their registers and spills, and the
    launch `bwd_plan` lays out."""
    import torch
    from repro_torch.kernels.ssd import kernel as SK
    row = results["ssd_scan_bwd"]
    row["kernels"] = ssd_bwd_usage()
    gen = torch.Generator(dev).manual_seed(SEED + 70)
    cases = [("mamba2-1.3b", SSM_TRAIN_SHAPES["mamba2-1.3b"], 1, False),
             ("zamba2-7b", SSM_TRAIN_SHAPES["zamba2-7b"], 1, True),
             ("G=2 L=300", (2, 300, 8, 64, 128), 2, True),
             ("zamba2 L=1000", (1, 1000, 112, 64, 64), 1, False)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for what, (b, length, h, p, s), g, with_ds in cases:
            x, dt, a, bm, cm = ssd_inputs(gen, b, length, h, p, s, g, dtype,
                                          dev)
            dy = torch.randn(b, length, h, p, generator=gen,
                             device=dev).to(dtype)
            ds = (torch.randn(b, h, s, p, generator=gen, device=dev)
                  if with_ds else None)
            got = SK.ssd_scan_bwd(x, dt, a, bm, cm, dy, ds)
            again = SK.ssd_scan_bwd(x, dt, a, bm, cm, dy, ds)
            want = SK.ssd_scan_bwd_plain(x, dt, a, bm, cm, dy, ds,
                                         chunk=SSD_CHUNK)
            torch.cuda.synchronize()
            rel = []
            for name, u, v, w in zip(("dx", "ddt", "da", "dB", "dC"), got,
                                     again, want):
                require(torch.equal(u, v),
                        f"ssd_scan_bwd {dname} {what} {name}: a second "
                        f"launch gave other bits")
                err, ok = ssd_bwd_close(u, w)
                require(u.dtype == w.dtype and u.shape == w.shape and ok,
                        f"ssd_scan_bwd {dname} {what} {name}: max |err| "
                        f"{err:.3g} at largest |g| "
                        f"{float(w.abs().max()):.3g}")
                row["max_abs_err"] = max(row["max_abs_err"], err)
                rel.append(f"{name} {err / float(w.abs().max()):.2e}")
            log(f"  ssd_scan_bwd {dname:8s} {what:13s} B={b} L={length} "
                f"H={h} S={s} G={g}{' dstate' if with_ds else ''}: max "
                f"|err| / largest |g|: {', '.join(rel)}; a second launch "
                f"the same bits")
            del x, dt, a, bm, cm, dy, ds, got, again, want
    torch.cuda.empty_cache()
    timed = {}
    for arch, (b, length, h, p, s) in SSM_TRAIN_SHAPES.items():
        x, dt, a, bm, cm = ssd_inputs(gen, b, length, h, p, s, 1,
                                      torch.bfloat16, dev)
        dy = torch.randn(b, length, h, p, generator=gen,
                         device=dev).to(torch.bfloat16)
        ms = device_ms(lambda: SK.ssd_scan_bwd(x, dt, a, bm, cm, dy),
                       reps=10)
        plain = device_ms(lambda: SK.ssd_scan_bwd_plain(
            x, dt, a, bm, cm, dy, chunk=SSD_CHUNK), reps=3)
        fwd = device_ms(lambda: SK.ssd_scan(x, dt, a, bm, cm), reps=10)
        by_kernel = {name: profiled_ms(
            lambda: SK.ssd_scan_bwd(x, dt, a, bm, cm, dy), "write",
            kernel=name, calls=5)[0]
            for name in ("ssd_bwd_walk_kernel", "ssd_bwd_grad_kernel",
                         "ssd_bwd_finish_kernel", "ssd_bwd_slab_kernel")}
        bms, kind, tb, to, to32 = ssd_bwd_bound(b, length, h, p, s, 1, 2)
        plan = SK.bwd_plan(b, length, h, 1, p, s, sms=SK._sms(dev))
        log(f"  ssd_scan_bwd bf16 {arch} plan: {plan}")
        timed[arch] = dict(shape=dict(zip("BLHPS", (b, length, h, p, s))),
                           plan=plan, ms=ms, plain_ms=plain, bound_ms=bms,
                           bound_by=kind, bytes_ms=tb, bf16_ops_ms=to,
                           fp32_ops_ms=to32, forward_ms=fwd,
                           by_kernel_ms=by_kernel)
        log(f"  ssd_scan_bwd bf16 {arch} (B={b} L={length} H={h} P={p} "
            f"S={s}, one layer of a microbatch): {ms:.4f} ms (bound "
            f"{bms:.4f} ms by {kind}: bytes {tb:.4f} ms, operations "
            f"{to:.4f} ms at the bf16 peak, {to32:.4f} ms at the CUDA "
            f"cores' 67 TFLOP/s); {ms / bms:.1f}x the bound; plain "
            f"{plain:.4f} ms; the forward kernel {fwd:.4f} ms; by kernel: "
            + ", ".join(f"{n} " + ("not seen" if t is None else
                                   f"{t:.4f} ms")
                        for n, t in by_kernel.items()))
        del x, dt, a, bm, cm, dy
        torch.cuda.empty_cache()
    main = timed["mamba2-1.3b"]
    row.update({k: main[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                     "bound_by")}, library_ms=None,
               by_arch=timed)


def ssm_train_silu(dev, results):
    """(b): silu's backward in the Mamba2 block's two forms bit for bit
    against `silu_bwd_plain` at one training microbatch (4096 rows) of
    each arch: the conv's one-operand form (the xBC width) in bf16 and
    float32, the gate's (d_inner, with y) in bf16, also through the
    autograd Function from a float32 output gradient; timed at
    mamba2-1.3b in bf16 (a block's two launches) beside its plain version
    and its bound by bytes."""
    import torch
    from repro_torch.models import layers as ML, ssm as MS
    gen = torch.Generator(dev).manual_seed(SEED + 71)
    row = results["silu_bwd_mamba2"]
    for arch in SSM_TRAIN:
        cfg = lm_config(arch)[0]
        d_inner, _, d_xbc = MS.dims(cfg)
        for form, cols, dt in (("conv", d_xbc, "bfloat16"),
                               ("conv", d_xbc, "float32"),
                               ("gate", d_inner, "bfloat16")):
            dtype = getattr(torch, dt)
            x, u, dy = (torch.randn(TRAIN_SEQ, cols, generator=gen,
                                    device=dev).mul_(s).to(dtype)
                        for s in (4, 1, 0.5))
            other = u if form == "gate" else None
            got = ML.silu_bwd(x, other, dy)
            want = ML.silu_bwd_plain(x, other, dy)
            torch.cuda.synchronize()
            same = all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(got, want))
            err = float((got[0].double() - want[0].double()).abs().max())
            row["max_abs_err"] = max(row["max_abs_err"], err)
            require(same, f"silu_bwd {arch} {form} {dt} ({TRAIN_SEQ}, "
                          f"{cols}): differs from its plain version (max "
                          f"err {err})")
            if form == "gate":
                xg, ug = (t.clone().requires_grad_() for t in (x, u))
                d32 = torch.randn(TRAIN_SEQ, cols, generator=gen, device=dev)
                ML.silu(xg, ug, torch.float32).backward(d32)
                w = ML.silu_bwd_plain(x, u, d32.to(dtype))
                require(torch.equal(xg.grad, w[0])
                        and torch.equal(ug.grad, w[1]),
                        f"silu gate {arch}: the Function's gradients differ "
                        f"from silu_bwd_plain of the rounded gradient")
                del xg, ug, d32, w
            log(f"  silu_bwd {arch} {form} {dt} ({TRAIN_SEQ}, {cols}): bit "
                f"for bit" + (", and through the Function from a float32 "
                              "gradient" if form == "gate" else ""))
            del x, u, dy, got, want
    cfg = lm_config("mamba2-1.3b")[0]
    d_inner, _, d_xbc = MS.dims(cfg)
    bf = torch.bfloat16
    xc, dyc = (torch.randn(TRAIN_SEQ, d_xbc, generator=gen,
                           device=dev).to(bf) for _ in range(2))
    z, y, dyg = (torch.randn(TRAIN_SEQ, d_inner, generator=gen,
                             device=dev).to(bf) for _ in range(3))
    conv = device_ms(lambda: ML.silu_bwd(xc, None, dyc))
    gate = device_ms(lambda: ML.silu_bwd(z, y, dyg))
    plain = (device_ms(lambda: ML.silu_bwd_plain(xc, None, dyc))
             + device_ms(lambda: ML.silu_bwd_plain(z, y, dyg)))
    n_c, n_g = TRAIN_SEQ * d_xbc, TRAIN_SEQ * d_inner
    # conv: x, dy read and dx written; gate: z, y, dy read, dz, dy written;
    # ~14 operations an element
    bms, kind = bound(2 * (3 * n_c + 5 * n_g), 14 * (n_c + n_g))
    row.update(shape=dict(rows=TRAIN_SEQ, conv_cols=d_xbc, gate_cols=d_inner,
                          dtype="bfloat16"),
               ms=conv + gate, conv_ms=conv, gate_ms=gate, plain_ms=plain,
               library_ms=None, bound_ms=bms, bound_by=kind)
    log(f"  silu_bwd mamba2-1.3b bf16, a block's two forms: conv ({TRAIN_SEQ}"
        f", {d_xbc}) {conv:.4f} ms + gate ({TRAIN_SEQ}, {d_inner}) "
        f"{gate:.4f} ms = {conv + gate:.4f} ms (bound {bms:.4f} ms by "
        f"{kind}, {bms / (conv + gate):.0%} of the memory rate); plain "
        f"{plain:.4f} ms")
    del xc, dyc, z, y, dyg
    torch.cuda.empty_cache()


def ssm_train_cfg(arch):
    """``arch``'s training config as `launch.train.build` makes it, at the
    depth `SSM_TRAIN` gives it: zamba2-7b's ``get_config`` answered with
    ``n_layers = 27`` (3 of its 9 super-blocks), so that the rest of the
    build (TRAIN_SETUP, the optimizer, the step) is the CLI's.  Returns
    (cfg, opt, step_fn)."""
    from repro_torch.launch import train
    layers = SSM_TRAIN[arch]["layers"]
    real = train.get_config
    cut = ((lambda a: real(a).with_(n_layers=layers)) if layers else real)
    with mock.patch.object(train, "get_config", cut):
        return train.build(arch, False, SSM_TRAIN[arch]["batch"], TRAIN_SEQ,
                           3e-4, TRAIN_STEPS)


def ssm_train_path(dev, arch):
    """(c): 3 steps of ``arch`` through `ssm_train_cfg`'s step function at
    `SSM_TRAIN`'s rows of 4096 tokens, random init from the seed
    (`train_steps`)."""
    import torch
    from repro_torch.data import TokenPipelineConfig
    from repro_torch.launch.specs import train_setup
    from repro_torch.models import factory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, opt, step_fn = ssm_train_cfg(arch)
    rows = SSM_TRAIN[arch]["batch"]
    mb = train_setup(arch)["microbatches"]
    params = factory.build(cfg).init(torch.Generator(dev).manual_seed(SEED))
    opt_state = opt.init(params)
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=rows, seed=SEED)
    full = lm_config(arch)[0].n_layers
    cut = (f", cut to {cfg.n_layers} of {full} layers "
           f"({cfg.n_layers // cfg.ssm.attn_every} of "
           f"{full // cfg.ssm.attn_every} super-blocks)"
           if cfg.n_layers < full else "")
    log(f"  {cfg.name}: {factory.build(cfg).n_params() / 1e9:.3f} B "
        f"parameters{cut}, {rows} x {TRAIN_SEQ} tokens in {mb} microbatches")
    out = train_steps(dev, cfg, step_fn, params, opt_state, pipe, rows, mb)
    del params, opt_state, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssm_train_profile(dev):
    """``--only ssm-train-profile``: a fresh process's `torch.profiler` of
    one full-width mamba2-1.3b training step (2 x 4096 tokens) after one
    untimed step: device busy time and idle share, the top kernels, and
    the device time of each family of kernels by kernel name
    (`SSM_TRAIN_GROUPS`: #8's forward and backward, silu's, AdamW's, the
    GEMMs, the elementwise kernels and the reductions)."""
    import torch
    from repro_torch.data import TokenPipelineConfig, batch_at_step
    from repro_torch.models import factory
    cfg, opt, step_fn = ssm_train_cfg("mamba2-1.3b")
    params = factory.build(cfg).init(torch.Generator(dev).manual_seed(SEED))
    state = {"p": params, "o": opt.init(params)}
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=SSM_TRAIN[cfg.name]["batch"],
                               seed=SEED)

    def one(step):
        batch = batch_at_step(pipe, step, device=dev)
        state["p"], state["o"], m = step_fn(state["p"], state["o"], batch)
        return float(m["loss"])

    one(0)
    log("  one mamba2-1.3b training step, profiled:")
    out = profile_window(lambda: one(1), 1, SSM_TRAIN_GROUPS)
    busy = out["device_busy_ms"]
    out["shares"] = {n: r["ms"] / busy if busy else None
                     for n, r in out.get("groups", {}).items()}
    log("  shares of the device's busy time: " + ", ".join(
        f"{n} {r['ms']:.1f} ms"
        + (f" ({out['shares'][n]:.3f})" if busy else "")
        for n, r in out.get("groups", {}).items()))
    return out


def ssm_train_all(dev, results):
    """Phase 18: (a) #8's backward, (b) silu's Mamba2 forms, (c) 3 steps
    of each arch, (d) each shallow in float32 against the plain path; then
    a fresh process's profile of one mamba2-1.3b step."""
    import torch
    work = ROOT / "build" / "chip_smoke_train"
    work.mkdir(parents=True, exist_ok=True)
    fresh = Fresh("ssm-train-profile", work)
    _flush_buf.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    ssm_train_bwd(dev, results)
    ssm_train_silu(dev, results)
    _flush_buf.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out["path"] = {arch: ssm_train_path(dev, arch) for arch in SSM_TRAIN}
    out["shallow"] = {arch: train_shallow_matches(dev, arch)
                      for arch in SSM_TRAIN}
    m = out["path"]["mamba2-1.3b"]["launches"]
    results["ssd_scan_bwd"]["launches"] = m[1]
    results["silu_bwd_mamba2"]["launches"] = m[5]
    for name, k in (("ssd_scan_bwd", 1), ("silu_bwd_mamba2", 5)):
        results[name]["launches_by_path"] = {
            f"{arch} training": p["launches"][k]
            for arch, p in out["path"].items()}
    gc.collect()
    torch.cuda.empty_cache()
    out["profile"] = fresh.result(lambda line: line.startswith(
        ("    ", "  one ", "  shares")), timeout=360)
    return out


# ---- phase 19: MoE training ----------------------------------------------------

# full-width deepseek-moe-16b (16.38 B parameters, ~229 GB of bf16 weights,
# float32 accumulator and AdamW moments) cut to its dense first layer and
# 7 of its 27 MoE layers (4.62 B, ~60.2 GiB of training state) to fit one
# card; train_4k's S = 4096, its global batch cut to 2 rows (as phase 17)
MOE_TRAIN_LAYERS = 8
MOE_TRAIN_BATCH = 2
MOE_TRAIN_ATTN = (1, TRAIN_SEQ, 16, 16, 128)   # one microbatch at deepseek
# the step's kernels by name, the index kernels (gathers, scatters,
# indexing) apart from the other elementwise ones
MOE_TRAIN_GROUPS = {**TRAIN_GROUPS,
                    "elementwise": r"^(?!.*(index|gather|scatter))"
                                   r".*elementwise_kernel",
                    "index": r"index|gather|scatter"}


def moe_train_kernels(dev, results):
    """(a): #7's forward with lse and its backward at deepseek-moe-16b's
    training shape (MHA: 16 query over 16 KV heads of 128, S = 4096)
    against their plain versions (`train_attention_case`), the backward
    timed beside its bound by operations, SDPA's backward and the
    forward; silu and its backward bit for bit at
    the step's three SwiGLU shapes (the routed experts' (64, cap, 1408)
    buffer at one microbatch, the shared experts' 4096 x 2816, the dense
    first layer's 4096 x 10944); AdamW bit for bit at one stacked expert
    leaf (7 x 64 x 2048 x 1408), timed beside its bound by bytes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.models import layers as ML, moe as MoE
    from repro_torch.optim import optimizers as O
    out = {}
    gen = torch.Generator(dev).manual_seed(SEED + 70)
    q, k, v, o, lse, do = train_attention_case(
        gen, dev, MOE_TRAIN_ATTN, torch.bfloat16, results,
        f"bf16 {MOE_ARCH} training {MOE_TRAIN_ATTN}")
    ms = device_ms(lambda: TA.flash_attention_bwd(q, k, v, o, lse, do),
                   reps=5)
    plain = device_ms(lambda: TA.flash_attention_bwd_plain(q, k, v, o, lse,
                                                           do), reps=3)
    fwd = device_ms(lambda: TA._forward(q, k, v, True, None, None,
                                        with_lse=True), reps=5)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib = device_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                                retain_graph=True), reps=5)
    bms, kind, tb, to = attention_bwd_bound(1, TRAIN_SEQ, TRAIN_SEQ,
                                            *MOE_TRAIN_ATTN[2:], 2)
    out["attention_bwd"] = dict(
        shape=dict(zip(("B", "S", "H", "HKV", "D"), MOE_TRAIN_ATTN)), ms=ms,
        plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=kind,
        tflops=to * BF16_OPS_PER_S / 1e3 / ms / 1e9, forward_with_lse_ms=fwd)
    results["flash_attention_bwd"]["moe_shape"] = out["attention_bwd"]
    log(f"  flash_attention_bwd bf16 {MOE_TRAIN_ATTN} (one layer of a "
        f"microbatch): {ms:.4f} ms (bound {bms:.4f} ms by {kind}), "
        f"{out['attention_bwd']['tflops']:.1f} TFLOP/s, {ms / bms:.1f}x the "
        f"bound; plain {plain:.4f} ms; SDPA's backward {lib:.4f} ms "
        f"({ms / lib:.2f}x); the forward with lse {fwd:.4f} ms")
    del q, k, v, o, lse, do, qt, kt, vt, sdpa, dot
    torch.cuda.empty_cache()

    cfg = lm_config(MOE_ARCH)[0]
    m = cfg.moe
    shapes = {"routed experts": (m.num_experts, MoE.capacity(cfg, TRAIN_SEQ),
                                 m.d_expert),
              "shared experts": (TRAIN_SEQ, m.n_shared * m.d_expert),
              "dense first layer": (TRAIN_SEQ, m.first_dense_ff)}
    for what, shape in shapes.items():
        g, u, dy = (torch.randn(shape, generator=gen, device=dev).mul_(s)
                    .to(torch.bfloat16) for s in (4, 1, 0.5))
        pairs = (("silu", (ML.silu(g, u),), (ML.silu_plain(g, u),)),
                 ("silu_bwd", ML.silu_bwd(g, u, dy),
                  ML.silu_bwd_plain(g, u, dy)))
        torch.cuda.synchronize()
        for name, got, want in pairs:
            err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(got, want))
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err)
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"{name} {MOE_ARCH} {what} {shape}: differs from its "
                    f"plain version (max err {err})")
        log(f"  silu and silu_bwd {MOE_ARCH} {what} {shape} bf16: bit for "
            f"bit")
        del g, u, dy, pairs
    out["silu_shapes"] = {k: list(v) for k, v in shapes.items()}

    n = (MOE_TRAIN_LAYERS - m.first_dense) * m.num_experts * cfg.d_model \
        * m.d_expert
    f32, bf16 = torch.float32, torch.bfloat16
    p = torch.randn(n, generator=gen, device=dev).to(bf16)
    mo = 1e-3 * torch.randn(n, generator=gen, device=dev)
    vo = (1e-3 * torch.randn(n, generator=gen, device=dev)).square_()
    twin = [t.clone() for t in (p, mo, vo)]

    def scalars(step):
        st = torch.full((), step, dtype=f32, device=dev)
        return dict(scale=torch.full((), 0.37, device=dev),
                    bc1=1 - 0.9 ** st, bc2=1 - 0.95 ** st,
                    lr=torch.full((), 3e-4, device=dev), b1=0.9, b2=0.95,
                    eps=1e-8, wd=0.1)

    for step in (1, 2):
        g = 1e-2 * torch.randn(n, generator=gen, device=dev)
        O.adamw_leaf(p, g, mo, vo, None, **scalars(step))
        O.adamw_leaf_plain(twin[0], g, twin[1], twin[2], None,
                           **scalars(step))
        torch.cuda.synchronize()
        for name, a, b in zip("pmv", (p, mo, vo), twin):
            err = float((a.double() - b.double()).abs().max())
            results["adamw"]["max_abs_err"] = max(
                results["adamw"]["max_abs_err"], err)
            require(torch.equal(a, b), f"adamw at {MOE_ARCH}'s stacked "
                                       f"expert leaf (n={n}) step {step}: "
                                       f"{name} differs (max err {err})")
    kw = scalars(3)
    ms = device_ms(lambda: O.adamw_leaf(p, g, mo, vo, None, **kw))
    plain = device_ms(lambda: O.adamw_leaf_plain(twin[0], g, twin[1],
                                                 twin[2], None, **kw), reps=3)
    bms, kind = bound(n * (2 * 2 + 4 + 2 * 4 * 2), 16 * n)
    out["adamw"] = dict(n=n, ms=ms, plain_ms=plain, library_ms=None,
                        bound_ms=bms, bound_by=kind)
    results["adamw"]["moe_expert_leaf"] = out["adamw"]
    log(f"  adamw n={n} ({MOE_TRAIN_LAYERS - m.first_dense} x "
        f"{m.num_experts} x {cfg.d_model} x {m.d_expert}, bf16 p, float32 "
        f"g, m, v): p, m, v bit for bit, two steps; {ms:.4f} ms (bound "
        f"{bms:.4f} ms by {kind}, {bms / ms:.0%} of the memory rate); plain "
        f"{plain:.4f} ms")
    del p, mo, vo, g, twin
    torch.cuda.empty_cache()
    return out


def moe_indexing_forms():
    """Patches that send `moe.dispatch` and `moe.combine` through their
    plain versions (indexing, which autograd differentiates with
    accumulating scatters)."""
    from repro_torch.models import moe as MoE
    return (mock.patch.object(MoE, "dispatch", MoE.dispatch_plain),
            mock.patch.object(MoE, "combine", MoE.combine_plain))


def moe_block_backward(dev):
    """(b): one full-width MoE layer of deepseek-moe-16b (64 routed
    experts, top-6, 2 shared) on a microbatch of 1 x 4096 tokens: in
    float32 the gradients of x and every parameter (the block's norm
    included) through the dispatch's and combine's Functions against autograd of
    their indexing forms, each within 1e-5 of its largest |g|; in bf16
    the layer's backward run twice gives the same bits (the Functions
    gather and use no atomics), and the indexing forms' twice is
    printed beside it."""
    import torch
    from repro_torch.models import layers as ML, moe as MoE
    cfg = lm_config(MOE_ARCH)[0]
    out = {}

    def grads(params, x, ct, cfg_d):
        leaves = {k: t.detach().requires_grad_() for k, t in params.items()}
        xg = x.detach().requires_grad_()
        h = ML.rms_norm(xg, leaves["norm"], cfg.norm_eps)
        MoE.apply(leaves, xg, h, cfg_d).backward(ct)
        return [xg.grad] + [leaves[k].grad for k in sorted(leaves)]

    for dtype in ("float32", "bfloat16"):
        cfg_d = cfg.with_(dtype=dtype)
        gen = torch.Generator(dev).manual_seed(SEED + 71)
        params = ML.init_from_plan(MoE.plan(cfg_d), gen)
        dt = getattr(torch, dtype)
        x = torch.randn(1, TRAIN_SEQ, cfg.d_model, generator=gen,
                        device=dev).to(dt)
        ct = torch.randn(x.shape, generator=gen, device=dev).to(dt)
        got = grads(params, x, ct, cfg_d)
        again = grads(params, x, ct, cfg_d)
        with contextlib.ExitStack() as stack:
            for p in moe_indexing_forms():
                stack.enter_context(p)
            plain = grads(params, x, ct, cfg_d)
            plain2 = grads(params, x, ct, cfg_d)
        torch.cuda.synchronize()
        names = ["x"] + sorted(params)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        plain_same = all(torch.equal(a, b) for a, b in zip(plain, plain2))
        worst = max(float((g.double() - w.double()).abs().max()
                          / w.double().abs().max())
                    for g, w in zip(got, plain))
        require(same, f"MoE layer {dtype}: a second backward gave other "
                      f"bits")
        if dtype == "float32":
            bad = [n for n, g, w in zip(names, got, plain)
                   if (g - w).abs().max() > 1e-5 * w.abs().max()]
            require(not bad, f"MoE layer float32: {bad} differ from "
                             f"autograd of the indexing forms by more than "
                             f"1e-5 of their largest |g| (worst {worst:.3g})")
        out[dtype] = dict(repeat_same_bits=same, worst_vs_indexing=worst,
                          indexing_repeat_same_bits=plain_same)
        log(f"  MoE layer {dtype}, 1 x {TRAIN_SEQ}: the Functions' backward "
            f"twice the same bits; against the indexing forms' autograd the "
            f"worst gradient within {worst:.3g} of its largest |g|; the "
            f"indexing forms' backward twice "
            f"{'the same bits' if plain_same else 'other bits'}")
        del params, x, ct, got, again, plain, plain2
        torch.cuda.empty_cache()
    return out


def moe_train_cfg(layers=MOE_TRAIN_LAYERS):
    """deepseek-moe-16b's training config as `launch.train.build` makes it,
    its ``get_config`` answered with ``n_layers = layers`` (the dense
    first layer and ``layers - 1`` MoE layers), so that the rest of the
    build (TRAIN_SETUP: 2 microbatches, float32 accumulator and moments;
    the optimizer; the step) is the CLI's.  Returns (cfg, opt, step_fn)."""
    from repro_torch.launch import train
    real = train.get_config
    with mock.patch.object(train, "get_config",
                           lambda a: real(a).with_(n_layers=layers)):
        return train.build(MOE_ARCH, False, MOE_TRAIN_BATCH, TRAIN_SEQ, 3e-4,
                           TRAIN_STEPS + 2)


def moe_train_repeat(dev, make, step_fn, state, pipe, step):
    """Step ``step`` taken on the state that `train_steps` left, its loss
    and parameters kept (the parameters on the host); then that state
    dropped, made again from the seed by ``make()`` and steps 0 to
    ``step`` taken on it: the same loss and parameters, bit for bit.
    ``state`` is ``[params, opt_state]``, emptied here so that only one
    state is on the card at a time."""
    import torch
    from repro_torch.data import batch_at_step
    from repro_torch.optim.optimizers import _leaves

    def take(s):
        batch = batch_at_step(pipe, s, device=dev)
        state[0], state[1], metrics = step_fn(*state, batch)
        return metrics["loss"].detach().clone()

    first = take(step)
    kept = [t.cpu() for t in _leaves(state[0])]
    state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state.extend(make())
    for s in range(step + 1):
        again = take(s)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    same_loss = torch.equal(first, again)
    bad = [i for i, (t, h) in enumerate(zip(_leaves(state[0]), kept))
           if not torch.equal(t, h.to(dev))]
    require(same_loss and not bad,
            f"{MOE_ARCH} step {step} taken again from the seed: loss "
            f"{float(first)!r} then {float(again)!r}, {len(bad)} parameter "
            f"leaves differ")
    log(f"  step {step} taken again from the seed (steps 0-{step} on a "
        f"fresh state in {seconds:.1f} s): loss {float(first):.6f} both "
        f"times, every parameter bit for bit")
    del kept
    state.clear()
    gc.collect()
    return dict(step=step, loss=float(first), same_bits=True,
                again_seconds=seconds)


def moe_train_path(dev):
    """(c): 3 steps of deepseek-moe-16b cut to `MOE_TRAIN_LAYERS` layers
    through `moe_train_cfg`'s step function at 2 x 4096 tokens, random
    init from the seed (`train_steps`: launches exact, finite losses, the
    first near ln(102400), step seconds, tokens/s, model FLOP/s, peak
    memory); then a 4th step, taken again on a state made anew from the
    seed (`moe_train_repeat`)."""
    import torch
    from repro_torch.data import TokenPipelineConfig
    from repro_torch.models import factory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, opt, step_fn = moe_train_cfg()

    def make():
        params = factory.build(cfg).init(
            torch.Generator(dev).manual_seed(SEED))
        return [params, opt.init(params)]

    params, opt_state = make()
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=MOE_TRAIN_BATCH, seed=SEED)
    full = lm_config(MOE_ARCH)[0].n_layers
    log(f"  {cfg.name}: {factory.build(cfg).n_params() / 1e9:.3f} B "
        f"parameters, cut to {cfg.n_layers} of {full} layers (the dense "
        f"first layer and {cfg.n_layers - 1} MoE layers), "
        f"{MOE_TRAIN_BATCH} x {TRAIN_SEQ} tokens in 2 microbatches")
    state = []
    out = train_steps(dev, cfg, step_fn, params, opt_state, pipe,
                      MOE_TRAIN_BATCH, 2,    # TRAIN_SETUP["deepseek-moe-16b"]
                      final=state)
    del params, opt_state
    out["repeat"] = moe_train_repeat(dev, make, step_fn, state, pipe,
                                     TRAIN_STEPS)
    del state, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def moe_train_ranges():
    """`moe.route`, `dispatch`, `experts` and `combine` each in a
    `torch.profiler.record_function` range ``moe.<name>`` in the forward
    (the recompute's included) and ``moe.<name>.backward`` in the
    backward: an identity autograd node on the part's output opens the
    range when the gradient reaches it (after unpacking a saved tensor,
    so that remat's recompute of the block runs before, outside it), one
    on its input closes it."""
    import torch
    from torch.autograd.profiler import record_function
    from repro_torch.models import moe as MoE

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, name, held, opening):
            ctx.name, ctx.held, ctx.opening = name, held, opening
            ctx.save_for_backward(x)
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            ctx.saved_tensors
            if ctx.opening:
                ctx.held.append(record_function(ctx.name).__enter__())
            elif ctx.held:
                ctx.held.pop().__exit__(None, None, None)
            return g, None, None, None

    def ranged(name, real, first, wrap_out):
        def fn(*a, **kw):
            held = []
            name_b = f"moe.{name}.backward"
            a = list(a)
            if torch.is_grad_enabled() and a[first].requires_grad:
                a[first] = Mark.apply(a[first], name_b, held, False)
            with record_function(f"moe.{name}"):
                out = real(*a, **kw)
            return wrap_out(out, lambda t: Mark.apply(t, name_b, held, True)
                            if t.requires_grad else t)
        return fn

    def route_out(r, mark):
        r.w = mark(r.w)
        return r

    parts = {"route": (0, route_out), "dispatch": (0, lambda o, m: m(o)),
             "experts": (1, lambda o, m: m(o)),
             "combine": (0, lambda o, m: m(o))}
    with contextlib.ExitStack() as stack:
        for name, (first, wrap) in parts.items():
            stack.enter_context(mock.patch.object(
                MoE, name, ranged(name, getattr(MoE, name), first, wrap)))
        yield


def moe_train_split(prof):
    """Device ms of each MoE range, forward and backward, in a
    `profile_window` report, and its share of the device's busy time."""
    ranges = prof.get("annotated_ranges", {})
    busy = prof["device_busy_ms"]
    out = {}
    for name in MOE_RANGES:
        for key in (f"moe.{name}", f"moe.{name}.backward"):
            ms = ranges.get(key, {}).get("device_ms", 0.0)
            out[key[4:]] = dict(device_ms=ms,
                                share=ms / busy if busy else None)
    return out


def moe_train_profile(dev):
    """``--only moe-train-profile``: a fresh process's `torch.profiler` of
    one step of phase 19's deepseek-moe-16b (the dense first layer and
    ``MOE_TRAIN_LAYERS - 1`` MoE layers, 2 x 4096 tokens) after one untimed step: device busy time
    and idle share, the device time of each family of kernels by kernel
    name (`MOE_TRAIN_GROUPS`: #7's forward and backward, silu's, AdamW's,
    the GEMMs, the elementwise kernels, the reductions, the index
    kernels), and the routing, dispatch, experts and combine in ranges in
    the forward and the backward (`moe_train_ranges`)."""
    import torch
    from repro_torch.data import TokenPipelineConfig, batch_at_step
    from repro_torch.models import factory
    cfg, opt, step_fn = moe_train_cfg()
    params = factory.build(cfg).init(torch.Generator(dev).manual_seed(SEED))
    state = {"p": params, "o": opt.init(params)}
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=MOE_TRAIN_BATCH, seed=SEED)

    def one(step):
        batch = batch_at_step(pipe, step, device=dev)
        state["p"], state["o"], m = step_fn(state["p"], state["o"], batch)
        return float(m["loss"])

    one(0)
    log(f"  one {MOE_ARCH} training step ({cfg.n_layers} layers), "
        f"profiled:")
    with moe_train_ranges():
        out = profile_window(lambda: one(1), 1, MOE_TRAIN_GROUPS)
    busy = out["device_busy_ms"]
    out["shares"] = {n: r["ms"] / busy if busy else None
                     for n, r in out.get("groups", {}).items()}
    out["moe"] = split = moe_train_split(out)
    log("  shares of the device's busy time: " + ", ".join(
        f"{n} {r['ms']:.1f} ms"
        + (f" ({out['shares'][n]:.3f})" if busy else "")
        for n, r in out.get("groups", {}).items()))
    log("  moe ranges: " + ", ".join(
        f"{n} {r['device_ms']:.3f} ms"
        + (f" ({r['share']:.3f})" if r["share"] is not None else "")
        for n, r in split.items()))
    return out


def moe_train_all(dev, results):
    """Phase 19: (a) the kernels at the MoE step's shapes, (b) one MoE
    layer's backward against the indexing forms and twice, (c) 3 steps of
    deepseek-moe-16b at `MOE_TRAIN_LAYERS` and a repeated step, (d) the
    dense layer
    and one MoE layer in float32 against the plain path; then a fresh
    process's profile of one step."""
    import torch
    work = ROOT / "build" / "chip_smoke_train"
    work.mkdir(parents=True, exist_ok=True)
    fresh = Fresh("moe-train-profile", work)
    _flush_buf.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"kernels": moe_train_kernels(dev, results),
           "block": moe_block_backward(dev)}
    _flush_buf.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out["path"] = moe_train_path(dev)
    out["shallow"] = train_shallow_matches(dev, MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    out["profile"] = fresh.result(lambda line: line.startswith(
        ("    ", "  one ", "  shares", "  moe ")), timeout=360)
    return out


# ---- phase 20: sharded session pools ----------------------------------------

SHARD_D = 4                     # shards of the main sharded pool
SHARD_RESIDENTS = 3 * B // 4    # 3072 sessions: shards 0-2 full, 3 empty
SHARD_POPULATION = B + 512      # users who come and go
SHARD_WINDOWS = 4               # windows of (a), (b)'s continuation, (d)
SHARD_K = 4                     # steps a window (the controller's T)
SHARD_STEPS = 4                 # per-event steps of (a)
SHARD_DEPART = 0.02             # per resident and window
SHARD_LOST = 1                  # the shard (b) loses
SHARD_LM_STEPS = 8              # (e)'s decode steps


def shard_mesh(d):
    """D shards on the visible cards in turn (all on one card where there
    is one)."""
    import torch
    from repro_torch.distributed import fleet_mesh
    n = torch.cuda.device_count()
    return fleet_mesh(devices=[torch.device("cuda", i % n)
                               for i in range(d)])


def shard_counters():
    """The launch counters of the kernels a sharded fleet pool runs."""
    from repro_torch.kernels.plasticity import fused, kernel as K
    from repro_torch.obs import recorder as R
    return {"fleet_step": K.fleet_step, "fleet_step_q": K.fleet_step_q,
            "rollout": fused.rollout, "recorder": R.record_step}


class ShardDrives:
    """Drives of the population at a running time, and the kernel launches
    of the sharded pool's calls (``mcall``; the control's do not count)."""

    def __init__(self, n_in, t=0):
        import numpy as np
        self.base = np.random.default_rng(SEED + 52).standard_normal(
            (SHARD_POPULATION, n_in)).astype(np.float32)
        self.t = t
        self.launches = {k: 0 for k in shard_counters()}

    def __call__(self, users):
        import numpy as np
        mat = (np.sin(0.5 * self.t + self.base) * 1.5).astype(np.float32)
        self.t += 1
        return {u: mat[int(u[1:])] for u in users}

    def mcall(self, fn, *a, **kw):
        counters = shard_counters()
        before = {k: c.launches for k, c in counters.items()}
        out = fn(*a, **kw)
        for k, c in counters.items():
            self.launches[k] += c.launches - before[k]
        return out


def shard_cfg(dev, quant):
    """`firefly_snn.CONFIG` (or its int8 twin) and the rule on ``dev``."""
    import torch
    from repro_torch.configs import firefly_snn
    from repro_torch.core import snn
    cfg = (snn.quant_config(firefly_snn.CONFIG) if quant
           else firefly_snn.CONFIG)
    return cfg, [t.to(dev) for t in snn.init_theta(
        cfg, torch.Generator().manual_seed(SEED + 51), scale=0.05)]


class ShardPair:
    """One serving sequence on an unmeshed control pool ``c`` and on a pool
    ``m`` split over ``mesh``: 8-128-8, 4096 slots, RAM stores, the same
    rule, the same sessions (3072 admitted into slots 0-3071) and the same
    churn.  The first pair of a datapath admits them into ``c`` and saves
    it at ``seed``; ``m``, and both pools of a later pair, resume that
    checkpoint (`load_pool`, each on its own layout)."""

    def __init__(self, dev, quant, mesh, seed):
        import numpy as np
        from repro_torch.serving import FleetScheduler, SessionStore
        self.cfg, self.theta = shard_cfg(dev, quant)
        self.c = FleetScheduler(self.cfg, self.theta, slots=B, device=dev,
                                store=SessionStore())
        self.m = FleetScheduler(self.cfg, self.theta, slots=B, mesh=mesh,
                                store=SessionStore())
        self.drives = ShardDrives(self.cfg.layer_sizes[0])
        self.rng = np.random.default_rng(SEED + 53)
        if not os.path.isdir(seed):
            for i in range(SHARD_RESIDENTS):
                require(self.c.admit(f"u{i}") == i,
                        "a session did not land in its slot")
            self.c.save_pool(seed)
        else:
            self.c.load_pool(seed)
        self.m.load_pool(seed)
        require(self.m.slot_user == self.c.slot_user
                == [f"u{i}" for i in range(SHARD_RESIDENTS)]
                + [None] * (B - SHARD_RESIDENTS),
                "the sessions are not in slots 0-3071")

    def churn(self):
        """Each resident departs with SHARD_DEPART; as many arrivals come
        from the population's non-residents, into the freed slots."""
        c, m = self.c, self.m
        residents = [u for u in c.slot_user if u is not None]
        gone = [u for u, r in zip(residents, self.rng.random(len(residents)))
                if r < SHARD_DEPART]
        for u in gone:
            c.evict(u)
            m.evict(u)
        out = sorted(set(f"u{i}" for i in range(SHARD_POPULATION))
                     - set(c.user_slot), key=lambda u: int(u[1:]))
        for u in self.rng.choice(out, len(gone), replace=False):
            require(c.admit(str(u)) == m.admit(str(u)),
                    "the two pools admitted into other slots")
        return len(gone)


def rows_equal(a, b, what, users=None):
    """Two pools' outputs (uid -> row) equal bit for bit on ``users``."""
    import torch
    users = sorted(a) if users is None else users
    # stacked where they live, then one copy to the host each
    x = torch.stack([a[u] for u in users]).cpu()
    y = torch.stack([b[u] for u in users]).cpu()
    require(x.dtype == y.dtype and torch.equal(x, y),
            f"{what}: outputs differ (largest {float((x.float() - y.float()).abs().nan_to_num(1e30).max())})")


def sessions_equal(pa, pb, users, what):
    """The listed sessions' rows of every fleet leaf equal in two pools,
    whatever slots they sit in (a sharded pool gathered on the host)."""
    import torch
    from repro_torch.distributed import sharding as dsh
    fa, fb = dsh.gather(pa.fleet), dsh.gather(pb.fleet)
    ia = torch.tensor([pa.user_slot[u] for u in users])
    ib = torch.tensor([pb.user_slot[u] for u in users])
    for x, y in zip(fa.w + fa.v + fa.trace + fa.w_scale,
                    fb.w + fb.v + fb.trace + fb.w_scale):
        require(torch.equal(x[ia], y[ib]), f"{what}: session state differs")


def plain_shard_window(pair, d, drives, k):
    """Shard ``d``'s window through the plain window on host copies of its
    rows, drives, mask and seeds: ``(outs, new state)`` to hold against the
    kernels' (taken before ``m``'s window runs)."""
    import numpy as np
    import torch
    from repro_torch.core import snn
    from repro_torch.core.engine import NetworkState
    m, per = pair.m, B // SHARD_D
    lo = d * per
    f = m.fleet
    host = [tuple(x.pieces[d].cpu() for x in leaf)
            for leaf in (f.w, f.v, f.trace, f.w_scale)]
    st = NetworkState(w=host[0], v=host[1], trace=host[2],
                      t=f.t.cpu(), w_scale=host[3])
    x = np.zeros((per, pair.cfg.layer_sizes[0]), np.float32)
    for u, row in drives.items():
        if lo <= m.user_slot[u] < lo + per:
            x[m.user_slot[u] - lo] = row
    x = torch.from_numpy(x)
    active = m._active_mask()[lo:lo + per]
    seeds = m._seeds()[lo:lo + per]
    return snn.rollout_window(
        pair.cfg, st, [t.cpu() for t in pair.theta],
        x[None].expand(k, *x.shape), active=active, seed=seeds)


def held_shard(name, got, want, quant, what):
    """A shard's kernel window against its plain repeat: int8 bit for bit,
    float32 within 1e-5 (relative to the largest value, as `held`)."""
    import torch
    got, want = got.cpu(), want.cpu()
    if quant or not got.is_floating_point():
        require(torch.equal(got, want), f"{what}: {name} differs from the "
                f"plain window")
        return 0.0
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    require(err <= 1e-5 * scale, f"{what}: {name} off the plain window by "
            f"{err}")
    return err


def sharded_serving(dev, quant, mesh, tmp, report):
    """(a), (b) where the mesh has `SHARD_D` shards, and (c) on one
    datapath; returns the pair and (c)'s checkpoint."""
    import time
    import torch
    from repro_torch.kernels.plasticity import fused
    from repro_torch.serving import FleetScheduler, SessionStore
    d = mesh.size
    tag = f"{'int8' if quant else 'float32'}, D = {d}"
    t_part = time.perf_counter()
    pair = ShardPair(dev, quant, mesh, os.path.join(
        tmp, f"seed-{'q' if quant else 'f'}"))
    seconds = {"admit": time.perf_counter() - t_part}
    c, m, drives = pair.c, pair.m, pair.drives
    per = B // d
    require(all(p.shape[0] == per for p in m.fleet.w[0].pieces),
            f"{tag}: a shard does not hold {per} slots")
    out = {}
    # (a) windows and per-event steps under churn
    churned = 0
    for w in range(SHARD_WINDOWS):
        churned += pair.churn()
        drv = drives(c.active_users)
        repeat = d == SHARD_D and w == 1
        if repeat:
            plain = plain_shard_window(pair, 1, drv, SHARD_K)
        oc = c.pool_step(dict(drv), timesteps=SHARD_K)
        before = fused.rollout.launches
        om = drives.mcall(m.pool_step, dict(drv), timesteps=SHARD_K)
        require(fused.rollout.launches - before == d,
                f"{tag}: {fused.rollout.launches - before} rollout "
                f"launches in a window, not {d}")
        rows_equal(oc, om, f"{tag} (a) window {w}")
        if repeat:
            mine = sorted((u for u in om if per <= m.user_slot[u] < 2 * per),
                          key=m.user_slot.get)
            err = held_shard(
                "outputs", torch.stack([om[u] for u in mine]),
                torch.stack([plain[1][:, m.user_slot[u] - per]
                             for u in mine]), quant, f"{tag} (a) shard 1")
            f, g = m.fleet, plain[0]
            for name, a, b in (("w", f.w, g.w), ("v", f.v, g.v),
                               ("trace", f.trace, g.trace),
                               ("w_scale", f.w_scale, g.w_scale)):
                for x, y in zip(a, b):
                    err = max(err, held_shard(name, x.pieces[1], y, quant,
                                              f"{tag} (a) shard 1"))
            out["plain_window_max_abs_err"] = err
    for step in range(SHARD_STEPS):
        drv = drives(c.active_users)
        rows_equal(c.step(dict(drv)), drives.mcall(m.step, dict(drv)),
                   f"{tag} (a) step {step}")
    sessions_equal(c, m, c.active_users, f"{tag} (a)")
    out["churned"] = churned
    seconds["a"] = time.perf_counter() - t_part - sum(seconds.values())
    log(f"  {tag}: (a) {SHARD_WINDOWS} windows under churn ({churned} "
        f"sessions replaced) and {SHARD_STEPS} steps bit for bit the "
        f"unmeshed pool's" + (
            f"; shard 1's window against the plain window within "
            f"{out['plain_window_max_abs_err']:.3g}"
            if "plain_window_max_abs_err" in out else ""))
    if d == SHARD_D:
        # (b) a shard lost, its sessions drained into the empty shard
        warm = m.compiled_programs()
        require(m.persist_resident() == len(m.user_slot), "persist_resident")
        stranded = m.fail_device(SHARD_LOST, poison=True)
        require(len(stranded) == sum(
            1 for u in m.slot_user[SHARD_LOST * per:(SHARD_LOST + 1) * per]
            if u is not None), f"{tag} (b): stranded sessions")
        for u in stranded:          # the control pauses them
            c.evict(u)
        drv = drives(m.active_users)
        om = drives.mcall(m.pool_step, dict(drv), timesteps=SHARD_K)
        oc = c.pool_step({u: drv[u] for u in c.active_users},
                         timesteps=SHARD_K)
        rows_equal(oc, om, f"{tag} (b) survivors", sorted(oc))
        require(bool((torch.stack([om[u] for u in stranded]) == 0).all()),
                f"{tag} (b): a stranded output is not exactly 0")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = m.drain_failed()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        for u in stranded:
            c.admit(u)
        to = sorted({r["to_device"] for r in rep})
        require(sorted(r["uid"] for r in rep) == sorted(stranded)
                and all(r["from_device"] == SHARD_LOST for r in rep)
                and all(r["steps_lost"] == 0 for r in rep)
                and to == [SHARD_D - 1], f"{tag} (b): drain report "
                f"{rep[:2]}, into shards {to}")
        for w in range(SHARD_WINDOWS):
            drv = drives(c.active_users)
            rows_equal(c.pool_step(dict(drv), timesteps=SHARD_K),
                       drives.mcall(m.pool_step, dict(drv),
                                    timesteps=SHARD_K),
                       f"{tag} (b) window {w} after the drain")
        sessions_equal(c, m, c.active_users, f"{tag} (b)")
        require(m.compiled_programs() == warm, f"{tag} (b): new signatures "
                f"{m.compiled_programs()} after {warm}")
        out.update(stranded=len(stranded), drain_s=drain_s, to_devices=to)
        seconds["b"] = time.perf_counter() - t_part - sum(seconds.values())
        log(f"  {tag}: (b) shard {SHARD_LOST} lost: {len(stranded)} "
            f"sessions stranded (outputs 0, survivors bit for bit), drained "
            f"into shard {to} in {drain_s:.3f} s, steps_lost 0, "
            f"{SHARD_WINDOWS} windows bit for bit, no new signature")
    # (c) the elastic re-mesh
    path = os.path.join(tmp, f"pool-{'q' if quant else 'f'}-{d}")
    t0 = time.perf_counter()
    m.save_pool(path)
    save_s = time.perf_counter() - t0
    loaded = []
    for dd in ((2, None) if d == SHARD_D else (None,)):
        p = FleetScheduler(pair.cfg, pair.theta, slots=B,
                           store=SessionStore(),
                           **(dict(mesh=shard_mesh(dd)) if dd
                              else dict(device=dev)))
        p.load_pool(path)
        require(p.slot_user == m.slot_user, "load_pool occupancy")
        loaded.append((dd, p))
    for w in range(2):
        drv = drives(m.active_users)
        om = drives.mcall(m.pool_step, dict(drv), timesteps=SHARD_K)
        for dd, p in loaded:
            rows_equal(om, p.pool_step(dict(drv), timesteps=SHARD_K),
                       f"{tag} (c) window {w} at D = {dd or 'unmeshed'}")
    for dd, p in loaded:
        sessions_equal(m, p, m.active_users, f"{tag} (c) D = {dd}")
    out.update(save_s=save_s, resumed_at=[dd or 1 for dd, _ in loaded])
    seconds["c"] = time.perf_counter() - t_part - sum(seconds.values())
    out["seconds"] = seconds
    log(f"  {tag}: (c) saved in {save_s:.2f} s, resumed at D = "
        f"{[dd or 'unmeshed' for dd, _ in loaded]}: 2 windows bit for bit; "
        f"seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
    report[tag] = out
    return pair, path


def sharded_record(dev, quant, path, report):
    """(d): recorded windows at D = 4 against an unmeshed recording pool,
    both resumed from (c)'s checkpoint; one quarantine rolled back.
    Returns the sharded pool's recorder launches."""
    import torch
    from repro_torch.distributed import sharding as dsh
    from repro_torch.obs import recorder as R
    from repro_torch.serving import FleetScheduler, SessionStore
    tag = f"{'int8' if quant else 'float32'}, D = {SHARD_D}"
    cfg, theta = shard_cfg(dev, quant)
    drives = ShardDrives(cfg.layer_sizes[0], t=100)
    c = FleetScheduler(cfg, theta, slots=B, device=dev, store=SessionStore(),
                       health=health_config())
    m = FleetScheduler(cfg, theta, slots=B, mesh=shard_mesh(SHARD_D),
                       store=SessionStore(), health=health_config())
    for s in (c, m):
        s.load_pool(path)

    def window(what):
        drv = drives(c.active_users)
        oc = c.pool_step(dict(drv), timesteps=SHARD_K, record=True)
        before = R.record_step.launches
        om = drives.mcall(m.pool_step, dict(drv), timesteps=SHARD_K,
                          record=True)
        require(R.record_step.launches - before == SHARD_D,
                f"{tag} (d): {R.record_step.launches - before} recorder "
                f"launches in a window, not {SHARD_D}")
        rows_equal(oc, om, f"{tag} (d) {what}")
        for x, y in zip(tree_leaves(dsh.gather(c._rec)),
                        tree_leaves(dsh.gather(m._rec))):
            require(torch.equal(x, y), f"{tag} (d) {what}: recorder state "
                    "differs")
        require(torch.equal(dsh.host(c.last_verdict),
                            dsh.host(m.last_verdict)),
                f"{tag} (d) {what}: verdicts differ")

    for w in range(SHARD_WINDOWS):
        window(f"recorded window {w}")
    victim = m.active_users[len(m.active_users) // 2]
    for s in (c, m):
        s.health_checkpoint()
        s.quarantine(victim)
    window("with a quarantine")
    rc, rm = c.rollback(victim), m.rollback(victim)
    require(rc == rm and rc["steps_lost"] == SHARD_K,
            f"{tag} (d): rollback reports {rc} and {rm}")
    window("after the rollback")
    require(c.flagged_sessions() == m.flagged_sessions(),
            f"{tag} (d): flagged sessions differ")
    report[tag]["record"] = {"windows": SHARD_WINDOWS + 2, "rollback": rm,
                             "flagged": len(m.flagged_sessions()),
                             "launches": drives.launches["recorder"]}
    log(f"  {tag}: (d) {SHARD_WINDOWS + 2} recorded windows bit for bit "
        f"(ring, baselines, verdicts), {SHARD_D} recorder launches a "
        f"window; {victim} quarantined and rolled back ({rm['steps_lost']} "
        f"steps lost)")
    return drives.launches


def sharded_lm(dev, report):
    """(e): the LM decode pool at D = 2 against unmeshed, qwen3-4b at full
    width and `shallow` depth: the same tokens."""
    import torch
    from repro_torch.serving import LMScheduler
    model, params = pool_model(dev, cut=True)
    prompts = pool_prompts(model.cfg.vocab, dev)
    users = list(prompts)[:3]
    ref = LMScheduler(model, params, slots=POOL_SLOTS, max_len=POOL_MAX_LEN)
    m = LMScheduler(model, params, slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                    mesh=shard_mesh(2))
    for s in (ref, m):
        for u in users:
            s.admit_prompt(u, prompts[u])
    toks = []
    for _ in range(SHARD_LM_STEPS):
        a, b = ref.step(), m.step()
        require(a == b, f"(e): the sharded LM pool's tokens {b} are not the "
                f"unmeshed pool's {a}")
        toks.append(a)
    w = {u: torch.tensor([ref.pending(u), 3, 5, 7]) for u in users}
    la, lb = ref.decode_window(dict(w)), m.decode_window(dict(w))
    same = all(torch.equal(la[u].argmax(-1).cpu(), lb[u].argmax(-1).cpu())
               for u in users)
    require(same, "(e): the window's tokens differ")
    report["lm"] = {"arch": model.cfg.name, "layers": model.cfg.n_layers,
                    "slots": POOL_SLOTS, "shards": 2,
                    "steps": SHARD_LM_STEPS, "window_k": 4,
                    "logits_bitwise": all(torch.equal(la[u].cpu(),
                                                      lb[u].cpu())
                                          for u in users)}
    log(f"  (e) {model.cfg.name} ({model.cfg.n_layers} layers): "
        f"{SHARD_LM_STEPS} steps and a 4-token window at D = 2 give the "
        f"unmeshed tokens (window logits bit for bit: "
        f"{report['lm']['logits_bitwise']})")
    del ref, m, model, params


SHARD_HEAD_START = 10_000_000   # cycles the card sleeps before a timed call


def queued_ms(fn, reps=20):
    """Median device time of one call of ``fn``: CUDA events around it,
    with the L2 flushed by writing and the card then held in a sleep
    kernel (`SHARD_HEAD_START` cycles, ~5 ms), so the host has queued the
    whole call before the first event fires and the events time its
    kernels back to back, not the host's dispatch.  ``fn`` must not wait
    on the card (no copies from pageable host memory)."""
    import torch
    flush_l2("write")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush_l2("write")
        torch.cuda._sleep(SHARD_HEAD_START)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def sharded_window_time(pair, report):
    """(f): one window's device time, sharded (D launches on 1024 slots
    each, their operands already on the shards) beside the unmeshed
    pool's (one launch), by `queued_ms`; printed, not gated.  (Late in the
    whole script `torch.profiler` loses launches, so this phase times by
    events.)"""
    from repro_torch.distributed import sharding as dsh
    from repro_torch.kernels.plasticity import fused
    c, m = pair.c, pair.m
    drv = pair.drives(c.active_users)
    ops = {}
    for name, s in (("unmeshed", c), ("sharded", m)):
        x, _ = s._gather_rows(drv, None)
        act, seeds = s._active_mask(), s._seeds()
        if s.mesh is not None:
            place = dsh.SlotSharding(s.mesh, dsh.slot_pspec(0)).place
            x, act, seeds = place(x), place(act), place(seeds)
        def call(s=s, x=x, act=act, seeds=seeds):
            return s._launch(SHARD_K, x, None, act, seeds, False, False)

        before = fused.rollout.launches
        call()
        ops[name] = {"launches": fused.rollout.launches - before,
                     "device_ms": queued_ms(call)}
    report["window_time"] = ops
    log(f"  (f) a window of K = {SHARD_K}: sharded "
        f"{ops['sharded']['device_ms']:.4f} ms on the card "
        f"({ops['sharded']['launches']} launches) beside unmeshed "
        f"{ops['unmeshed']['device_ms']:.4f} ms "
        f"({ops['unmeshed']['launches']} launch)")


def sharded_pool(dev, results=None):
    """Phase 20 (and ``--only sharded-pool``): (a)-(d) on both datapaths
    at D = 4, (a) and (c) at D = every visible card, (e), (f).  Adds the
    sharded pools' launches to ``results``."""
    import tempfile
    import time
    import torch
    report = {"card": nvidia_smi(),
              "visible_cards": torch.cuda.device_count()}
    t0 = time.perf_counter()
    launches = {}
    every = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        for quant in (False, True):
            mode = "int8" if quant else "float32"
            pair, path = sharded_serving(dev, quant, shard_mesh(SHARD_D),
                                         tmp, report)
            if not quant:
                t1 = time.perf_counter()
                sharded_window_time(pair, report)
                report["window_time"]["seconds"] = time.perf_counter() - t1
            counts = dict(pair.drives.launches)
            del pair
            t1 = time.perf_counter()
            for k, n in sharded_record(dev, quant, path, report).items():
                counts[k] += n
            report[f"{mode}, D = {SHARD_D}"]["seconds"]["d"] = \
                time.perf_counter() - t1
            if every != SHARD_D:
                sharded_serving(dev, quant, shard_mesh(every), tmp, report)
            launches[mode] = counts
            for name in (("fleet_step_q",) if quant else ("fleet_step",)) \
                    + ("rollout", "recorder"):
                require(counts[name] > 0, f"phase 20 ({mode}): {name} was "
                        f"not launched")
            gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    sharded_lm(dev, report)
    report["lm"]["seconds"] = time.perf_counter() - t1
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t0
    log(f"  phase 20 seconds {report['seconds']:.1f} (the LM pool "
        f"{report['lm']['seconds']:.1f})")
    if results is not None:
        for mode, counts in launches.items():
            for name in (("fleet_step_q",) if mode == "int8"
                         else ("fleet_step",)) + ("rollout", "recorder"):
                results[name].setdefault("launches_by_path", {
                    "main path": results[name]["launches"]})[
                    f"sharded pool, {mode}"] = counts[name]
    return report


def nvidia_smi():
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() \
            else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def only_fleet_steps(dev):
    return {"shapes": time_fleet_shapes(dev, FLEET_MODES),
            "per_event": profile_per_event(dev)}


def only_shared_steps(dev):
    return {"shapes": time_shared_shapes(dev), **shared_step_launches(dev),
            "per_event": profile_online_per_event(dev)}


def only_lif_forward(dev):
    return {"shapes": time_lif_shapes(dev), **lif_forward_launches(dev),
            "forward_only": profile_forward_only(dev),
            "per_event": profile_online_per_event(dev)}


def only_attention(dev):
    return {"widths": time_attention_widths(dev), "ptxas": attention_ptxas()}


def only_rule_search(dev):
    from repro_torch.kernels.plasticity import fused
    results = {"rollout": {"max_abs_err": 0.0}}
    return rule_search(dev, (fused.rollout,), (fused.rollout,), results)[0]


def only_lm_pool(dev):
    results = {name: {"max_abs_err": 0.0}
               for name in ("rollout", "flash_attention", "ssd_scan")}
    return lm_pool(dev, results)


def only_kv_quant(dev):
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import layers as ML
    counters = (TA.flash_attention, SK.ssd_scan, ML.silu, K.fleet_step,
                K.fleet_step_q)
    results = {c.__name__: {"max_abs_err": 0.0} for c in counters}
    out, launches = kvq_path(dev, results, counters)
    out["launches"] = launches
    out["max_abs_err"] = {k: v["max_abs_err"] for k, v in results.items()}
    return out


def only_train(dev):
    """``--only train``: phase 17 alone."""
    results = {name: {"max_abs_err": 0.0}
               for name in ("flash_attention", "flash_attention_bwd",
                            "silu_bwd", "adamw")}
    out = train_all(dev, results)
    out["kernels"] = results
    return out


def only_ssm_train(dev):
    """``--only ssm-train``: phase 18 alone."""
    results = {name: {"max_abs_err": 0.0}
               for name in ("ssd_scan_bwd", "silu_bwd_mamba2")}
    out = ssm_train_all(dev, results)
    out["kernels"] = results
    return out


def only_moe_train(dev):
    """``--only moe-train``: phase 19 alone."""
    results = {name: {"max_abs_err": 0.0}
               for name in ("flash_attention", "flash_attention_bwd", "silu", "silu_bwd",
                            "adamw")}
    out = moe_train_all(dev, results)
    out["kernels"] = results
    return out


def only_moe(dev):
    from repro_torch.kernels.attention import kernel as TA
    from repro_torch.kernels.plasticity import kernel as K
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import layers as ML
    counters = (TA.flash_attention, SK.ssd_scan, ML.silu, K.fleet_step,
                K.fleet_step_q)
    results = {c.__name__: {"max_abs_err": 0.0} for c in counters}
    out, launches = moe_path(dev, results, counters, counters)
    out["launches"] = launches
    out["max_abs_err"] = {k: v["max_abs_err"] for k, v in results.items()}
    return out


# ``--only``'s parts: each runs one A/B measurement alone
ONLY = {"fleet-steps": only_fleet_steps, "shared-steps": only_shared_steps,
        "lif-forward": only_lif_forward, "attention": only_attention,
        "lm-prefill": profile_lm_prefills, "rule-search": only_rule_search,
        "health": only_health, "lm-pool": only_lm_pool,
        "lm-pool-profile": lm_pool_profile, "moe": only_moe,
        "moe-profile": moe_profile, "kv-quant": only_kv_quant,
        "kv-quant-profile": kvq_profile, "train": only_train,
        "train-profile": train_profile, "ssm-train": only_ssm_train,
        "ssm-train-profile": ssm_train_profile, "moe-train": only_moe_train,
        "moe-train-profile": moe_train_profile, "sharded-pool": sharded_pool}
# seconds after which a stalled phase (or ``--only`` part) prints every
# thread's stack and exits non-zero (`faulthandler`), well before the
# script's 1200 s
STALL_LIMITS = {"8": 300, "9": 300, "10": 300, "11": 300, "12": 240,
                "13": 240, "14": 240, "15": 240,
                "16": 480, "--only lm-pool": 240,
                "--only lm-pool-profile": 150, "--only moe": 240,
                "--only moe-profile": 150, "--only kv-quant": 480,
                "--only kv-quant-profile": 240, "17": 420,
                "--only train": 420, "--only train-profile": 300,
                "18": 480, "--only ssm-train": 480,
                "--only ssm-train-profile": 300, "19": 420,
                "--only moe-train": 420, "--only moe-train-profile": 300,
                "20": 240, "--only sharded-pool": 240, "--only health": 240}


def main() -> int:
    global PROFILES
    import torch
    PROFILES = bool({"--profiles", "--only"} & set(sys.argv[1:]))
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
    from repro_torch.models import layers as ML
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t_all = time.perf_counter()

    seconds = {}

    @contextlib.contextmanager
    def phase(title):
        """Log the phase's title, then its seconds when it ends.  An LM
        phase (`STALL_LIMITS`) that runs past its limit dumps every
        thread's stack to stderr and exits with code 1."""
        log(title)
        key = title.split(":")[0]
        limit = STALL_LIMITS.get(key.replace("phase ", ""),
                                 STALL_LIMITS.get(key))
        t0 = time.perf_counter()
        if limit:
            faulthandler.dump_traceback_later(limit, exit=True)
        try:
            yield
        finally:
            if limit:
                faulthandler.cancel_dump_traceback_later()
        seconds[key] = dt = time.perf_counter() - t0
        log(f"  ({key}: {dt:.1f} s)")

    with phase("phase 1: build"):
        info = _build.build_all()
        log(f"  built {len(info['built'])} sources in "
            f"{info['seconds']:.1f} s")
        for src, text in info["log"].items():
            for line in text.splitlines():
                if "Used" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")

    if "--only" in sys.argv[1:]:
        parts = sys.argv[sys.argv.index("--only") + 1:][:1]
        parts = parts[0].split(",") if parts else []
        require(parts and set(parts) <= set(ONLY),
                f"--only takes one or more of {', '.join(ONLY)} (comma "
                f"separated); got {parts}")
        if "--wait" in sys.argv[1:] and sys.stdin.readline().strip() != "go":
            return 2            # the process that started this one is gone
        out = {"card": smi}
        for part in parts:
            with phase(f"--only {part}"):
                out[part] = ONLY[part](dev)
        dest = (Path(sys.argv[sys.argv.index("--out") + 1])
                if "--out" in sys.argv[1:]
                else ROOT / "chiprun_out" / "chip_smoke_only.json")
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(json.dumps(out, indent=1))
        print(smi)
        return 0

    counters = (K.fleet_step, K.fleet_step_q, fused.rollout)
    online_counters = (fused.rollout_shared, K.shared_step, K.shared_step_q,
                       L.lif_forward)
    lm_counters = (TA.flash_attention, SK.ssd_scan, ML.silu, K.fleet_step,
                   K.fleet_step_q)
    every = counters + online_counters + (TA.flash_attention, SK.ssd_scan,
                                          ML.silu)
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
    with phase("phase 2g: silu against its plain version at the LM paths' "
               "shapes"):
        compare_silu(dev, results)
    with phase("phase 2e: the telemetry variants against their plain "
               "versions, 8-128-8, B = 4096"):
        compare_telemetry(dev, results)
    with phase("phase 2f: the bfloat16 kernels against their plain "
               "versions"):
        compare_bf16_steps(dev, results)
        compare_bf16_windows(dev, results)
    with phase("phase 2h: the recorder kernel against its plain version, "
               "8-128-8, B = 4096, and the adapter's N = 128, 512, B = 8"):
        compare_recorder(dev, results)

    with phase("phase 3: recovery gate"):
        recovery_gate(dev)

    with phase("phase 4: main path, 8-128-8 controller, B = 4096"):
        main, launches = main_path(dev, counters, every)
        for name, n in launches.items():
            results[name]["launches"] = n
        plain_closed_loop_matches(dev, main)
    profiled = profiled_online = {}
    if PROFILES:
        with phase("phase 4b: where the closed loop's time goes (20 control "
                   "steps; 5 per-event windows)"):
            profiled = profile_closed_loop(dev, main)
            profiled["per_event"] = profile_per_event(dev)
    with phase("phase 4f: main path in bfloat16, 8-128-8 controller, "
               "B = 4096"):
        bf16_main = bf16_controller_path(dev, main,
                                         (K.fleet_step, fused.rollout))
        for name, n in bf16_main["launches"].items():
            results[name]["launches"] = n
        bf16_main["recovery"] = bf16_recovery_gate(dev)

    with phase("phase 5: timing"):
        time_kernels(dev, results)
        time_telemetry(dev, results)
        file_shapes(results, time_fleet_shapes(dev, ("float32", "int8")))
        fleet_launches = fleet_step_launches(dev)
        results["rollout"]["sweep"] = sweep_fleet_window(dev)

    with phase("phase 6: online-learning path, 784-1024-10, T = 8, B = 1"):
        online, online_launches = online_path(dev, online_counters, every)
        for name, n in online_launches.items():
            results[name]["launches"] = n
        plain_stream_matches(dev, online)
    if PROFILES:
        with phase("phase 6b: where the online stream's time goes (10 "
                   "digits)"):
            profiled_online = profile_online(online)
    with phase("phase 6f: online-learning path in bfloat16, 784-1024-10, "
               "T = 8, B = 1"):
        bf16_online = bf16_online_path(
            dev, online, (fused.rollout_shared, K.shared_step, L.lif_forward))
        for name, n in bf16_online["launches"].items():
            results[name]["launches"] = n

    with phase("phase 7: Table II timings and the new kernels (L2 "
               "flushed)"):
        table = table2(dev, online)
        if PROFILES:
            table["profile_per_event"] = profile_online_per_event(dev)
        time_new_kernels(dev, results)
        time_shared_shapes(dev, ("float32", "int8"), results)
        shared_launches = shared_step_launches(dev)
        lif_launches = lif_forward_launches(dev)
    with phase("phase 7f: the bfloat16 kernels' times (L2 flushed)"):
        time_bf16_kernels(dev, results)
        file_shapes(results, time_fleet_shapes(dev, ("bfloat16",)))
        time_shared_shapes(dev, ("bfloat16",), results)
    with phase("phase 7b: the attention kernel at the prefill shape (L2 "
               "flushed)"):
        time_attention(dev, results)
    with phase("phase 7c: the SSD scan at the prefill shape (L2 flushed)"):
        time_ssd(dev, results)
    with phase("phase 7d: silu at the prefill MLP (L2 flushed)"):
        time_silu(dev, results)

    lm, lm_launches = {}, {}
    for tag, arch, layers in (
            ("8", "qwen3-4b", "36 attention layers"),
            ("9", "mamba2-1.3b", "48 SSM layers"),
            ("11", "zamba2-7b", "9 x (shared attention + 8 SSM layers)")):
        # the previous model and its caches are gone before the next loads
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
            f"before {arch}")
        with phase(f"phase {tag}: LM serving, {arch} at full width "
                   f"({layers}), B = 4, prompt 2048, 32 generated tokens, "
                   f"plastic adapter"):
            lm[arch], lm_launches[arch] = lm_path(dev, lm_counters, every,
                                                  results, arch, PROFILES)
        n_shallow = shallow(lm_config(arch)[0]).n_layers
        with phase(f"phase {tag}b: {arch}, {n_shallow} layers at full width "
                   f"in float32, kernels against the plain path"):
            lm_depth2_matches(dev, arch)
            if arch == "mamba2-1.3b":
                ssm_state_matches(dev)
        with phase(f"phase {tag}c: the serve CLI at its defaults, --arch "
                   f"{arch}"):
            lm[arch]["serve_cli_default"] = serve_cli_default(results, arch)
    # each LM kernel's launches in the timed runs of every path that ran
    # it; `launches` is this slice's path, zamba2-7b's, which runs them all
    for name in ("flash_attention", "ssd_scan", "silu"):
        results[name]["launches_by_path"] = {
            arch: n[name] for arch, n in lm_launches.items() if n[name]}
        results[name]["launches"] = lm_launches["zamba2-7b"][name]

    with phase(f"phase 10: session serving, 8-128-8 FleetScheduler, "
               f"{B} slots, float32 and int8"):
        served, serve_launches = serve_path(dev, every)
    for name in ("fleet_step_telemetry", "fleet_step_q_telemetry",
                 "rollout_telemetry"):
        results[name]["launches"] = serve_launches[name]

    with phase(f"phase 12: the rule search (PEPG) and Phase 2 on "
               f"{SEARCH_ENV}, 11-128-2, {SEARCH_GENERATIONS} generations"):
        search, search_launches = rule_search(dev, counters, every, results)
    with phase(f"phase 13: session health, 8-128-8 FleetScheduler, {B} "
               f"slots, float32 and int8"):
        health = health_path(dev, results)

    with phase(f"phase 14: the LM decode pool, qwen3-4b at full width, "
               f"{POOL_SLOTS} slots, float32 and int8; mamba2-1.3b and "
               f"zamba2-7b cut"):
        pool = lm_pool(dev, results, lm)

    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"phase 15: the MoE layout, {MOE_ARCH} at full width (a "
               f"dense layer and 27 MoE layers of 64 experts, top-6), "
               f"lockstep B = 4 and in a {POOL_SLOTS}-slot pool"):
        moe, lm_launches[MOE_ARCH] = moe_path(dev, results, lm_counters,
                                              every)
    for name in ("flash_attention", "silu"):
        results[name]["launches_by_path"][MOE_ARCH] = \
            lm_launches[MOE_ARCH][name]

    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"phase 16: the int8 KV cache, {KVQ_ARCH} at full width (64 "
               f"layers, 40 heads of 128 over 40 KV heads), lockstep B = 4 "
               f"and in a {POOL_SLOTS}-slot pool; {', '.join(KVQ_OTHERS)} "
               f"at full width, qwen2-72b at smoke scale"):
        kvq, lm_launches[KVQ_ARCH] = kvq_path(dev, results, lm_counters)
    for name in ("flash_attention", "silu"):
        results[name]["launches_by_path"][KVQ_ARCH] = \
            lm_launches[KVQ_ARCH][name]
    results["fleet_step_q"].setdefault("launches_by_path", {
        "main path": results["fleet_step_q"]["launches"]})[
        f"{KVQ_ARCH}, int8 cache"] = lm_launches[KVQ_ARCH]["fleet_step_q"]

    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"phase 17: LM training, {TRAIN_ARCH} at full width "
               f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens, 2 microbatches, AdamW, "
               f"remat), #7's and silu's backward kernels"):
        trained = train_all(dev, results)
    for name in ("flash_attention", "silu"):
        results[name]["launches_by_path"][f"{TRAIN_ARCH} training"] = \
            trained["path"]["launches"][2 if name == "flash_attention"
                                        else 4]

    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"phase 18: ssm and hybrid training, mamba2-1.3b at full "
               f"width ({SSM_TRAIN['mamba2-1.3b']['batch']} x {TRAIN_SEQ} "
               f"tokens, 2 microbatches) and zamba2-7b at 3 of its 9 "
               f"super-blocks ({SSM_TRAIN['zamba2-7b']['batch']} x "
               f"{TRAIN_SEQ}, 4 microbatches), #8's and silu's Mamba2 "
               f"backward kernels"):
        ssm_trained = ssm_train_all(dev, results)
    for arch, p in ssm_trained["path"].items():
        for name, k in (("ssd_scan", 0), ("silu", 4), ("flash_attention", 2)):
            if p["launches"][k]:
                results[name]["launches_by_path"][f"{arch} training"] = \
                    p["launches"][k]

    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"phase 19: MoE training, {MOE_ARCH} at full width cut to "
               f"{MOE_TRAIN_LAYERS} layers ({MOE_TRAIN_BATCH} x {TRAIN_SEQ} "
               f"tokens, 2 microbatches), the dispatch's and combine's "
               f"backwards"):
        moe_trained = moe_train_all(dev, results)
    for name, k in (("flash_attention", 2), ("flash_attention_bwd", 3),
                    ("silu", 4), ("silu_bwd", 5), ("adamw", 6)):
        results[name].setdefault("launches_by_path", {
            f"{TRAIN_ARCH} training": results[name]["launches"]})[
            f"{MOE_ARCH} training"] = moe_trained["path"]["launches"][k]

    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"phase 20: sharded session pools, 8-128-8 FleetScheduler, "
               f"{B} slots over {SHARD_D} shards and over every visible "
               f"card, float32 and int8; the LM pool over 2 shards"):
        sharded = sharded_pool(dev, results)

    # #3 fleet's launches in each path that ran it; `launches` stays the
    # controller's (phase 4)
    results["rollout"]["launches_by_path"] = {
        "controller": results["rollout"]["launches"],
        **{f"rule search, {k}": v["rollout"]
           for k, v in search_launches.items()}}
    # the LM pool's launches of each kernel it runs, per datapath
    for mode in ("float32", "int8"):
        for name, key in (("rollout", "rollout"),
                          ("fleet_step_q" if mode == "int8" else
                           "fleet_step", None),
                          ("recorder", "record_step"),
                          ("flash_attention", None), ("silu", None)):
            by = results[name].setdefault(
                "launches_by_path", {"main path": results[name]["launches"]})
            by[f"lm pool, {mode}"] = pool[mode]["launches"][key or name]

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
              "bf16_main_path": bf16_main, "bf16_online_path": bf16_online,
              "table2": table,
              "lm_path": lm, "lm_launches": lm_launches,
              "serve_path": served, "serve_launches": serve_launches,
              "rule_search": search, "rule_search_launches": search_launches,
              "health_path": health, "lm_pool": pool, "moe_path": moe,
              "kv_quant_path": kvq, "train_path": trained,
              "ssm_train_path": ssm_trained, "moe_train_path": moe_trained,
              "sharded_pool": sharded,
              "profile": profiled, "profile_online": profiled_online,
              "fleet_step_launches": fleet_launches,
              "shared_step_launches": shared_launches,
              "lif_forward_launches": lif_launches,
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
