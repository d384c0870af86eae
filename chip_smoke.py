#!/usr/bin/env python3
"""Smoke run of the PyTorch port (reinmav_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: a CUDA device is required (no CPU carry-on); prints the
   card's name and power limit from nvidia-smi.
2. Build: compiles the hand-written kernels from reinmav_tpu_torch/csrc/
   with nvcc and prints the build time.
3. Philox known answers: Random123's two vectors, on the device,
   through the kernel library.
4. Kernel K1 against its plain PyTorch twin, on the card: a no-reset leg
   (65,536 envs x 200 steps), an auto-reset leg (65,536 x 1000, counting
   the envs that disagree), determinism, the state envelope, and the
   kernel path of throughput_rollout against the env core's eager loop.
5. The main path through the public API: make("quadrotor3d-v0"),
   vreset, control_rollout of 4096 envs x 400 steps (mean distance to
   the reference point), then throughput_rollout of 2,097,152 envs x
   1000 steps with backend="auto", which must launch K1.
6. K1 against its plain twin at the main path's shape (2,097,152 envs
   x 1000 steps, auto-reset on, one seed on both sides), and both timed
   there with CUDA events after a warm-up, in env-steps/s.
7. Kernel K2 (the fused PPO rollout) against its plain twin at the
   training path's 32,768 envs x 32 steps, with action noise and resets
   on: the envs that disagree anywhere in their trajectory, the relative
   error of logp, value, reward and the moment sums; both timed.
8. Kernel K3 (the fused PPO loss gradient) against its plain twin on one
   full minibatch (262,144 samples in tiles of 128) of the phase-7
   trajectory, in clip mode; a rerun must be bitwise equal; both timed.
9. The training path through the public API: reinmav_tpu_torch.rl.ppo
   with PpoConfig(num_envs=32768, rollout_len=32, fused_update="off") on
   make("quadrotor3d-v0"), 2 warm-up updates and 5 timed ones.  K2 must
   launch once and K3 16 times per update, and the metrics must be
   finite.  The same 7 updates from the same state through the eager
   rollout and autograd must give each update's mean_reward within 10%.
10. Kernel K4 (the whole PPO update in one cooperative launch) on the
   phase-7 trajectory, one update of 4 epochs x 4 minibatches of 262,144
   samples: against its plain twin (params, Adam moments, metrics; the
   entries outside rtol 2e-4 / atol 1e-6 are counted), against the loop of
   16 K3 launches + ClipAdam (whose per-pass sums are K4's), pass 0's
   gradient bitwise equal to one K3 launch, a rerun bitwise equal; K4 and
   its twin timed.
11. The default training path: PpoConfig(num_envs=32768, rollout_len=32)
   through rl.ppo.train_step, 2 warm-up and 5 timed updates.  K2 and K4
   must launch once per update and K3 never; each update's mean_reward
   within 10% of the fused_update="off" path's from the same state.  A
   resume at that size: 2 updates, a checkpoint, a restore into a state
   of another seed and 2 more must be bitwise the 4 uninterrupted ones.
   Then the CLI, python -m reinmav_tpu_torch.rl.run, in a subprocess: 10
   updates at that size with an evaluation every 5 and a checkpoint under
   chiprun_out/, then --load_path ... --play --play_steps=200; both must
   exit 0.
12. Kernel K5 (the hover task's constant-action throughput rollout)
   against its plain twin at 65,536 envs x 1000 steps, free-running
   through the deterministic resets, for the zero action and for
   (0.75, 0.73, 0.74, 0.76), from perturbed hover states: the envs that
   disagree (0.1% limit), the reward total, a bitwise rerun.  Then the
   hover main path: throughput_rollout(make("MujocoQuadForce-v1"),
   2,097,152 envs x 1000 steps, backend="auto") must launch K5; K5 and its
   twin timed at that shape.
13. Kernel K6-hover (the fused PPO rollout of MujocoQuadForce-v1) against
   its twin at 32,768 x 32 with noise and resets on, as phase 7; then K3
   and K4 built for the 13-dim observation against their twins on that
   trajectory, at phases 8 and 10's tolerances, with bitwise reruns; all
   timed.
14. Hover training: 2 warm-up and 5 timed updates of the default path
   (K6-hover and K4 once per update, K3 never) and of fused_update="off"
   (K6-hover once, K3 16 times per update), each update's mean_reward
   within 10% of the eager rollout + autograd path's from the same state;
   then the CLI on hover in subprocesses: 10 updates with an evaluation
   every 5 and a checkpoint under chiprun_out/, then --play
   --play_steps=200; both must exit 0.
15. Kernel K7 (the fused off-policy collection step) against its plain
   twin at 65,536 envs with a 2 x 256 actor, on both kinds (the hover task
   and quadrotor3d-v0), in five legs: sac and td3 with noise, sac_det,
   td3_det, and sac with the warmup gate; the envs whose replay block or
   new state differ are counted (0.1% limit), a rerun must be bitwise
   equal; K7 and its twin timed in the mode each kind trains with.
16. SAC training at the reference bench's config (bench.py:175-177: the
   hover task, 65,536 envs, batch 8192, a 2^21-column ring, 2 x 256, one
   update per iteration, no warmup) through rl.sac.train_iters on the
   card: a warm-up call, then 200 timed iterations, which must launch K7
   200 times, give finite metrics and advance the ring; env-steps/s end to
   end.  Then 5 iterations from the same state with K7 and with the eager
   collection: each iteration's mean_reward within 10%.
17. TD3 on quadrotor3d-v0 and DDPG on the hover task at that size: K7 in
   td3 mode once per iteration, finite metrics, the actor moving.
18. The CLI for the off-policy learners in subprocesses: SAC on the hover
   task trains with evaluation and a checkpoint, resumes from it and
   plays; TD3 on quadrotor3d-v0 trains and plays; each must exit 0.
19. Learning: SAC on the hover task at the config of the reference's
   learning artifact (benchmarks/artifacts/sac_hover_20M_r5: 8192 envs,
   batch 2048, 16 updates per iteration, 2 x 64, warmup 10,000) for 8
   calls of 64 iterations; from the window the artifact logs first
   (2,097,152 env steps) to the last, mean_reward must rise and done_frac
   fall.  The artifact's values are printed beside them as a reference.
20. Kernels K8 (quadrotor2d-v0) and K9 (the two slung-load envs), one
   closed-loop template: for each env, throughput_rollout of 2,097,152
   envs x 1000 steps through the public API must launch it once; the
   kernel against its twin at that shape with resets on, free-running (the
   envs apart: at most 0.1% for quadrotor2d-v0; a count for the slung-load
   envs, whose taut envs sit on the tether sphere, where a last-bit
   difference picks the other branch), both timed; then 50 steps one at a
   time from the twin's state at full width, 0 envs outside rtol 2e-4 /
   atol 2e-5 off the knife edges (within 1e-4 of the sphere, or a done
   flag that differs), whose env-steps are counted; a bitwise rerun.
21. For each of those envs: the fused PPO rollout (K6-rest) against its
   twin at 32,768 x 32 with noise and resets on (quadrotor2d-v0 as phase
   7; the slung-load kinds one step at a time from the twin's state off
   the sphere, the free-running count reported), K3 and K4 built for its
   (obs, action) dims, (5, 2), (9, 2) or (16, 4), against their twins as
   phases 8 and 10; then 2 warm-up and 5 timed updates of the default path
   (K6 and K4 once per update, K3 never) and of fused_update="off" (K6
   once, K3 16 times), each update's mean_reward within 10% of the other.
22. K7 on each of those kinds against its twin in the five mode legs of
   phase 15 at 65,536 envs, 2 x 256; then SAC and TD3 through train_iters
   at that size, K7 once per iteration.
23. The CLI on quadrotor2d-v0, as phase 11's.
24. Kernel K10 (reinmav-v0's rollout of 50/51-substep steps), at
   benchmarks/sweep.py:133-135's sizes: throughput_rollout(make(
   "reinmav-v0")) through the public API at 131,072 x 500 and at 8192 x 500
   must launch K10 once each, with reward sums exactly 90 x 500 and no
   reset; K10 against its twin free-running at 131,072 x 50 from perturbed
   init states (max |err| <= 1e-3, the envs outside rtol 2e-4 / atol 2e-5
   reported, every step's substep count equal to the twin's), its counts
   over 500 steps equal to the float32 recurrence's (14 x 51 in 400 steps
   from t = 0), a bitwise rerun; K10 timed at 131,072 x 500, at 8192 x 500
   and at 131,072 x 50, the twin at 131,072 x 50 (its time at 500 steps is
   an estimate, scaled, in the text only).
25. Kernel K11 (the contact envs' rollout with the coupled contact solve),
   for each of MujocoQuadForce-v0 and MujocoQuadQuat-v0: throughput_rollout
   at 131,072 x 500 through the public API must launch it once (zero reward
   sums, the bodies resting on the plane) and be bitwise the kernel's run
   that records its tier mix (the substeps that solved nothing, 16 or 48
   candidates), from which the bound is counted; K11 against its twin 10
   steps one at a time from the twin's state at 131,072 envs from contact-
   heavy states, 0 envs outside rtol 2e-4 / atol 2e-5 off the knife edges (a
   candidate within 1e-6 of the plane), which are counted; free-running at
   8192 x 100, mean Σz within 1% of the twin's and min z > -0.1; the forced
   48-candidate sweep bitwise the gated one; bitwise reruns; K11 timed at
   131,072 x 500 and on one step at 131,072, the twin on one step (its time
   at 500 steps is an estimate, scaled, in the text only); ptxas's
   registers and spills of K10 and K11.

The second-to-last line is a JSON object describing each kernel of the
paths (K1-K11): its launches on its main path, its error against its twin,
its time and its twin's (each measured; where the twin ran at a smaller
shape than the kernel, ``plain_at`` names that shape and
``ms_at_plain_shape`` is the kernel's time there), and its bound (the least
time the card could take: the larger of its bytes over the memory rate and
its FP32 operations over the FP32 rate).  The last line is {"ok": true, "device": {...}}.
The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import logging
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

TOL = dict(rtol=2e-4, atol=2e-5)  # the JAX kernel tests' float32 tolerances
RTOL_REWARD = 1e-4
B_CHECK, T_NO_RESET, T_RESET = 65_536, 200, 1000
B_MAIN, T_MAIN = 2_097_152, 1000
B_QUICK, T_QUICK = 4096, 400
REF = (0.0, 0.0, 2.0)
B_PPO, T_PPO = 32_768, 32  # bench.py:78-137's PPO leg
GRAD_TOL = dict(rtol=2e-3, atol=2e-6)  # tests/test_pallas_ppo.py's own
METRIC_TOL = dict(rtol=2e-4, atol=1e-6)
WARMUP_UPDATES, TIMED_UPDATES = 2, 5

# The card's published peaks (H100 SXM data sheet, at 700 W).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per unit of work, counted from the kernels' sources:
# K1, per env-step: the geometric controller and the dynamics, about 150
# (hand count, PERF.md).  K2, per env-step: the actor-critic's products
# without the fused layer's zero blocks, 2 * (10*128 + 2*64*64 + 64*4 +
# 64*1) = 19,584 (tanh, the env step and Philox not counted).  K3, per
# sample: that forward (9,792 FMA) and the backward's products, dW_out and
# dh2 (2 * 320), dW2 and dh1 (2 * 8192), dW1 (1280): 28,096 FMA = 56,192.
# K4: K3's count per sample of each pass (the optimiser's ~10k-entry
# vectors are negligible).
OPS_K1, OPS_K2, OPS_K3 = 150, 19_584, 56_192
# K5, per env-step: two substeps of the hover step (hover_common.cuh) and
# the reward, about 2 * 257 + 40 = 554 (hand count; the sin, cos, sqrt,
# rsqrt and the eight divisions of a substep counted as one each).  K6-hover,
# per env-step: the actor-critic at obs 13, 2 * (13*128 + 2*64*64 + 64*4 +
# 64*1) = 20,352, plus that env step.  K3 at obs 13, per sample: forward
# 10,176 FMA, backward 640 + 16,384 + 1,664 (dW1): 28,864 FMA = 57,728.
OPS_K5 = 554
OPS_ROLLOUT = {10: OPS_K2, 13: 20_352 + OPS_K5}
OPS_LOSS = {10: OPS_K3, 13: 57_728}
B_HOVER_CHECK = 65_536
HOVER_ACTIONS = ((0.0, 0.0, 0.0, 0.0), (0.75, 0.73, 0.74, 0.76))
HOVER = "MujocoQuadForce-v1"
HOVER_RET_VAR = 4.0 * (98.0 / 1.4) ** 2
UPDATE_TOL = dict(rtol=2e-4, atol=1e-6)  # tests/test_pallas_ppo_update.py's own
MOMENT_TOL = dict(rtol=2e-4, atol=5e-8)
UPDATE_METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
CLI_UPDATES, PLAY_STEPS = 10, 200
# Off-policy (phases 15-19).  bench.py:175-177's SAC leg: hover, 65,536
# envs, batch 8192, a 2^21-column ring, 2 x 256, one update per iteration,
# no warmup.
B_OFF, BATCH_SAC, RING_SAC, H_SAC = 65_536, 8192, 1 << 21, 256
SAC_WARMUP_ITERS, SAC_ITERS, SAC_COMPARE_ITERS, TD3_ITERS = 5, 200, 5, 10
# K7's mode legs: (mode, warmup gate, explore noise).
K7_MODES = (("sac", 0.0, 0.0), ("td3", 0.0, 0.3), ("sac_det", 0.0, 0.0), ("td3_det", 0.0, 0.0),
            ("sac", 1.0, 0.0))
# FP32 operations of one env step besides the actor, by state dim: the
# quadrotor3d dynamics (K1's count, the controller's share included, an
# upper count) and the hover step (K5's).
OPS_ENV_STEP = {10: OPS_K1, 13: OPS_K5}
CLI_OFF_ENVS, CLI_OFF_BATCH, CLI_OFF_ITERS, CLI_OFF_RING = 8192, 2048, 8, 1 << 17
# quadrotor2d-v0 and the slung-load envs (phases 20-23).  FP32 operations
# per env-step, hand counts from csrc/quad2d_common.cuh and
# csrc/slung_common.cuh (atan2, sin, cos and sqrt counted as one each; the
# slung steps' taut branch): the planar PD controller 18, the geometric
# controller 100 (K1's count less its dynamics), the quad2d step 40, the
# slung2d step 120, the slung3d step 200.  K3 per sample at (D, A): the
# forward 128 D + 8192 + 64 A + 64 FMA, the backward 128 D + 16,384 + 128 A
# + 128, so 2 (256 D + 192 A + 24,768) operations (56,192 at (10, 4)).
NATIVE = {"quadrotor2d-v0": (5, 2), "quadrotor2d-slungload-v0": (9, 2),
          "quadrotor3d-slungload-v0": (16, 4)}
TETHER = {"quadrotor2d-slungload-v0": 2, "quadrotor3d-slungload-v0": 3}  # position dims
KNIFE = 1e-4  # tests/test_pallas_slungload.py's skip of the lanes near the sphere
OPS_CONTROL = {5: 18, 9: 18, 16: 100}
OPS_STEP = {5: 40, 9: 120, 16: 200}
OPS_ROLLOUT.update({d: 2 * (d * 128 + 2 * 64 * 64 + 64 * a + 64) + OPS_STEP[d]
                    for d, a in NATIVE.values()})
OPS_LOSS.update({d: 2 * (256 * d + 192 * a + 24_768) for d, a in NATIVE.values()})
OPS_ENV_STEP.update(OPS_STEP)
T_RESYNC = 50  # steps of the closed loops' resynchronised check
NATIVE_ITERS = 5  # SAC and TD3 iterations on each new kind
# reinmav-v0 and the contact envs (phases 24-25), at benchmarks/sweep.py:133-
# 135's sizes: every env at 131,072 x 500, reinmav-v0 also at its default
# --reinmav_batch of 8192.
B_SWEEP, T_SWEEP, B_REINMAV = 131_072, 500, 8192
T_K10_CHECK = 50  # steps of K10's free-running check against its twin
# K10, FP32 operations per substep, a hand count from csrc/reinmav_rollout.cu
# (asin, atan2, sin and cos as one each): the quaternion's matrix 30, the
# Euler extraction 10, the quintic reference 23, the PD controller 43, the
# mixer with its clamps 27, the accelerations 7, the quaternion derivative
# 35, the angular acceleration 42, the Euler update 26, the substep time 2.
# A step runs 50 or 51 substeps, counted from this run's times.
OPS_K10_SUBSTEP = 245
# K11, FP32 operations, a hand count from csrc/contact_rollout.cu and
# hover_common.cuh (sqrt, rsqrt, sin, cos and divisions as one each): per
# substep the rigid body (rotation 30, free wrench 50, gyroscopic term 9,
# integration 80) and the z test of the 48 candidates (20 each); per
# substep that solves, the env's frame 40 and, per candidate of its tier
# (16 or 48), the setup 190 and, per sweep stage, 22 (the projected update
# 15, the arm products 3, its share of the four sums 4), plus 12 per stage
# for the env (eF and the wrench).
OPS_K11 = dict(rigid=170, ztest=20, frame=40, setup=190, stage_cand=22, stage_env=12)
T_K11_RESYNC, B_K11_FREE, T_K11_FREE, T_K11_TIERS = 10, 8192, 100, 10
KNIFE_PLANE = 1e-6  # a contact candidate this close to the plane is a knife edge
# The learning artifact's config (benchmarks/artifacts/sac_hover_20M_r5/
# metrics.jsonl, line 1: calls of 64 iterations, logged every 4 calls),
# run for LEARN_CALLS calls.
LEARN_ENVS, LEARN_BATCH, LEARN_GRAD_STEPS, LEARN_HIDDEN = 8192, 2048, 16, 64
LEARN_WARMUP, LEARN_RING, LEARN_WINDOW = 10_000, 1 << 20, 64
LEARN_CALLS, LEARN_FIRST_LOG = 8, 4


def say(msg: str) -> None:
    print(msg, flush=True)


def gpu_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int):
    """Milliseconds of each of ``reps`` runs of ``fn()``, each between its
    own pair of CUDA events, and the result of the last run."""
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        out = fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in pairs], out


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least milliseconds the card could take for work that moves
    ``nbytes`` and does ``flops`` FP32 operations, and which bounds it."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _mismatched_envs(torch, a, b):
    """Envs whose K2 trajectory, final state or return differ anywhere
    between ``a`` and ``b`` (rtol 2e-4 / atol 2e-5), as a bool mask."""
    bad = (a.done != b.done).any(dim=0)
    for x, y in zip((*a[:5], a.final_states), (*b[:5], b.final_states)):
        close = torch.isclose(x, y, **TOL)
        bad |= ~close.reshape(-1, close.shape[-1]).all(dim=0)
    return bad | ~torch.isclose(a.returns, b.returns, **TOL)


def count_outside(a, b, tol) -> int:
    """Entries of ``a`` outside ``tol`` of ``b``."""
    import torch

    return int((~torch.isclose(a, b, **tol)).sum())


def k4_phase(torch, dev, gpu: str, cfg, params, data, adv, tile: int, n_tiles: int,
             adim: int) -> dict:
    """Phase 10: K4 on the phase-7 trajectory, one 4 x 4 update from the
    rollout's own params (so pass 0's ratios are 1, as in training).
    Returns K4's timings and errors for the ``kernels`` line."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_update as pu
    from reinmav_tpu_torch.rl import ppo

    n = data.shape[1]
    e_, m_ = cfg.num_epochs, cfg.num_minibatches
    n_passes, tpm = e_ * m_, n_tiles // m_
    gen = torch.Generator().manual_seed(9)
    perm_all = torch.cat([ppo._shuffle_indices(gen, n_tiles, dev)
                          for _ in range(e_)]).to(torch.int32).contiguous()
    adv_stats = ppo.pass_adv_stats(adv.reshape(n), perm_all, tile, n_passes, True)
    params = params.contiguous()
    opt = ppo.make_optimizer(cfg).init(params)
    d = data.shape[0] - adim - 4  # obs rows of the stacked batch
    kw = dict(d=d, adim=adim, tile=tile, n_minibatches=m_, n_epochs=e_, clip_eps=cfg.clip_eps,
              value_clip_eps=cfg.value_clip_eps, value_coef=cfg.value_coef,
              ent_coef=cfg.entropy_coef, lr=cfg.learning_rate, max_grad_norm=cfg.max_grad_norm)
    k4_run = lambda: pu.ppo_update(data, adv_stats, perm_all, params, opt, None,  # noqa: E731
                                   keep_grad0=True, **kw)
    k4_plain = lambda: pu.ppo_update_reference(data, adv_stats, perm_all, params,  # noqa: E731
                                               opt, None, **kw)
    k4_run()
    k4_plain()  # warm-ups
    torch.cuda.synchronize()
    p0, (tw_params, tw_opt, tw_sums, tw_grad0) = cuda_ms(k4_plain, 10)
    kern0, k = cuda_ms(k4_run, 10)
    kern1, _ = cuda_ms(k4_run, 10)
    p1, _ = cuda_ms(k4_plain, 10)
    mb = tpm * tile
    tw_metrics = pu._metric_means(tw_sums, n_passes, m_, mb, False)

    # Against the twin.
    errs = {name: (float((a - b).abs().max()), count_outside(a, b, tol))
            for name, a, b, tol in (("params", k.params, tw_params, UPDATE_TOL),
                                    ("mu", k.opt_state.mu, tw_opt.mu, MOMENT_TOL),
                                    ("nu", k.opt_state.nu, tw_opt.nu, MOMENT_TOL))}
    say(f"K4 vs twin, obs {d}, one update of {e_} x {m_} passes of {mb} samples (tile {tile}): "
        + ", ".join(f"{name} max |err| {e:.3e}, {c} of {k.params.numel()} outside rtol 2e-4 "
                    f"atol {tol['atol']:g}" for (name, (e, c)), tol in
                    zip(errs.items(), (UPDATE_TOL, MOMENT_TOL, MOMENT_TOL))))
    require(torch.allclose(k.params, tw_params, **UPDATE_TOL) and
            torch.allclose(k.opt_state.mu, tw_opt.mu, **MOMENT_TOL) and
            torch.allclose(k.opt_state.nu, tw_opt.nu, **MOMENT_TOL),
            f"K4 vs twin: params or moments out of tolerance ({errs})")
    require(int(k.opt_state.count) == int(tw_opt.count) == n_passes, "K4 Adam count")
    for name, v in tw_metrics.items():
        require(torch.allclose(k.metrics[name], v, **UPDATE_METRIC_TOL), f"K4 vs twin, {name}")
    grad0_err = float((k.grad0 - tw_grad0).abs().max())
    require(torch.allclose(k.grad0, tw_grad0, **GRAD_TOL), "K4 pass-0 gradient vs twin")

    # Pass 0's gradient, bitwise one K3 launch on the same minibatch.
    zero = torch.zeros((), device=dev)
    k3_stats = lambda q: torch.stack([adv_stats[q, 0], adv_stats[q, 1], zero, zero])  # noqa: E731
    loss_kw = dict(d=d, adim=adim, clip_eps=cfg.clip_eps, value_clip_eps=cfg.value_clip_eps,
                   value_coef=cfg.value_coef, ent_coef=cfg.entropy_coef, tile=tile)
    g3, _ = pl.ppo_loss_grads_gather(data, k3_stats(0).contiguous(), perm_all[:tpm].contiguous(),
                                     params, **loss_kw)
    require(torch.equal(k.grad0, g3), "K4 pass-0 gradient bitwise equal to K3's")

    # Against the loop of 16 K3 launches + ClipAdam: the same per-pass sums.
    optimizer = ppo.make_optimizer(cfg)
    lp, lopt = params, opt
    for q in range(n_passes):
        g, _ = pl.ppo_loss_grads_gather(data, k3_stats(q).contiguous(),
                                        perm_all[q * tpm:(q + 1) * tpm].contiguous(), lp, **loss_kw)
        lp, lopt = optimizer.update(g, lopt, lp)
    loop_err = float((k.params - lp).abs().max())
    require(torch.allclose(k.params, lp, **UPDATE_TOL),
            f"K4 vs the K3 loop, params ({count_outside(k.params, lp, UPDATE_TOL)} outside)")
    require(torch.allclose(k.opt_state.mu, lopt.mu, **MOMENT_TOL) and
            torch.allclose(k.opt_state.nu, lopt.nu, **MOMENT_TOL), "K4 vs the K3 loop, moments")
    again = k4_run()
    require(torch.equal(k.params, again.params) and
            all(torch.equal(a, b) for a, b in zip(k.opt_state, again.opt_state)) and
            all(torch.equal(k.metrics[x], again.metrics[x]) for x in k.metrics),
            "K4 bitwise determinism")
    say(f"K4 pass-0 gradient: bitwise equal to one K3 launch, max |err| {grad0_err:.3e} against "
        f"the twin's (rtol 2e-3 atol 2e-6); params and moments within tolerance of the twin; vs "
        f"the K3 loop max |err| {loop_err:.3e} (rtol 2e-4 atol 1e-6, moments atol 5e-8); metrics "
        f"{', '.join(f'{x} {float(v):.5g}' for x, v in k.metrics.items())} (rtol 1e-4 atol "
        f"1e-6 of the twin); bitwise equal on a rerun: ok")
    ms, plain_ms = statistics.median(kern0 + kern1), statistics.median(p0 + p1)
    bound_ms, bound_by = bound(
        nbytes(data, perm_all, adv_stats, params, opt.mu, opt.nu, k.params, k.opt_state.mu,
               k.opt_state.nu, k.grad0) + 4 * pu.N_METRIC_SUMS, OPS_LOSS[d] * mb * n_passes)
    say(f"time K4 obs {d}, {e_} x {m_} passes of {mb}: {ms:.4f} ms (median of 20 launches, each "
        f"{min(kern0 + kern1):.4f} to {max(kern0 + kern1):.4f}), twin {plain_ms:.3f} ms (median of "
        f"20), bound {bound_ms:.4f} ms by {bound_by}, on {gpu}")
    return dict(max_abs_err=errs["params"][0], outside=errs["params"][1], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                at=f"{n_passes} passes of {mb} samples gathered in tiles of {tile} from {n}")


def kernel_counters() -> dict:
    """Each kernel wrapper by its id; ``K2`` counts the fused PPO rollout's
    launches of every kind (K2, K6-hover, K6-rest), ``K8/K9`` the
    closed-loop template's of every kind."""
    from reinmav_tpu_torch.ops import closed_loop_rollout as cl
    from reinmav_tpu_torch.ops import contact_rollout as cr
    from reinmav_tpu_torch.ops import hover_rollout as hr
    from reinmav_tpu_torch.ops import offpolicy as op
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.ops import ppo_update as pu
    from reinmav_tpu_torch.ops import reinmav_rollout as rr
    from reinmav_tpu_torch.ops import rollout as ro

    return {"K1": ro.quad3d_rollout_autoreset, "K2": pr.ppo_rollout,
            "K3": pl.ppo_loss_grads_gather, "K4": pu.ppo_update, "K5": hr.hover_rollout,
            "K7": op.collect_step, "K8/K9": cl.closed_loop_rollout, "K10": rr.reinmav_rollout,
            "K11": cr.contact_rollout}


def ppo_state(env, cfg, dev, seed: int = 0):
    from reinmav_tpu_torch.rl import ppo

    return ppo.init_train_state(env, cfg, seed=seed, device=dev)


def training_phase(torch, dev, gpu: str, env, cfg, label: str, **train_kw):
    """Drive 2 warm-up and 5 timed updates of ``train_step`` from seed 0,
    with every kernel count set to 0 just before; returns the launch
    counts, the walls and the summaries."""
    state = ppo_state(env, cfg, dev)
    counters = kernel_counters()
    from reinmav_tpu_torch.rl.ppo import train_step

    for fn in counters.values():
        fn.launches = 0
    walls, summaries = [], []
    for _ in range(WARMUP_UPDATES + TIMED_UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, summary = train_step(env, cfg, state, **train_kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        summaries.append({k: float(v) for k, v in summary.items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    require(all(math.isfinite(v) for s in summaries for v in s.values()), f"{label}: finite metrics")
    for i, s in enumerate(summaries):
        say(f"{label} update {i} ({'warm-up' if i < WARMUP_UPDATES else 'timed'}): wall "
            f"{walls[i]:.2f} ms, {B_PPO * T_PPO / walls[i] * 1e3:.4e} env-steps/s on {gpu}; " +
            ", ".join(f"{k} {v:.5g}" for k, v in s.items()))
    return launches, walls, summaries


def _leaves(tree):
    """Every tensor and scalar of a state tree, a generator as its state."""
    import torch

    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if isinstance(tree, tuple):
        return [leaf for field in tree for leaf in _leaves(field)]
    return [tree]


def resume_phase(torch, dev, gpu: str, env, cfg) -> None:
    """A resumed run is bitwise the uninterrupted one: 4 updates of
    ``train_step`` straight, against 2, a checkpoint, a restore into a
    state of another seed, and 2 more."""
    from reinmav_tpu_torch.rl import ppo
    from reinmav_tpu_torch.utils import checkpoint as ckpt

    path = str(Path(__file__).resolve().parent / "chiprun_out" / "smoke_resume_ckpt")
    ref = ppo.init_train_state(env, cfg, seed=4, device=dev)
    for _ in range(4):
        ref, _ = ppo.train_step(env, cfg, ref)
    state = ppo.init_train_state(env, cfg, seed=4, device=dev)
    for _ in range(2):
        state, _ = ppo.train_step(env, cfg, state)
    ckpt.save(path, state)
    del state
    restored = ckpt.restore(path, ppo.init_train_state(env, cfg, seed=5, device=dev))
    require(restored.params.device == dev and restored.opt_state.count.device == dev,
            "resume: the restored state is not on the card")
    for _ in range(2):
        restored, _ = ppo.train_step(env, cfg, restored)
    a, b = _leaves(ref), _leaves(restored)
    require(len(a) == len(b) and restored.update_step == ref.update_step == 4, "resume: structure")
    for i, (x, y) in enumerate(zip(a, b)):
        same = (x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
                if isinstance(x, torch.Tensor) else x == y)
        require(same, f"resume: leaf {i} differs from the uninterrupted run's")
    say(f"resume, B={B_PPO} T={T_PPO}: 2 updates + checkpoint + restore into a seed-5 state + 2 "
        f"updates bitwise equal to 4 uninterrupted ({len(a)} leaves: params, Adam count and "
        f"moments, env states, normalisers, generator, kl_beta) on {gpu}: ok")


def cli_phase(gpu: str, env_id: str = "quadrotor3d-v0") -> None:
    """The training CLI in subprocesses: train with evaluation and a
    checkpoint, then play."""
    root = Path(__file__).resolve().parent
    ck = root / "chiprun_out" / f"smoke_cli_ckpt_{env_id}"
    base = [sys.executable, "-m", "reinmav_tpu_torch.rl.run", f"--env={env_id}",
            f"--num_env={B_PPO}", f"--rollout_len={T_PPO}"]
    runs = {"train": [*base, f"--num_timesteps={CLI_UPDATES * B_PPO * T_PPO}", "--log_interval=5",
                      "--eval_interval=5", "--eval_envs=256", f"--eval_horizon={PLAY_STEPS}",
                      f"--save_path={ck}"],
            "play": [*base, f"--load_path={ck}", "--play", f"--play_steps={PLAY_STEPS}"]}
    for name, cmd in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
        if proc.returncode != 0:
            raise RuntimeError(f"the CLI ({name}) exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                               f"\n{proc.stderr[-3000:]}")
        rows = [json.loads(line) for line in lines]
        require(bool(rows), f"the CLI ({name}) printed no JSON line")
        if name == "train":
            train = [row for row in rows if "env_steps" in row]
            evals = [row for row in rows if "eval_survival_frac" in row]
            require(bool(train) and train[-1]["env_steps"] == CLI_UPDATES * B_PPO * T_PPO and
                    all(math.isfinite(v) for v in train[-1].values()), "the CLI's last metrics")
            require(len(evals) == CLI_UPDATES // 5 and
                    all(0.0 <= row["eval_survival_frac"] <= 1.0 and
                        math.isfinite(row["eval_running_return"]) for row in evals),
                    f"the CLI's evaluation lines {evals}")
            shown = [train[-1], evals[-1]]
        else:
            require(rows[-1]["play_steps"] == PLAY_STEPS, "the CLI's play line")
            shown = rows[-1:]
        say(f"cli {name} {env_id}: exit 0 in {time.perf_counter() - t0:.1f} s on {gpu}; last lines "
            f"{' '.join(json.dumps(row) for row in shown)}")


def off_sphere(torch, env, s_t):
    """Envs of ``(D, B)`` states farther than KNIFE from the tether sphere
    (every env of an env without a tether)."""
    k = TETHER.get(env.name)
    if k is None:
        return torch.ones(s_t.shape[1], dtype=torch.bool, device=s_t.device)
    d = s_t.shape[0]
    norm = (s_t[d - 2 * k:d - k] - s_t[0:k]).norm(dim=0)
    return (norm - env.params.tether_length).abs() > KNIFE


def k6_resynchronised(torch, env, states_t, rets, params, consts, k2_kw):
    """The fused PPO rollout against its twin one step at a time for T_PPO
    steps, both from the twin's state, on the envs off the tether sphere.
    Returns ``(envs outside TOL, env-steps skipped, the moment sums' rel
    err of the first step)``."""
    from reinmav_tpu_torch.ops import ppo_rollout as pr

    x, r, outside, knife, stats_rel = states_t, rets, 0, 0, None
    for t in range(T_PPO):
        k = pr.ppo_rollout(x, r, 21 + t, params, consts, 1, **k2_kw)
        p = pr.ppo_rollout_reference(x, r, 21 + t, params, consts, 1, **k2_kw)
        safe = off_sphere(torch, env, x)
        outside += int((_mismatched_envs(torch, k, p) & safe).sum())
        knife += int((~safe).sum())
        if stats_rel is None:
            stats_rel = float(((k.stats - p.stats).abs() / p.stats.abs().clamp_min(1.0)).max())
        x, r = p.final_states, p.returns
    return outside, knife, stats_rel


def fused_kernel_checks(torch, dev, gpu: str, env, make_states, names,
                        ret_var: float = 4.0) -> tuple[dict, dict, dict]:
    """Phases 7, 8 and 10 (quadrotor3d-v0) or 13 (the hover task): the
    fused PPO rollout kernel (K2 or K6-hover) against its twin at 32,768 x
    32 with noise and resets on, K3 against its twin on one full minibatch
    of that trajectory, K4 against its twin over one update on it.
    ``make_states(state)`` gives the rollout's ``(D, B)`` start states,
    ``names`` the labels of the three kernels, ``ret_var`` the return
    normaliser's variance (a warmed one, of the env's reward scale).
    Returns each kernel's numbers for the ``kernels`` line."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.rl import networks, ppo

    k2_name, k3_name, k4_name = names
    d = env.obs_dim
    # Warmed normalisers, a spread of running returns, log_std -0.5.
    cfg = ppo.PpoConfig(num_envs=B_PPO, rollout_len=T_PPO, fused_update="off")
    layout = networks.Layout(env.obs_dim, env.action_dim, cfg.hidden)
    state = ppo.init_train_state(env, cfg, seed=3, device=dev)
    obs_norm = ppo.ObsNorm(torch.linspace(-0.1, 0.1, d, device=dev),
                           torch.linspace(0.5, 2.0, d, device=dev),
                           torch.tensor(100.0, device=dev))
    ret_norm = ppo.RetNorm(torch.tensor(ret_var, device=dev), torch.tensor(100.0, device=dev))
    params = state.params.clone()
    params[layout.slices[("log_std",)]] = -0.5
    consts = ppo._rollout_consts(params, layout, obs_norm, ret_norm, cfg.gamma)
    states_t = make_states(state)
    rets = torch.linspace(-1.0, 1.0, B_PPO, device=dev)
    k2_args = (states_t, rets, 21, params, consts, T_PPO)
    k2_kw = dict(params_vec=pr.env_params_vec(env), env_kind=env.name)
    k2_run = lambda: pr.ppo_rollout(*k2_args, **k2_kw)  # noqa: E731
    k2_plain = lambda: pr.ppo_rollout_reference(*k2_args, **k2_kw)  # noqa: E731
    k2_run()  # warm-up
    pr.ppo_rollout_reference(states_t, rets, 21, params, consts, 2, **k2_kw)  # warm-up
    torch.cuda.synchronize()
    (plain0,), ref = cuda_ms(k2_plain, 1)
    kern0, out = cuda_ms(k2_run, 10)
    kern1, _ = cuda_ms(k2_run, 10)
    (plain1,), _ = cuda_ms(k2_plain, 1)
    bad = _mismatched_envs(torch, out, ref)
    mismatched = int(bad.sum())
    resets = int(ref.done.sum())
    require(resets > 0, f"{k2_name} check: no env reset, so the reset path was not exercised")
    ok = ~bad
    k2_err = max(float((x[..., ok] - y[..., ok]).abs().max())
                 for x, y in zip((*out[:5], out.final_states), (*ref[:5], ref.final_states)))
    errs = {name: rel_err(getattr(out, name)[..., ok], getattr(ref, name)[..., ok])
            for name in ("log_prob", "value", "reward")}
    stats_rel = float(((out.stats - ref.stats).abs() / ref.stats.abs().clamp_min(1.0)).max())
    if env.name in TETHER:
        # Free-running, the envs that meet the tether sphere part: a count
        # to report.  The gate is one step at a time from the twin's state.
        outside, knife, stats_rel = k6_resynchronised(torch, env, states_t, rets, params, consts,
                                                      k2_kw)
        require(outside == 0, f"{k2_name} vs twin, resynchronised: {outside} envs outside")
        gate = (f"free-running {mismatched} of {B_PPO} envs apart (the tether knife edge, "
                f"reported); resynchronised over {T_PPO} steps: {outside} envs outside rtol 2e-4 "
                f"atol 2e-5, {knife} env-steps within {KNIFE:g} of the sphere skipped")
    else:
        require(mismatched <= 0.001 * B_PPO, f"{k2_name} vs twin: {mismatched} envs mismatched")
        gate = f"{mismatched} of {B_PPO} envs mismatched (limit 0.1%)"
    require(stats_rel <= 1e-3, f"{k2_name} moment sums, rel err {stats_rel}")
    again = k2_run()
    require(all(torch.equal(x, y) for x, y in zip(out, again)), f"{k2_name} determinism per seed")
    say(f"{k2_name} vs twin, B={B_PPO} T={T_PPO}, noise and resets on ({resets} resets): "
        f"{gate}; on the envs that agree max |err| {k2_err:.3e}, rel err logp "
        f"{errs['log_prob']:.3e} value {errs['value']:.3e} reward {errs['reward']:.3e}; moment "
        f"sums rel err {stats_rel:.3e} (limit 1e-3); bitwise equal on a rerun: ok")
    k2_ms, k2_plain_ms = statistics.median(kern0 + kern1), (plain0 + plain1) / 2
    k2_bound, k2_by = bound(nbytes(states_t, rets, params, consts, *out),
                            OPS_ROLLOUT[d] * B_PPO * T_PPO)
    say(f"time {k2_name} B={B_PPO} T={T_PPO}: {k2_ms:.4f} ms (median of 20 launches, each "
        f"{min(kern0 + kern1):.4f} to {max(kern0 + kern1):.4f}), twin {k2_plain_ms:.2f} ms "
        f"(runs {plain0:.2f}, {plain1:.2f}), bound {k2_bound:.4f} ms by {k2_by}, on {gpu}")
    rollout = dict(max_abs_err=k2_err, mismatched=mismatched, ms=k2_ms, plain_ms=k2_plain_ms,
                   bound_ms=k2_bound, bound_by=k2_by,
                   at=f"states ({env.obs_dim}, {B_PPO}), horizon {T_PPO}")

    # K3 against its twin on one full minibatch of that trajectory, with
    # the params moved off the rollout's, so that ratios leave 1 and clip.
    n = B_PPO * T_PPO
    traj = ppo.Transition(out.obs, out.action, out.log_prob, out.value, out.reward, out.done)
    with torch.no_grad():
        last = ppo._normalize_t(out.final_states, obs_norm)
        _, _, last_value = networks.apply_t(layout.unflatten(params), last)
        adv, ret = ppo.compute_gae(cfg, traj, last_value)
    flat_d = lambda x: x.permute(1, 0, 2).reshape(x.shape[1], n)  # noqa: E731
    data = pl.stack_batch(flat_d(out.obs), flat_d(out.action), out.log_prob.reshape(n),
                          out.value.reshape(n), adv.reshape(n), ret.reshape(n))
    tile, n_tiles = ppo._tiling(cfg, n)
    perm = ppo._shuffle_indices(torch.Generator().manual_seed(5), n_tiles, dev)
    tidx = perm.reshape(cfg.num_minibatches, -1)[0].to(torch.int32).contiguous()
    adv_mb = adv.reshape(n)[pl._gather_columns(tidx, tile)]
    zero = torch.zeros((), device=dev)
    adv_stats = torch.stack([adv_mb.mean(), 1.0 / (adv_mb.std(unbiased=False) + 1e-8), zero,
                             zero]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(8)
    net = (params + 0.02 * torch.randn(params.shape, generator=gen, device=dev)).contiguous()
    kcfg = dict(d=env.obs_dim, adim=env.action_dim, clip_eps=cfg.clip_eps,
                value_clip_eps=cfg.value_clip_eps, value_coef=cfg.value_coef, tile=tile)
    mb = tidx.numel() * tile
    k3_run = lambda: pl.ppo_loss_grads_gather(data, adv_stats, tidx, net,  # noqa: E731
                                              ent_coef=0.01, **kcfg)
    k3_plain = lambda: pl._finish(pl.ppo_loss_grads_reference(  # noqa: E731
        data, adv_stats, tidx, net, **kcfg), mb, 0.01, layout)
    k3_run()
    k3_plain()  # warm-ups
    torch.cuda.synchronize()
    p0, (g_p, m_p) = cuda_ms(k3_plain, 3)
    kern, (g_k, m_k) = cuda_ms(k3_run, 20)
    p1, _ = cuda_ms(k3_plain, 3)
    g_again, m_again = k3_run()
    require(torch.allclose(g_k, g_p, **GRAD_TOL), f"{k3_name} vs twin, gradients")
    for name in pl.METRICS:
        require(torch.allclose(m_k[name], m_p[name], **METRIC_TOL), f"{k3_name} vs twin, {name}")
    require(torch.equal(g_k, g_again) and all(torch.equal(m_k[k], m_again[k]) for k in m_k),
            f"{k3_name} bitwise determinism")
    k3_err = float((g_k - g_p).abs().max())
    clip_frac = float(m_k["clip_frac"])
    require(clip_frac > 0.0,
            f"{k3_name} check: no sample clipped, so the clip branch was not exercised")
    say(f"{k3_name} vs twin, one minibatch of {mb} samples (tile {tile}, {tidx.numel()} tiles), "
        f"clip mode: grads max |err| {k3_err:.3e}, rel err {rel_err(g_k, g_p):.3e} (rtol 2e-3 atol "
        f"2e-6), metrics {', '.join(f'{k} {float(m_k[k]):.5g}' for k in pl.METRICS)} (rtol 2e-4 "
        f"atol 1e-6); bitwise equal on a rerun: ok")
    k3_ms, k3_plain_ms = statistics.median(kern), statistics.median(p0 + p1)
    k3_bound, k3_by = bound(nbytes(tidx, adv_stats, net, g_k) + mb * data.shape[0] * 4,
                            OPS_LOSS[d] * mb)
    say(f"time {k3_name} minibatch {mb}: {k3_ms:.4f} ms (median of 20 launches, each "
        f"{min(kern):.4f} to {max(kern):.4f}), twin {k3_plain_ms:.3f} ms (median of 6), bound "
        f"{k3_bound:.4f} ms by {k3_by}, on {gpu}")
    loss = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound,
                bound_by=k3_by, at=f"minibatch of {mb} samples gathered in tiles of {tile} from "
                                   f"{n}, obs {d}, action {env.action_dim}")
    # K4 on the same trajectory, from the rollout's own params.
    update = k4_phase(torch, dev, gpu, cfg, params, data, adv, tile, n_tiles, env.action_dim)
    del out, ref, again, data, traj, adv, ret
    torch.cuda.empty_cache()
    return rollout, loss, update


def ppo_phases(torch, dev, gpu: str, env) -> list[dict]:
    """Phases 7-11: K2, K3 and K4 against their twins at the training
    path's shapes, the K3-loop training path, the default (K4) training
    path and the CLI.  Returns the three kernels' entries of the
    ``kernels`` line."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.rl import ppo

    # 7, 8 and 10.  States drawn twice as wide as a reset, so that the envs
    # beyond |p| = 3 reset at once.
    cfg = ppo.PpoConfig(num_envs=B_PPO, rollout_len=T_PPO, fused_update="off")
    k2, k3, k4 = fused_kernel_checks(torch, dev, gpu, env,
                                     lambda state: (state.env_states.T * 2.0).contiguous(),
                                     ("K2", "K3", "K4"))
    # 9. The training path through the public API, with the update as a
    # loop of 16 minibatch steps through K3 (fused_update="off").
    launches, walls, summaries = training_phase(torch, dev, gpu, env, cfg, "ppo update (K3 loop)")
    k3_launches = launches["K3"]
    updates = WARMUP_UPDATES + TIMED_UPDATES
    passes = cfg.num_epochs * cfg.num_minibatches
    require(launches == {"K1": 0, "K2": updates, "K3": updates * passes, "K4": 0, "K5": 0,
                         "K7": 0, "K8/K9": 0, "K10": 0, "K11": 0}, f"launches {launches} on the K3 loop path, expected K2 {updates}, K3 "
            f"{updates * passes}")

    # The same updates from the same state through the eager rollout and
    # autograd, the JAX scan path's counterpart: the kernels' path must
    # learn at the same reward scale (other noise draws), as
    # tests/test_pallas_ppo_rollout.py holds the JAX kernel path (rtol 0.1).
    eager = ppo.init_train_state(env, cfg, seed=0, device=dev)
    eager_rewards = []
    for _ in range(updates):
        eager, summary = ppo.train_step(env, cfg, eager, fused_rollout=False, fused_loss=False)
        eager_rewards.append(float(summary["mean_reward"]))
    require(pr.ppo_rollout.launches == launches["K2"] and
            pl.ppo_loss_grads_gather.launches == k3_launches, "the eager path launched K2 or K3")
    loop_rewards = [s["mean_reward"] for s in summaries]
    for r, e in zip(loop_rewards, eager_rewards):
        require(abs(r - e) <= 0.1 * abs(e), f"mean_reward {loop_rewards} vs eager {eager_rewards}")
    say(f"mean_reward per update, kernels {[round(r, 4) for r in loop_rewards]}, eager rollout + "
        f"autograd from the same state {[round(e, 4) for e in eager_rewards]} (rtol 0.1): ok")
    timed = walls[WARMUP_UPDATES:]
    say(f"ppo training path, fused_update=\"off\", B={B_PPO} T={T_PPO}, {passes} minibatch steps "
        f"per update: K2 launches {launches['K2']}, K3 launches {k3_launches} over {updates} "
        f"updates; timed updates median {statistics.median(timed):.2f} ms "
        f"({B_PPO * T_PPO / statistics.median(timed) * 1e3:.4e} env-steps/s end to end), on {gpu}: ok")

    # 11. The default training path: every update one K2 and one K4 launch.
    main_cfg = ppo.PpoConfig(num_envs=B_PPO, rollout_len=T_PPO)
    main_launches, main_walls, main_summaries = training_phase(torch, dev, gpu, env, main_cfg,
                                                               "ppo update (K4)")
    require(main_launches == {"K1": 0, "K2": updates, "K3": 0, "K4": updates, "K5": 0,
                              "K7": 0, "K8/K9": 0, "K10": 0, "K11": 0}, f"launches {main_launches} on the default path, expected K2 and K4 {updates}, K3 0")
    rewards = [s["mean_reward"] for s in main_summaries]
    for r, e in zip(rewards, loop_rewards):
        require(abs(r - e) <= 0.1 * abs(e), f"mean_reward {rewards} vs the K3 loop {loop_rewards}")
    main_timed = main_walls[WARMUP_UPDATES:]
    say(f"mean_reward per update, K4 {[round(r, 4) for r in rewards]}, fused_update=\"off\" from "
        f"the same state {[round(e, 4) for e in loop_rewards]} (rtol 0.1): ok")
    say(f"ppo training path, default config, B={B_PPO} T={T_PPO}: K2 launches "
        f"{main_launches['K2']}, K4 launches {main_launches['K4']}, K3 launches "
        f"{main_launches['K3']} over {updates} updates; timed updates median "
        f"{statistics.median(main_timed):.2f} ms "
        f"({B_PPO * T_PPO / statistics.median(main_timed) * 1e3:.4e} env-steps/s end to end), "
        f"on {gpu}: ok")
    resume_phase(torch, dev, gpu, env, main_cfg)
    cli_phase(gpu)

    return [{
        "name": "ppo_rollout",
        "route": "cuda",
        "source": "reinmav_tpu_torch/csrc/ppo_rollout.cu",
        "replaces": "reinmav_tpu/ops/pallas_ppo_rollout.py:703",
        "launches": main_launches["K2"],
        "max_abs_err": k2["max_abs_err"],
        "mismatched_envs": k2["mismatched"],
        "tolerance": "rtol 2e-4 atol 2e-5 per env over its whole trajectory, <= 0.1% of envs "
                     "may differ; max_abs_err over the envs that agree",
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
        "at": k2["at"],
    }, {
        "name": "ppo_loss_grads_gather",
        "route": "cuda",
        "source": "reinmav_tpu_torch/csrc/ppo_loss.cu",
        "replaces": "reinmav_tpu/ops/pallas_ppo.py:424",
        "launches": k3_launches,
        "max_abs_err": k3["max_abs_err"],
        "tolerance": "grads rtol 2e-3 atol 2e-6, metrics rtol 2e-4 atol 1e-6, bitwise repeatable",
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
        "at": f"{k3['at']}; launches on the fused_update=\"off\" path",
    }, {
        "name": "ppo_update",
        "route": "cuda",
        "source": "reinmav_tpu_torch/csrc/ppo_update.cu",
        "replaces": "reinmav_tpu/ops/pallas_ppo_update.py:304",
        "launches": main_launches["K4"],
        "max_abs_err": k4["max_abs_err"],
        "entries_outside_rtol_2e-4_atol_1e-6": k4["outside"],
        "tolerance": "params rtol 2e-4 atol 1e-6, moments rtol 2e-4 atol 5e-8 of the twin and "
                     "of the K3 loop; pass-0 gradient bitwise K3's; bitwise repeatable",
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        "at": k4["at"],
    }]


def hover_states(torch, gen, dev, batch: int, z_lo: float, z_hi: float):
    """Perturbed hover states, ``(13, B)``: x, y in +-0.3, z in [z_lo,
    z_hi], identity attitude, velocities and rates in +-0.5."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    s = torch.zeros((13, batch), device=dev)
    s[0:2] = (u(2, batch) * 2.0 - 1.0) * 0.3
    s[2] = z_lo + (z_hi - z_lo) * u(batch)
    s[3] = 1.0
    s[7:13] = (u(6, batch) * 2.0 - 1.0) * 0.5
    return s


def hover_phases(torch, dev, gpu: str) -> list[dict]:
    """Phases 12-14: K5 against its twin and the hover throughput path; K6-
    hover, K3 and K4 at obs 13 against their twins; hover training and its
    CLI.  Returns the four kernels' entries of the ``kernels`` line."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import hover_rollout as hr
    from reinmav_tpu_torch.rl import ppo

    env = reinmav_tpu_torch.make(HOVER)
    gen = torch.Generator(device=dev).manual_seed(12)

    # 12. K5 against its twin, free-running through the resets.
    check = hover_states(torch, gen, dev, B_HOVER_CHECK, 0.7, 1.3)
    for action in HOVER_ACTIONS:
        f_k, r_k = hr.hover_rollout(check, T_RESET, action=action)
        f_p, r_p = hr.hover_rollout_reference(check, T_RESET, action=action)
        torch.cuda.synchronize()
        mismatched = int((~torch.isclose(f_k, f_p, **TOL).all(dim=0)).sum())
        rel = abs(float(r_k.double().sum() - r_p.double().sum())) / abs(float(r_p.double().sum()))
        require(mismatched <= 0.001 * B_HOVER_CHECK, f"K5 {action}: {mismatched} envs mismatched")
        require(rel <= 1e-3, f"K5 {action}: reward total rel err {rel}")
        f_k2, r_k2 = hr.hover_rollout(check, T_RESET, action=action)
        require(torch.equal(f_k, f_k2) and torch.equal(r_k, r_k2), "K5 bitwise determinism")
        require(bool(torch.isfinite(f_k).all()) and float(f_k[2].min()) > 0.3, "K5 envelope")
        say(f"K5 vs twin, action {action}, B={B_HOVER_CHECK} T={T_RESET}: {mismatched} of "
            f"{B_HOVER_CHECK} envs mismatched (limit 0.1%), reward total rel err {rel:.3e} (rtol "
            f"1e-3), mean reward sum {float(r_k.mean()):.3f}; bitwise equal on a rerun: ok")

    # The hover main path, through the public entry points.
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    big = env.vreset(gen, B_MAIN)
    big_final, reward_sum = reinmav_tpu_torch.throughput_rollout(env, big, gen, horizon=T_MAIN)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    require(launches == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 1, "K7": 0, "K8/K9": 0,
                         "K10": 0, "K11": 0},
            f"hover throughput_rollout launches {launches}, expected K5 1")
    require(big_final.shape == (B_MAIN, 13) and reward_sum.shape == (B_MAIN,), "output shapes")
    require(bool(torch.isfinite(big_final).all()) and bool(torch.isfinite(reward_sum).all()),
            "finite states and reward sums")
    # Every env starts at the reset pose under the zero action: one trajectory.
    require(bool((big_final == big_final[0]).all()) and bool((reward_sum == reward_sum[0]).all()),
            "the deterministic hover rollout differs between envs")
    say(f"throughput_rollout({HOVER}) B={B_MAIN} T={T_MAIN} backend=auto: K5 launches "
        f"{launches['K5']}, final z {float(big_final[0, 2]):.4f}, reward sum "
        f"{float(reward_sum[0]):.3f} in every env: ok")

    # K5 and its twin at the main path's shape, in turns, from perturbed states.
    big_t = hover_states(torch, gen, dev, B_MAIN, 0.7, 1.3)
    del big, big_final, reward_sum
    kernel_run = lambda: hr.hover_rollout(big_t, T_MAIN)  # noqa: E731
    plain_run = lambda: hr.hover_rollout_reference(big_t, T_MAIN)  # noqa: E731
    kernel_run()
    hr.hover_rollout_reference(big_t, 5)  # warm-ups
    torch.cuda.synchronize()
    (plain0,), (f_p, r_p) = cuda_ms(plain_run, 1)
    kern0, (f_k, r_k) = cuda_ms(kernel_run, 5)
    kern1, _ = cuda_ms(kernel_run, 5)
    (plain1,), _ = cuda_ms(plain_run, 1)
    ok = torch.isclose(f_k, f_p, **TOL).all(dim=0)
    k5_mismatched = int((~ok).sum())
    k5_err = float((f_k[:, ok] - f_p[:, ok]).abs().max())
    require(k5_mismatched <= 0.001 * B_MAIN, f"K5 main shape: {k5_mismatched} envs mismatched")
    k5_ms, k5_plain_ms = statistics.median(kern0 + kern1), (plain0 + plain1) / 2
    k5_bound, k5_by = bound(nbytes(big_t, f_k, r_k), OPS_K5 * B_MAIN * T_MAIN)
    say(f"K5 vs twin, B={B_MAIN} T={T_MAIN}: {k5_mismatched} envs mismatched (limit 0.1%), on the "
        f"others max |err| {k5_err:.3e}: ok")
    say(f"time K5 B={B_MAIN} T={T_MAIN}: {k5_ms:.3f} ms per rollout (median of 10 launches, each "
        f"{min(kern0 + kern1):.3f} to {max(kern0 + kern1):.3f}), "
        f"{B_MAIN * T_MAIN / k5_ms * 1e3:.4e} env-steps/s; twin {k5_plain_ms:.1f} ms (runs "
        f"{plain0:.1f}, {plain1:.1f}); bound {k5_bound:.3f} ms by {k5_by}, on {gpu}")
    at_k5 = f"states {tuple(f_k.shape)}, horizon {T_MAIN}, zero action"
    del big_t, f_k, f_p, r_k, r_p
    torch.cuda.empty_cache()

    # 13. K6-hover, K3 and K4 at obs 13, from states between z = 0.35 and 1.
    # The hover reward is about 98 a step against quadrotor3d's -1.4, so
    # the return normaliser's variance is scaled by (98 / 1.4)^2 from
    # phase 7's 4.0: normalised rewards of quadrotor3d's size, not all
    # clipped at 10 as an unwarmed normaliser would leave them.
    k6, k3, k4 = fused_kernel_checks(
        torch, dev, gpu, env, lambda state: hover_states(torch, gen, dev, B_PPO, 0.35, 1.0),
        ("K6-hover", "K3 (obs 13)", "K4 (obs 13)"), ret_var=HOVER_RET_VAR)

    # 14. Hover training: the default path (K6-hover + K4), the K3 loop, and
    # the eager rollout + autograd from the same state.
    updates = WARMUP_UPDATES + TIMED_UPDATES
    main_cfg = ppo.PpoConfig(num_envs=B_PPO, rollout_len=T_PPO)
    passes = main_cfg.num_epochs * main_cfg.num_minibatches
    main_launches, main_walls, main_summaries = training_phase(
        torch, dev, gpu, env, main_cfg, "hover ppo update (K6-hover + K4)")
    require(main_launches == {"K1": 0, "K2": updates, "K3": 0, "K4": updates, "K5": 0,
                              "K7": 0, "K8/K9": 0, "K10": 0, "K11": 0}, f"launches {main_launches} on the hover default path, expected K6-hover and K4 "
            f"{updates}, K3 0")
    loop_cfg = main_cfg._replace(fused_update="off")
    loop_launches, loop_walls, loop_summaries = training_phase(
        torch, dev, gpu, env, loop_cfg, "hover ppo update (K3 loop)")
    require(loop_launches == {"K1": 0, "K2": updates, "K3": updates * passes, "K4": 0, "K5": 0,
                              "K7": 0, "K8/K9": 0, "K10": 0, "K11": 0}, f"launches {loop_launches} on the hover K3 loop, expected K6-hover {updates}, K3 "
            f"{updates * passes}")
    eager = ppo_state(env, loop_cfg, dev)
    eager_rewards = []
    for _ in range(updates):
        eager, summary = ppo.train_step(env, loop_cfg, eager, fused_rollout=False,
                                        fused_loss=False)
        eager_rewards.append(float(summary["mean_reward"]))
    for label, summaries in (("K6-hover + K4", main_summaries), ("K3 loop", loop_summaries)):
        rewards = [s["mean_reward"] for s in summaries]
        for r, e in zip(rewards, eager_rewards):
            require(abs(r - e) <= 0.1 * abs(e), f"hover mean_reward {rewards} vs eager "
                                                   f"{eager_rewards}")
        say(f"hover mean_reward per update, {label} {[round(r, 4) for r in rewards]}, eager "
            f"rollout + autograd from the same state {[round(e, 4) for e in eager_rewards]} "
            f"(rtol 0.1): ok")
    for label, walls in (("default (K6-hover + K4)", main_walls), ("K3 loop", loop_walls)):
        timed = walls[WARMUP_UPDATES:]
        say(f"hover ppo training path, {label}, B={B_PPO} T={T_PPO}: timed updates median "
            f"{statistics.median(timed):.2f} ms "
            f"({B_PPO * T_PPO / statistics.median(timed) * 1e3:.4e} env-steps/s end to end), "
            f"on {gpu}")
    cli_phase(gpu, HOVER)

    def entry(name, source, replaces, launches, numbers, tolerance, extra=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": numbers["max_abs_err"], **(extra or {}),
                "tolerance": tolerance, "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
                "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
                "library_ms": None, "at": numbers["at"]}

    return [
        entry("hover_rollout", "reinmav_tpu_torch/csrc/hover_rollout.cu",
              "reinmav_tpu/ops/pallas_tpuquad.py:622", launches["K5"],
              dict(max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain_ms, bound_ms=k5_bound,
                   bound_by=k5_by, at=at_k5),
              "rtol 2e-4 atol 2e-5 per env, <= 0.1% of envs may differ; max_abs_err over the "
              "envs that agree", {"mismatched_envs": k5_mismatched}),
        entry("ppo_rollout (MujocoQuadForce-v1, K6-hover)", "reinmav_tpu_torch/csrc/ppo_rollout.cu",
              "reinmav_tpu/ops/pallas_ppo_rollout.py:703", main_launches["K2"], k6,
              "rtol 2e-4 atol 2e-5 per env over its whole trajectory, <= 0.1% of envs may "
              "differ; max_abs_err over the envs that agree", {"mismatched_envs": k6["mismatched"]}),
        entry("ppo_loss_grads_gather (obs 13)", "reinmav_tpu_torch/csrc/ppo_loss.cu",
              "reinmav_tpu/ops/pallas_ppo.py:424", loop_launches["K3"],
              {**k3, "at": f"{k3['at']}; launches on the hover fused_update=\"off\" path"},
              "grads rtol 2e-3 atol 2e-6, metrics rtol 2e-4 atol 1e-6, bitwise repeatable"),
        entry("ppo_update (obs 13)", "reinmav_tpu_torch/csrc/ppo_update.cu",
              "reinmav_tpu/ops/pallas_ppo_update.py:304", main_launches["K4"], k4,
              "params rtol 2e-4 atol 1e-6, moments rtol 2e-4 atol 5e-8 of the twin and of the K3 "
              "loop; pass-0 gradient bitwise K3's; bitwise repeatable",
              {"entries_outside_rtol_2e-4_atol_1e-6": k4["outside"]}),
    ]


def _fork(torch, state):
    """An independent copy of an off-policy state: the ring is updated in
    place and the generator advances, so two runs from one state need two."""
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    return state._replace(buffer=state.buffer.clone(), generator=gen)


def k7_phase(torch, dev, gpu: str, env, states_t, timed_mode: str) -> dict:
    """Phase 15 for one kind: K7 against its twin at B_OFF envs and H_SAC
    wide, in every mode leg of K7_MODES, counting the envs whose block or
    new state leaves TOL; a rerun bitwise equal; then K7 and its twin
    timed in ``timed_mode`` (the mode the kind's training path runs), in
    turns.  Returns K7's numbers for the ``kernels`` line."""
    from reinmav_tpu_torch.ops import offpolicy as op
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.rl import sac

    d, a = env.obs_dim, env.action_dim
    batch = states_t.shape[1]
    pvec = pr.env_params_vec(env)
    errs, mismatches, timed = [], [], None
    for mode, warm, noise in K7_MODES:
        out = 2 * a if mode.startswith("sac") else a
        layout = sac.MlpLayout((d, H_SAC, H_SAC, out))
        flat = sac.init_mlp(layout, torch.Generator().manual_seed(31)).to(dev)
        # Off the 0.01 head init, so that the actions spread over [-1, 1].
        flat = flat + 0.05 * torch.randn(flat.shape, device=dev,
                                         generator=torch.Generator(device=dev).manual_seed(32))
        weights = op.actor_kernel_args(layout.layers(flat))
        consts = sac.collect_consts(env, torch.tensor(warm > 0.5, device=dev), noise)
        args = (env.name, mode, states_t, 15, consts, pvec, *weights)
        new_k, blk_k = op.collect_step(*args)
        new_p, blk_p = op.collect_step_reference(*args)
        torch.cuda.synchronize()
        bad = ~(torch.isclose(new_k, new_p, **TOL).all(dim=0)
                & torch.isclose(blk_k, blk_p, **TOL).all(dim=0))
        mismatched, ok = int(bad.sum()), ~bad
        err = max(float((new_k[:, ok] - new_p[:, ok]).abs().max()),
                  float((blk_k[:, ok] - blk_p[:, ok]).abs().max()))
        ended = int(blk_p[2 * d + a + 1].sum())
        new_again, blk_again = op.collect_step(*args)
        require(torch.equal(new_k, new_again) and torch.equal(blk_k, blk_again),
                f"K7 {env.name} {mode}: bitwise equal on a rerun")
        require(mismatched <= 0.001 * batch, f"K7 {env.name} {mode} warm {warm}: {mismatched} envs "
                                             f"mismatched")
        require(bool(torch.isfinite(blk_k).all()) and float(blk_k[d:d + a].abs().max()) <= 1.0,
                f"K7 {env.name} {mode}: a finite block, actions in [-1, 1]")
        require(ended > 0, f"K7 {env.name} {mode}: no env ended, so the reset was not exercised")
        say(f"K7 vs twin, {env.name}, mode {mode}, warm {warm:g}, noise {noise:g}, B={batch} "
            f"H={H_SAC}: {mismatched} of {batch} envs mismatched (limit 0.1%), on the others max "
            f"|err| {err:.3e}; {ended} envs ended and reset; bitwise equal on a rerun: ok")
        errs.append(err)
        mismatches.append(mismatched)
        if (mode, warm) == (timed_mode, 0.0):
            timed = args, (new_k, blk_k, *weights, consts), out

    args, tensors, out = timed
    kernel_run = lambda: op.collect_step(*args)  # noqa: E731
    plain_run = lambda: op.collect_step_reference(*args)  # noqa: E731
    kernel_run()
    plain_run()  # warm-ups
    torch.cuda.synchronize()
    p0, _ = cuda_ms(plain_run, 3)
    kern0, _ = cuda_ms(kernel_run, 10)
    kern1, _ = cuda_ms(kernel_run, 10)
    p1, _ = cuda_ms(plain_run, 3)
    ms, plain_ms = statistics.median(kern0 + kern1), statistics.median(p0 + p1)
    ops_per_env = 2 * (d * H_SAC + H_SAC * H_SAC + H_SAC * out) + OPS_ENV_STEP[d]
    bound_ms, bound_by = bound(nbytes(states_t, *tensors), ops_per_env * batch)
    say(f"time K7 {env.name} {timed_mode}, B={batch} H={H_SAC}: {ms:.4f} ms (median of 20 "
        f"launches, each {min(kern0 + kern1):.4f} to {max(kern0 + kern1):.4f}), twin "
        f"{plain_ms:.3f} ms (median of 6), bound {bound_ms:.4f} ms by {bound_by} "
        f"({ops_per_env} operations per env), on {gpu}")
    return dict(max_abs_err=max(errs), mismatched=max(mismatches), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                at=f"states ({d}, {batch}), actor {d}-{H_SAC}-{H_SAC}-{out}, mode {timed_mode}")


def offpolicy_iterations(torch, env, cfg, module, state, iters: int):
    """``iters`` iterations of ``module.train_iters`` with every kernel count
    set to 0 just before; returns the state, the metrics, the wall in ms
    (synchronise to synchronise) and the launch counts."""
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = module.train_iters(env, cfg, state, iters)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return state, metrics, wall, {name: fn.launches for name, fn in counters.items()}


def offpolicy_cli_phase(gpu: str) -> None:
    """Phase 18: the training CLI for the off-policy learners, in
    subprocesses: SAC on the hover task trains with evaluation and a
    checkpoint, resumes from it, and plays; TD3 on quadrotor3d-v0 trains
    and plays."""
    import tempfile

    root = Path(__file__).resolve().parent
    base = [sys.executable, "-m", "reinmav_tpu_torch.rl.run", f"--num_env={CLI_OFF_ENVS}",
            f"--batch_size={CLI_OFF_BATCH}", f"--buffer_capacity={CLI_OFF_RING}",
            "--warmup_steps=0", f"--updates_per_jit={CLI_OFF_ITERS}", "--log_interval=2"]
    per_call = CLI_OFF_ENVS * CLI_OFF_ITERS
    sac_cli = [*base, "--alg=sac", f"--env={HOVER}"]
    td3_cli = [*base, "--alg=td3", "--env=quadrotor3d-v0"]
    # The checkpoints carry the ring (tens of MB): a temporary directory in
    # the checkout, removed at the end.
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        sac_ck, resumed, td3_ck = (Path(tmp) / name for name in ("sac", "sac_resumed", "td3"))
        runs = [
            ("sac train", [*sac_cli, f"--num_timesteps={4 * per_call}", "--eval_interval=2",
                           "--eval_envs=256", f"--eval_horizon={PLAY_STEPS}",
                           f"--save_path={sac_ck}"], 4 * per_call, 2),
            ("sac resume", [*sac_cli, f"--num_timesteps={2 * per_call}", f"--load_path={sac_ck}",
                            f"--save_path={resumed}"], 2 * per_call, 0),
            ("sac play", [*sac_cli, f"--load_path={resumed}", "--play",
                          f"--play_steps={PLAY_STEPS}"], None, 0),
            ("td3 train", [*td3_cli, f"--num_timesteps={2 * per_call}", f"--save_path={td3_ck}"],
             2 * per_call, 0),
            ("td3 play", [*td3_cli, f"--load_path={td3_ck}", "--play",
                          f"--play_steps={PLAY_STEPS}"], None, 0),
        ]
        for name, cmd, steps, n_evals in runs:
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
            if proc.returncode != 0:
                raise RuntimeError(f"the CLI ({name}) exited {proc.returncode}:\n"
                                   f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
            require(bool(rows), f"the CLI ({name}) printed no JSON line")
            if steps is None:
                require(rows[-1]["play_steps"] == PLAY_STEPS and
                        math.isfinite(rows[-1]["total_reward"]), f"the CLI's play line ({name})")
                shown = rows[-1:]
            else:
                train = [row for row in rows if "env_steps" in row]
                evals = [row for row in rows if "eval_survival_frac" in row]
                require(bool(train) and train[-1]["env_steps"] == steps and
                        all(math.isfinite(v) for v in train[-1].values()),
                        f"the CLI's metrics ({name})")
                require(len(evals) == n_evals and
                        all(0.0 <= row["eval_survival_frac"] <= 1.0 for row in evals),
                        f"the CLI's evaluations {evals}")
                shown = [train[-1], *evals[-1:]]
            say(f"cli {name}: exit 0 in {time.perf_counter() - t0:.1f} s on {gpu}; last lines "
                f"{' '.join(json.dumps(row) for row in shown)}")


def learning_phase(torch, dev, gpu: str, env) -> None:
    """Phase 19: SAC on the hover task at the config of the reference's
    20M-step learning artifact, LEARN_CALLS calls of LEARN_WINDOW
    iterations, each call's metrics logged as the artifact logs them (the
    metrics of the call that ends at the logged step).  mean_reward must
    rise and done_frac fall from the first window the artifact logs
    (LEARN_FIRST_LOG calls, 2,097,152 env steps) to the last.  The
    artifact's values at the same env-step count are printed beside them,
    as a reference and not as a gate."""
    from reinmav_tpu_torch.rl import sac

    cfg = sac.SacConfig(num_envs=LEARN_ENVS, batch_size=LEARN_BATCH, buffer_capacity=LEARN_RING,
                        hidden=(LEARN_HIDDEN, LEARN_HIDDEN), grad_steps=LEARN_GRAD_STEPS,
                        warmup_steps=LEARN_WARMUP)
    artifact = Path(__file__).resolve().parent / "benchmarks/artifacts/sac_hover_20M_r5/metrics.jsonl"
    rows = [json.loads(line) for line in artifact.read_text().splitlines()[1:]]
    reference = {int(row["env_steps"]): row for row in rows if "mean_reward" in row}
    state = sac.init_state(env, cfg, seed=0, device=dev)
    windows, t0 = [], time.perf_counter()
    for call in range(1, LEARN_CALLS + 1):
        state, met, wall, launches = offpolicy_iterations(torch, env, cfg, sac, state, LEARN_WINDOW)
        require(launches["K7"] == LEARN_WINDOW, f"learning: K7 launches {launches}")
        require(all(math.isfinite(v) for v in met.values()), f"learning: finite metrics {met}")
        steps = call * LEARN_WINDOW * LEARN_ENVS
        ref = reference.get(steps)
        windows.append(met)
        say(f"learning call {call}: env steps {steps}, mean_reward {met['mean_reward']:.4f}, "
            f"done_frac {met['done_frac']:.5f}, q_loss {met['q_loss']:.4g}, alpha "
            f"{met['alpha']:.4g}, entropy {met['entropy']:.4g}; {wall / LEARN_WINDOW:.2f} ms per "
            f"iteration of {LEARN_GRAD_STEPS} updates on {gpu}"
            + ("" if ref is None else
               f"; the artifact (a TPU run, a reference only) at these steps: mean_reward "
               f"{ref['mean_reward']:.4f}, done_frac {ref['done_frac']:.5f}"))
    first, last = windows[LEARN_FIRST_LOG - 1], windows[-1]
    require(last["mean_reward"] > first["mean_reward"] and last["done_frac"] < first["done_frac"],
            f"learning: mean_reward {first['mean_reward']} -> {last['mean_reward']}, done_frac "
            f"{first['done_frac']} -> {last['done_frac']}")
    say(f"learning, SAC on {HOVER} at the artifact's config ({LEARN_ENVS} envs, batch "
        f"{LEARN_BATCH}, {LEARN_GRAD_STEPS} updates per iteration, 2 x {LEARN_HIDDEN}, warmup "
        f"{LEARN_WARMUP}), {LEARN_CALLS * LEARN_WINDOW * LEARN_ENVS} env steps in "
        f"{time.perf_counter() - t0:.1f} s: from the window logged at "
        f"{LEARN_FIRST_LOG * LEARN_WINDOW * LEARN_ENVS} steps to the last, mean_reward "
        f"{first['mean_reward']:.4f} -> {last['mean_reward']:.4f}, done_frac "
        f"{first['done_frac']:.5f} -> {last['done_frac']:.5f}: ok")


def offpolicy_phases(torch, dev, gpu: str) -> list[dict]:
    """Phases 15-19: K7 against its twin on both kinds; SAC at the bench
    config (the main path), against the eager collection from the same
    state; TD3 and DDPG; the CLI; learning.  Returns K7's entries of the
    ``kernels`` line."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.rl import sac, td3

    hover = reinmav_tpu_torch.make(HOVER)
    quad = reinmav_tpu_torch.make("quadrotor3d-v0")
    gen = torch.Generator(device=dev).manual_seed(15)

    # 15. K7 against its twin; perturbed hover states, the first 1% of them
    # falling just above the z = 0.3 floor (they end at once), and
    # quadrotor3d states twice a reset's spread (the envs past |p| = 3 end
    # at once).
    hover_t = hover_states(torch, gen, dev, B_OFF, 0.35, 1.0)
    hover_t[2, :B_OFF // 100], hover_t[9, :B_OFF // 100] = 0.302, -1.0
    k7_hover = k7_phase(torch, dev, gpu, hover, hover_t, "sac")
    k7_quad = k7_phase(torch, dev, gpu, quad,
                       (quad.vreset(gen, B_OFF).T * 2.0).contiguous(), "td3")

    # 16. SAC at the bench config, the main path: train_iters on the card
    # with fused_collect="auto" must launch K7 once per iteration.
    cfg = sac.SacConfig(num_envs=B_OFF, batch_size=BATCH_SAC, buffer_capacity=RING_SAC,
                        hidden=(H_SAC, H_SAC), grad_steps=1, warmup_steps=0)
    state = sac.init_state(hover, cfg, seed=0, device=dev)
    state, _, warm_wall, _ = offpolicy_iterations(torch, hover, cfg, sac, state, SAC_WARMUP_ITERS)
    state, met, wall, launches = offpolicy_iterations(torch, hover, cfg, sac, state, SAC_ITERS)
    sac_launches = launches["K7"]
    require(launches == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K7": SAC_ITERS,
                         "K8/K9": 0, "K10": 0, "K11": 0},
            f"launches {launches} on the SAC path, expected K7 {SAC_ITERS}")
    require(all(math.isfinite(v) for v in met.values()), f"SAC metrics {met}")
    cap, total = sac._capacity(cfg, hover), (SAC_WARMUP_ITERS + SAC_ITERS) * B_OFF
    require(int(state.total_steps) == total and int(state.filled) == min(total, cap) and
            int(state.ptr) == total % cap, f"the ring: ptr {int(state.ptr)}, filled "
                                          f"{int(state.filled)} after {total} env steps")
    say(f"sac training path, {HOVER}, B={B_OFF} batch {BATCH_SAC} ring {RING_SAC} 2 x {H_SAC}, 1 "
        f"update per iteration, no warmup: K7 launches {sac_launches} in {SAC_ITERS} iterations; "
        f"{wall:.1f} ms, {wall / SAC_ITERS:.3f} ms per iteration, "
        f"{SAC_ITERS * B_OFF / wall * 1e3:.4e} env-steps/s end to end (warm-up call of "
        f"{SAC_WARMUP_ITERS}: {warm_wall:.1f} ms), on {gpu}; ring ptr {int(state.ptr)} filled "
        f"{int(state.filled)}; metrics "
        + ", ".join(f"{k} {v:.5g}" for k, v in met.items()) + ": ok")
    fused, eager = _fork(torch, state), _fork(torch, state)
    off = cfg._replace(fused_collect="off")
    rewards = []
    for _ in range(SAC_COMPARE_ITERS):
        fused, m_k = sac.train_iters(hover, cfg, fused, 1)
        eager, m_e = sac.train_iters(hover, off, eager, 1)
        rewards.append((m_k["mean_reward"], m_e["mean_reward"]))
    for r, e in rewards:
        require(abs(r - e) <= 0.1 * abs(e), f"SAC mean_reward K7 vs eager {rewards}")
    say(f"sac mean_reward per iteration, K7 {[round(r, 4) for r, _ in rewards]}, the eager "
        f"collection from the same state {[round(e, 4) for _, e in rewards]} (rtol 0.1): ok")
    del state, fused, eager
    torch.cuda.empty_cache()

    # 17. TD3 on quadrotor3d-v0 and DDPG on the hover task, K7 in td3 mode.
    td3_launches = None
    for name, env, cfg in (
            ("td3", quad, td3.Td3Config(num_envs=B_OFF, batch_size=BATCH_SAC,
                                        buffer_capacity=RING_SAC, hidden=(H_SAC, H_SAC),
                                        warmup_steps=0)),
            ("ddpg", hover, td3.Td3Config(num_envs=B_OFF, batch_size=BATCH_SAC,
                                          buffer_capacity=RING_SAC, hidden=(H_SAC, H_SAC),
                                          warmup_steps=0, single_critic=True, policy_noise=0.0,
                                          noise_clip=0.0, policy_delay=1))):
        state = td3.init_state(env, cfg, seed=0, device=dev)
        actor0 = state.actor.clone()
        state, _, _, _ = offpolicy_iterations(torch, env, cfg, td3, state, 2)
        state, met, wall, launches = offpolicy_iterations(torch, env, cfg, td3, state, TD3_ITERS)
        require(launches["K7"] == TD3_ITERS and sum(launches.values()) == TD3_ITERS,
                f"{name}: launches {launches}, expected K7 {TD3_ITERS}")
        require(all(math.isfinite(v) for v in met.values()), f"{name} metrics {met}")
        require(not torch.equal(state.actor, actor0) and int(state.updates) == 2 + TD3_ITERS,
                f"{name}: the actor did not move")
        if name == "td3":
            td3_launches = launches["K7"]
        say(f"{name} training path, {env.name}, B={B_OFF} batch {BATCH_SAC} 2 x {H_SAC}: K7 "
            f"launches {launches['K7']} in {TD3_ITERS} iterations, {wall / TD3_ITERS:.3f} ms per "
            f"iteration, {TD3_ITERS * B_OFF / wall * 1e3:.4e} env-steps/s, on {gpu}; metrics "
            + ", ".join(f"{k} {v:.5g}" for k, v in met.items()) + ": ok")
        del state
        torch.cuda.empty_cache()

    # 18. The CLI.  19. Learning.
    offpolicy_cli_phase(gpu)
    learning_phase(torch, dev, gpu, hover)

    def entry(kind, numbers, launches, path):
        return {"name": f"offpolicy_collect ({kind})", "route": "cuda",
                "source": "reinmav_tpu_torch/csrc/offpolicy_collect.cu",
                "replaces": "reinmav_tpu/ops/pallas_offpolicy.py:155", "launches": launches,
                "max_abs_err": numbers["max_abs_err"], "mismatched_envs": numbers["mismatched"],
                "tolerance": "rtol 2e-4 atol 2e-5 per env over its block and new state, <= 0.1% "
                             "of envs may differ, in five mode legs (sac, td3, sac_det, td3_det, "
                             "sac with the warmup gate); max_abs_err over the envs that agree; "
                             "bitwise repeatable",
                "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
                "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
                "library_ms": None, "at": f"{numbers['at']}; launches on {path}"}

    return [entry(HOVER, k7_hover, sac_launches, "the SAC bench path (phase 16)"),
            entry("quadrotor3d-v0", k7_quad, td3_launches, "the TD3 path (phase 17)")]


def native_states(torch, env, gen, batch: int, scale: float = 1.0):
    """``(D, B)`` states of quadrotor2d-v0 or a slung-load env: U(-1, 1)
    times ``scale``, the loads at random offsets of about 1.1 L from the
    quad (both tether branches), and the first 1% far out with the load
    beside the quad (these end at once)."""
    d = env.state_dim
    s = (torch.rand((d, batch), generator=gen, device=gen.device) * 2.0 - 1.0) * scale
    k = TETHER.get(env.name)
    far = batch // 100
    s[0:2, :far] *= 6.0
    if k is not None:
        lo, hi = d - 2 * k, d - k
        s[lo:hi] = s[0:k] + torch.randn((k, batch), generator=gen, device=gen.device) * (
            1.1 * env.params.tether_length / k ** 0.5)
        s[lo:hi, :far] = s[0:k, :far]
    return s.contiguous()


def closed_loop_phase(torch, dev, gpu: str, name: str) -> dict:
    """Phase 20 for one env: throughput_rollout through the public entry
    points at B_MAIN x T_MAIN (the main path: one K8/K9 launch); the kernel
    against its twin at that shape with resets on, free-running (the envs
    apart: a gate of 0.1% for quadrotor2d-v0, a count for the slung-load
    envs, whose envs part on the tether sphere), both timed in turns; then
    T_RESYNC steps one at a time from the twin's state at full width, 0 envs
    outside TOL off the knife edges (the tether sphere, and for
    quadrotor2d-v0 the envs whose done flag differs), which are counted,
    from states of which 1% end at once; a bitwise rerun.  Returns the kernel's entry of the ``kernels`` line."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import closed_loop_rollout as cl

    env = reinmav_tpu_torch.make(name)
    d = env.state_dim
    gen = torch.Generator(device=dev).manual_seed(20)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    big = env.vreset(gen, B_MAIN)
    final, reward_sum = reinmav_tpu_torch.throughput_rollout(env, big, gen, horizon=T_MAIN)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    require(launches == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K7": 0, "K8/K9": 1, "K10": 0, "K11": 0},
            f"throughput_rollout({name}) launches {launches}, expected K8/K9 1")
    require(final.shape == (B_MAIN, d) and bool(torch.isfinite(final).all()) and
            bool(torch.isfinite(reward_sum).all()), f"{name}: finite states and reward sums")
    say(f"throughput_rollout({name}) B={B_MAIN} T={T_MAIN} backend=auto: K8/K9 launches "
        f"{launches['K8/K9']}, mean reward sum {float(reward_sum.mean()):.3f}: ok")

    big_t = big.T.contiguous()
    del big, final, reward_sum
    kernel_run = lambda: cl.closed_loop_rollout(name, big_t, 7, T_MAIN)  # noqa: E731
    plain_run = lambda: cl.closed_loop_rollout_reference(name, big_t, 7, T_MAIN)  # noqa: E731
    kernel_run()
    cl.closed_loop_rollout_reference(name, big_t, 7, 5)  # warm-ups
    torch.cuda.synchronize()
    (plain0,), (f_p, r_p) = cuda_ms(plain_run, 1)
    kern0, (f_k, r_k) = cuda_ms(kernel_run, 5)
    kern1, _ = cuda_ms(kernel_run, 5)
    (plain1,), _ = cuda_ms(plain_run, 1)
    apart = ~torch.isclose(f_k, f_p, **TOL).all(dim=0)
    free_apart = int(apart.sum())
    if name not in TETHER:
        require(free_apart <= 0.001 * B_MAIN, f"{name}: {free_apart} envs mismatched")
    again = kernel_run()
    require(torch.equal(f_k, again[0]) and torch.equal(r_k, again[1]), f"{name}: bitwise rerun")
    require(bool(torch.isfinite(f_k).all()), f"{name}: finite states")
    free_err = float((f_k[:, ~apart] - f_p[:, ~apart]).abs().max()) if free_apart < B_MAIN \
        else float("nan")
    reward_rel = abs(float(r_k.double().sum() - r_p.double().sum())) / abs(float(r_p.double().sum()))
    del again, f_p, r_p

    # One step at a time from the twin's state, at full width, from states
    # of which 1% end at once.
    x, outside, knife, err, done = native_states(torch, env, gen, B_MAIN), 0, 0, 0.0, 0
    for t in range(T_RESYNC):
        f1, r1 = cl.closed_loop_rollout(name, x, 100 + t, 1)
        g1, q1 = cl.closed_loop_rollout_reference(name, x, 100 + t, 1)
        safe = off_sphere(torch, env, x) & ((r1 == 1.0) == (q1 == 1.0))
        bad = ~(torch.isclose(f1, g1, **TOL).all(dim=0) & torch.isclose(r1, q1, **TOL)) & safe
        outside += int(bad.sum())
        knife += int((~safe).sum())
        done += int((q1 == 1.0).sum())
        err = max(err, float((f1[:, safe] - g1[:, safe]).abs().max()))
        x = g1
    require(outside == 0, f"{name} resynchronised: {outside} envs outside")
    require(done > 0, f"{name} resynchronised: no env ended, so the reset was not exercised")
    gate = (f"{T_RESYNC} steps resynchronised at B={B_MAIN}: {outside} envs outside rtol 2e-4 "
            f"atol 2e-5, {knife} env-steps on a knife edge skipped "
            f"({'within 1e-4 of the tether sphere' if name in TETHER else 'the done flag differs'}"
            f"), {done} env-steps ended and reset, max |err| {err:.3e}")
    say(f"K8/K9 {name} vs twin: {gate}; free-running B={B_MAIN} T={T_MAIN}: {free_apart} envs "
        f"apart ({'reported: the tether knife edge' if name in TETHER else 'limit 0.1%'}), max "
        f"|err| on the others {free_err:.3e}, reward total rel err {reward_rel:.3e}; bitwise "
        f"equal on a rerun: ok")
    ms, plain_ms = statistics.median(kern0 + kern1), (plain0 + plain1) / 2
    ops = OPS_CONTROL[d] + OPS_STEP[d]
    bound_ms, bound_by = bound(nbytes(big_t, f_k, r_k), ops * B_MAIN * T_MAIN)
    say(f"time K8/K9 {name} B={B_MAIN} T={T_MAIN}: {ms:.3f} ms (median of 10 launches, each "
        f"{min(kern0 + kern1):.3f} to {max(kern0 + kern1):.3f}), "
        f"{B_MAIN * T_MAIN / ms * 1e3:.4e} env-steps/s; twin {plain_ms:.1f} ms (runs "
        f"{plain0:.1f}, {plain1:.1f}); bound {bound_ms:.3f} ms by {bound_by} ({ops} operations "
        f"per env-step), on {gpu}")
    del big_t, f_k, r_k, x
    torch.cuda.empty_cache()
    kid, line = ("K8", 567) if name == "quadrotor2d-v0" else (
        "K9", 332 if name == "quadrotor2d-slungload-v0" else 310)
    return {"name": f"closed_loop_rollout ({name}, {kid})", "route": "cuda",
            "source": "reinmav_tpu_torch/csrc/closed_loop_rollout.cu",
            "replaces": ("reinmav_tpu/ops/pallas_rollout.py:567" if kid == "K8" else
                         f"reinmav_tpu/ops/pallas_slungload.py:{line}"),
            "launches": launches["K8/K9"], "max_abs_err": err, "mismatched_envs": outside,
            "free_running_envs_apart": free_apart,
            "tolerance": f"rtol 2e-4 atol 2e-5 per env over {T_RESYNC} steps resynchronised at "
                         f"full width, 0 envs outside off the knife edges; max_abs_err there",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "at": f"states ({d}, {B_MAIN}), horizon {T_MAIN}, auto-reset"}


def native_phases(torch, dev, gpu: str) -> list[dict]:
    """Phases 20-23: K8 and K9 (phase 20), then for each of quadrotor2d-v0
    and the slung-load envs the fused PPO rollout (K6-rest), K3 and K4 at
    its dims against their twins and a few updates of its default path
    (K6 + K4) and of fused_update="off" (K6 + the K3 loop) (phase 21); K7 on
    its kind in five mode legs and SAC and TD3 iterations on the card
    (phase 22); then the CLI on quadrotor2d-v0 (phase 23).  Returns the
    kernels' entries of the ``kernels`` line."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.rl import ppo, sac, td3

    entries = [closed_loop_phase(torch, dev, gpu, name) for name in NATIVE]
    updates = WARMUP_UPDATES + TIMED_UPDATES
    for name, (d, a) in NATIVE.items():
        env = reinmav_tpu_torch.make(name)
        gen = torch.Generator(device=dev).manual_seed(21)
        k6, k3, k4 = fused_kernel_checks(
            torch, dev, gpu, env, lambda state: native_states(torch, env, gen, B_PPO, 1.5),
            (f"K6 {name}", f"K3 ({d}, {a})", f"K4 ({d}, {a})"))
        main_cfg = ppo.PpoConfig(num_envs=B_PPO, rollout_len=T_PPO)
        passes = main_cfg.num_epochs * main_cfg.num_minibatches
        main_launches, main_walls, main_summaries = training_phase(
            torch, dev, gpu, env, main_cfg, f"{name} ppo update (K6 + K4)")
        require(main_launches == {"K1": 0, "K2": updates, "K3": 0, "K4": updates, "K5": 0,
                                  "K7": 0, "K8/K9": 0, "K10": 0, "K11": 0},
                f"launches {main_launches} on the {name} default path")
        loop_launches, loop_walls, loop_summaries = training_phase(
            torch, dev, gpu, env, main_cfg._replace(fused_update="off"),
            f"{name} ppo update (K3 loop)")
        require(loop_launches == {"K1": 0, "K2": updates, "K3": updates * passes, "K4": 0,
                                  "K5": 0, "K7": 0, "K8/K9": 0, "K10": 0, "K11": 0},
                f"launches {loop_launches} on the {name} K3 loop")
        rewards = [s["mean_reward"] for s in main_summaries]
        loop_rewards = [s["mean_reward"] for s in loop_summaries]
        for r, e in zip(rewards, loop_rewards):
            require(abs(r - e) <= 0.1 * abs(e), f"{name} mean_reward {rewards} vs {loop_rewards}")
        say(f"{name} ppo mean_reward per update, K6 + K4 {[round(r, 4) for r in rewards]}, K6 + "
            f"the K3 loop from the same state {[round(e, 4) for e in loop_rewards]} (rtol 0.1); "
            f"timed updates median {statistics.median(main_walls[WARMUP_UPDATES:]):.2f} ms and "
            f"{statistics.median(loop_walls[WARMUP_UPDATES:]):.2f} ms, on {gpu}: ok")

        # 22. K7 on the kind, then SAC and TD3 through train_iters.
        k7 = k7_phase(torch, dev, gpu, env, native_states(torch, env, gen, B_OFF), "sac")
        k7_launches = {}
        for alg, module, cfg in (
                ("sac", sac, sac.SacConfig(num_envs=B_OFF, batch_size=BATCH_SAC,
                                           buffer_capacity=1 << 20, hidden=(H_SAC, H_SAC),
                                           warmup_steps=0)),
                ("td3", td3, td3.Td3Config(num_envs=B_OFF, batch_size=BATCH_SAC,
                                           buffer_capacity=1 << 20, hidden=(H_SAC, H_SAC),
                                           warmup_steps=0))):
            state = module.init_state(env, cfg, seed=0, device=dev)
            state, _, _, _ = offpolicy_iterations(torch, env, cfg, module, state, 1)
            state, met, wall, launches = offpolicy_iterations(torch, env, cfg, module, state,
                                                              NATIVE_ITERS)
            require(launches["K7"] == NATIVE_ITERS and sum(launches.values()) == NATIVE_ITERS,
                    f"{alg} on {name}: launches {launches}")
            require(all(math.isfinite(v) for v in met.values()), f"{alg} on {name}: {met}")
            k7_launches[alg] = launches["K7"]
            say(f"{alg} training path, {name}, B={B_OFF} batch {BATCH_SAC} 2 x {H_SAC}: K7 "
                f"launches {launches['K7']} in {NATIVE_ITERS} iterations, "
                f"{wall / NATIVE_ITERS:.3f} ms per iteration, on {gpu}; metrics "
                + ", ".join(f"{k} {v:.5g}" for k, v in met.items()) + ": ok")
            del state
            torch.cuda.empty_cache()

        def entry(label, source, replaces, launches, numbers, tolerance, extra=None):
            return {"name": label, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches, "max_abs_err": numbers["max_abs_err"],
                    **(extra or {}), "tolerance": tolerance, "ms": numbers["ms"],
                    "plain_ms": numbers["plain_ms"], "bound_ms": numbers["bound_ms"],
                    "bound_by": numbers["bound_by"], "library_ms": None, "at": numbers["at"]}

        entries += [
            entry(f"ppo_rollout ({name}, K6-rest)", "reinmav_tpu_torch/csrc/ppo_rollout.cu",
                  "reinmav_tpu/ops/pallas_ppo_rollout.py:703", main_launches["K2"], k6,
                  ("rtol 2e-4 atol 2e-5 per env, one step at a time from the twin's state over "
                   f"{T_PPO} steps off the tether sphere, 0 envs outside; max_abs_err over the "
                   "free-running envs that agree" if name in TETHER else
                   "rtol 2e-4 atol 2e-5 per env over its whole trajectory, <= 0.1% of envs may "
                   "differ; max_abs_err over the envs that agree"),
                  {"free_running_envs_apart": k6["mismatched"]}),
            entry(f"ppo_loss_grads_gather ({d}, {a})", "reinmav_tpu_torch/csrc/ppo_loss.cu",
                  "reinmav_tpu/ops/pallas_ppo.py:424", loop_launches["K3"],
                  {**k3, "at": f"{k3['at']}; launches on the {name} fused_update=\"off\" path"},
                  "grads rtol 2e-3 atol 2e-6, metrics rtol 2e-4 atol 1e-6, bitwise repeatable"),
            entry(f"ppo_update ({d}, {a})", "reinmav_tpu_torch/csrc/ppo_update.cu",
                  "reinmav_tpu/ops/pallas_ppo_update.py:304", main_launches["K4"], k4,
                  "params rtol 2e-4 atol 1e-6, moments rtol 2e-4 atol 5e-8 of the twin and of "
                  "the K3 loop; pass-0 gradient bitwise K3's; bitwise repeatable",
                  {"entries_outside_rtol_2e-4_atol_1e-6": k4["outside"]}),
            entry(f"offpolicy_collect ({name})", "reinmav_tpu_torch/csrc/offpolicy_collect.cu",
                  "reinmav_tpu/ops/pallas_offpolicy.py:155", k7_launches["sac"], k7,
                  "rtol 2e-4 atol 2e-5 per env over its block and new state, <= 0.1% of envs "
                  "may differ, in five mode legs; max_abs_err over the envs that agree; "
                  "bitwise repeatable",
                  {"mismatched_envs": k7["mismatched"], "td3_launches": k7_launches["td3"]}),
        ]
        del env
        torch.cuda.empty_cache()

    # 23. The CLI on quadrotor2d-v0.
    cli_phase(gpu, "quadrotor2d-v0")
    return entries


def reinmav_states(torch, gen, batch: int, t_hi: float = 0.0):
    """reinmav-v0's init state with U(-0.05, 0.05) on the 13 states and the
    time U(0, t_hi), ``(14, B)``: the JAX kernel test's perturbation."""
    dev = gen.device
    s = torch.zeros((14, batch), device=dev)
    s[6] = 1.0
    s[:13] += (torch.rand((13, batch), generator=gen, device=dev) * 2.0 - 1.0) * 0.05
    s[13] = torch.rand(batch, generator=gen, device=dev) * t_hi
    return s


def reinmav_phase(torch, dev, gpu: str) -> dict:
    """Phase 24: K10.  throughput_rollout(make("reinmav-v0")) through the
    public API at B_SWEEP x T_SWEEP and at B_REINMAV x T_SWEEP must launch K10
    once each, with reward sums exactly 90 T_SWEEP and the time T_SWEEP steps
    of dt on; K10 against its twin free-running at B_SWEEP x T_K10_CHECK
    (max |err| <= 1e-3, the envs outside TOL counted, every step's substep
    count equal); the counts over T_SWEEP steps from random times equal to
    the float32 recurrence's; a bitwise rerun; K10 and its twin timed.
    Returns K10's entry of the ``kernels`` line."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import reinmav_rollout as rr

    env = reinmav_tpu_torch.make("reinmav-v0")
    gen = torch.Generator(device=dev).manual_seed(24)
    counters = kernel_counters()
    t_end = torch.zeros((), device=dev)
    for _ in range(T_SWEEP):
        t_end = t_end + torch.tensor(env.params.dt, device=dev)
    main_launches = {}
    for batch in (B_SWEEP, B_REINMAV):
        for fn in counters.values():
            fn.launches = 0
        states = env.vreset(gen, batch)
        final, reward_sum = reinmav_tpu_torch.throughput_rollout(env, states, gen,
                                                                 horizon=T_SWEEP)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        require(launches == {**{k: 0 for k in counters}, "K10": 1},
                f"throughput_rollout(reinmav-v0) launches {launches}, expected K10 1")
        require(bool((reward_sum == 90.0 * T_SWEEP).all()), "reward sums are 90 T exactly")
        require(final.shape == (batch, 14) and bool(torch.isfinite(final).all()) and
                bool((final[:, 13] == t_end).all()), "finite states, the time T steps of dt on")
        main_launches[batch] = launches["K10"]
        if batch == B_SWEEP:
            main_states = states
        else:
            small_states = states
        dist = float((final[:, 0:3] - 1.0).norm(dim=1).mean())
        say(f"throughput_rollout(reinmav-v0) B={batch} T={T_SWEEP} backend=auto: K10 launches "
            f"{launches['K10']}, reward sums {float(reward_sum[0]):.1f} in every env, time "
            f"{float(final[0, 13]):.6f}, mean distance to the trajectory's end (1, 1, 1) "
            f"{dist:.4f}: ok")
    del final, reward_sum, states

    # K10 against its twin, free-running, in turns: plain, kernel, kernel, plain.
    x = reinmav_states(torch, gen, B_SWEEP)
    kernel_check = lambda: rr.reinmav_rollout(x, T_K10_CHECK, record_substeps=True)  # noqa: E731
    plain_check = lambda: rr.reinmav_rollout_reference(x, T_K10_CHECK,  # noqa: E731
                                                       record_substeps=True)
    (plain0,), (f_p, n_p) = cuda_ms(plain_check, 1)
    check0, (f_k, n_k) = cuda_ms(kernel_check, 3)
    err = float((f_k - f_p).abs().max())
    outside = int((~torch.isclose(f_k, f_p, **TOL).all(dim=0)).sum())
    require(torch.equal(n_k, n_p), "K10 and its twin count the substeps alike")
    require(err <= 1e-3, f"K10 vs twin: max |err| {err}")
    again = kernel_check()
    require(torch.equal(f_k, again[0]) and torch.equal(n_k, again[1]), "K10 bitwise rerun")
    x_long = reinmav_states(torch, gen, B_REINMAV, t_hi=4.0)
    x_long[13, : B_REINMAV // 2] = 0.0
    _, n_long = rr.reinmav_rollout(x_long, T_SWEEP, record_substeps=True)
    require(torch.equal(n_long, rr.substep_counts(x_long[13], T_SWEEP)),
            "K10's counts over the horizon are the float32 recurrence's")
    fifty_one = int((n_long[:400, 0] == 51).sum())
    require(fifty_one == 14, f"14 x 51 substeps in 400 steps from t = 0, got {fifty_one}")
    say(f"K10 vs twin, free-running B={B_SWEEP} T={T_K10_CHECK} from t = 0: max |err| {err:.3e} "
        f"(limit 1e-3), {outside} envs outside rtol 2e-4 atol 2e-5 (reported), every step's "
        f"substep count equal ({int((n_k == 51).sum())} env-steps of 51); B={B_REINMAV} "
        f"T={T_SWEEP} from times in [0, 4]: counts equal to the float32 recurrence's, 14 x 51 "
        f"in the first 400 steps from t = 0; bitwise equal on a rerun: ok")
    del f_k, f_p, n_k, n_p, again

    big_t = main_states.T.contiguous()
    kernel_run = lambda: rr.reinmav_rollout(big_t, T_SWEEP)  # noqa: E731
    kernel_run()
    kern0, final_t = cuda_ms(kernel_run, 5)
    kern1, _ = cuda_ms(kernel_run, 5)
    (plain1,), _ = cuda_ms(plain_check, 1)
    check1, _ = cuda_ms(kernel_check, 3)
    ms = statistics.median(kern0 + kern1)
    plain_ms, check_ms = (plain0 + plain1) / 2, statistics.median(check0 + check1)
    substeps = int(rr.substep_counts(big_t[13], T_SWEEP).sum(dtype=torch.int64))
    bound_ms, bound_by = bound(nbytes(big_t, final_t), OPS_K10_SUBSTEP * substeps)
    # The 8192-env batch of the main path's second call: under one wave.
    small_t = small_states.T.contiguous()
    small_ms = statistics.median(cuda_ms(lambda: rr.reinmav_rollout(small_t, T_SWEEP), 5)[0])
    small_substeps = int(rr.substep_counts(small_t[13], T_SWEEP).sum(dtype=torch.int64))
    small_bound, _ = bound(nbytes(small_t, small_t), OPS_K10_SUBSTEP * small_substeps)
    say(f"time K10 B={B_SWEEP} T={T_SWEEP}: {ms:.3f} ms (median of 10 launches, each "
        f"{min(kern0 + kern1):.3f} to {max(kern0 + kern1):.3f}), "
        f"{B_SWEEP * T_SWEEP / ms * 1e3:.4e} env-steps/s; bound {bound_ms:.3f} ms by "
        f"{bound_by} ({substeps} substeps of {OPS_K10_SUBSTEP} operations); at "
        f"B={B_SWEEP} T={T_K10_CHECK}: K10 {check_ms:.3f} ms (median of 6), twin {plain_ms:.1f} "
        f"ms (runs {plain0:.1f}, {plain1:.1f}), so the twin at T={T_SWEEP} would take about "
        f"{plain_ms * T_SWEEP / T_K10_CHECK:.0f} ms (an estimate, scaled, not measured); at "
        f"B={B_REINMAV} T={T_SWEEP}: K10 {small_ms:.3f} ms (median of 5), bound "
        f"{small_bound:.3f} ms ({small_substeps} substeps); on {gpu}")
    del big_t, final_t, x, x_long, main_states, small_states, small_t
    torch.cuda.empty_cache()
    return {"name": "reinmav_rollout (reinmav-v0, K10)", "route": "cuda",
            "source": "reinmav_tpu_torch/csrc/reinmav_rollout.cu",
            "replaces": "reinmav_tpu/ops/pallas_reinmav.py:245",
            "launches": main_launches[B_SWEEP], "launches_at_8192": main_launches[B_REINMAV],
            "max_abs_err": err, "envs_outside_rtol_2e-4_atol_2e-5": outside,
            "tolerance": f"max |err| <= 1e-3 free-running over {T_K10_CHECK} steps at B="
                         f"{B_SWEEP}; every step's substep count equal",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "plain_at": f"states (14, {B_SWEEP}), horizon {T_K10_CHECK}",
            "ms_at_plain_shape": check_ms, "ms_at_8192": small_ms,
            "bound_ms_at_8192": small_bound,
            "at": f"states (14, {B_SWEEP}), horizon {T_SWEEP}; plain_ms at plain_at"}


def contact_states(torch, gen, batch: int, tilt: float = 0.25, z_lo: float = 0.0):
    """tests/test_pallas_tpuquad.py's contact-heavy states, ``(13, B)``: the
    z = 0 pose raised by U(z_lo, 0.05), the quaternion tilted by U(-tilt,
    tilt) and renormalised, velocities and rates U(-0.2, 0.2)."""
    dev = gen.device

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0

    s = torch.zeros((13, batch), device=dev)
    s[2] = z_lo + (0.05 - z_lo) * torch.rand(batch, generator=gen, device=dev)
    s[3] = 1.0
    s[4:7] = u(3, batch) * tilt
    s[7:13] = u(6, batch) * 0.2
    s[3:7] = s[3:7] / s[3:7].norm(dim=0)
    return s


def contact_ops(tiers, pgs_iters: int) -> float:
    """FP32 operations K11's run needs, from its ``(B, 3)`` counts of the
    substeps that solved nothing, 16 and 48 candidates (OPS_K11)."""
    n0, n16, n48 = (int(v) for v in tiers.long().sum(dim=0))
    k = OPS_K11

    def solve(nc):
        stage = nc * k["stage_cand"] + k["stage_env"]
        return k["frame"] + nc * k["setup"] + pgs_iters * 4 * stage

    return (n0 + n16 + n48) * (k["rigid"] + 48 * k["ztest"]) + n16 * solve(16) + n48 * solve(48)


def contact_phase(torch, dev, gpu: str, name: str) -> dict:
    """Phase 25 for one contact env: throughput_rollout through the public
    API at B_SWEEP x T_SWEEP must launch K11 once (zero reward sums, finite
    states resting on the plane); the same run with its tier mix recorded,
    which the bound counts; K11 against its twin T_K11_RESYNC steps one at a
    time from the twin's state at B_SWEEP from contact-heavy states, 0 envs
    outside TOL off the knife edges (a candidate within KNIFE_PLANE of the
    plane at the step's start or middle), which are counted; free-running
    at B_K11_FREE x T_K11_FREE, mean Σz within 1% of the twin's and min z >
    -0.1; the forced 48-candidate sweep bitwise the gated one on states
    without arm contact; bitwise reruns; timings.  Returns K11's entry of the
    ``kernels`` line."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import contact_rollout as cr

    env = reinmav_tpu_torch.make(name)
    gen = torch.Generator(device=dev).manual_seed(25)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    states = env.vreset(gen, B_SWEEP)
    (main_ms,), (final, reward_sum) = cuda_ms(
        lambda: reinmav_tpu_torch.throughput_rollout(env, states, gen, horizon=T_SWEEP), 1)
    launches = {k: fn.launches for k, fn in counters.items()}
    require(launches == {**{k: 0 for k in counters}, "K11": 1},
            f"throughput_rollout({name}) launches {launches}, expected K11 1")
    require(torch.equal(reward_sum, torch.zeros_like(reward_sum)), f"{name}: zero reward sums")
    require(bool(torch.isfinite(final).all()) and float(final[:, 2].min()) > -0.1,
            f"{name}: finite states on the plane")
    say(f"throughput_rollout({name}) B={B_SWEEP} T={T_SWEEP} backend=auto: K11 launches "
        f"{launches['K11']}, reward sums 0, final z {float(final[:, 2].min()):.5f} to "
        f"{float(final[:, 2].max()):.5f}: ok")

    # The main path's tier mix, from its inputs: the same run with the tiers
    # recorded, timed too.
    vec = cr.contact_params_vec(env.params)
    big_t = states.T.contiguous()
    (kern0,), (f_t, z_t, tiers) = cuda_ms(
        lambda: cr.contact_rollout(big_t, T_SWEEP, params_vec=vec, record_tiers=True), 1)
    require(torch.equal(f_t, final.T), f"{name}: the main path's run bitwise the kernel's")
    del final, reward_sum, states

    # One step at a time from the twin's state, at full width.
    x, outside, knife, err, plain_steps = contact_states(torch, gen, B_SWEEP), 0, 0, 0.0, []
    touching = 0
    kernel_steps = []
    for _ in range(T_K11_RESYNC):
        (step_ms,), (f_k, z_k, t_k) = cuda_ms(
            lambda: cr.contact_rollout(x, 1, params_vec=vec, record_tiers=True), 1)
        kernel_steps.append(step_ms)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        mid, _, t_mid = cr.contact_rollout_reference(x, 1, params_vec=vec, frame_skip=1,
                                                     record_tiers=True)
        f_p, z_p, t_p = cr.contact_rollout_reference(mid, 1, params_vec=vec, frame_skip=1,
                                                     record_tiers=True)
        end.record()
        torch.cuda.synchronize()
        plain_steps.append(start.elapsed_time(end))
        safe = ~(cr.near_plane(x, KNIFE_PLANE) | cr.near_plane(mid, KNIFE_PLANE))
        close = (torch.isclose(f_k, f_p, **TOL).all(dim=0) & torch.isclose(z_k, z_p, **TOL)
                 & (t_k == t_mid + t_p).all(dim=1))
        outside += int((~close & safe).sum())
        knife += int((~safe).sum())
        touching += int((t_k[:, 0] < 2).sum())
        err = max(err, float((f_k[:, safe] - f_p[:, safe]).abs().max()))
        x = f_p
    require(outside == 0, f"{name} resynchronised: {outside} envs outside")
    plain_step, kernel_step = statistics.median(plain_steps), statistics.median(kernel_steps)
    say(f"K11 {name} vs twin, {T_K11_RESYNC} steps resynchronised at B={B_SWEEP}: {outside} envs "
        f"outside rtol 2e-4 atol 2e-5 (tiers equal too), {knife} env-steps on a knife edge "
        f"skipped (a candidate within {KNIFE_PLANE:g} of the plane), {touching} env-steps in "
        f"contact, max |err| {err:.3e}: ok")

    # Free-running at B_K11_FREE x T_K11_FREE: the batch's mean Σz.
    y = contact_states(torch, gen, B_K11_FREE)
    f_k, z_k = cr.contact_rollout(y, T_K11_FREE, params_vec=vec)
    f_p, z_p = cr.contact_rollout_reference(y, T_K11_FREE, params_vec=vec)
    z_rel = abs(float(z_k.double().mean() - z_p.double().mean())) / abs(float(z_p.double().mean()))
    apart = int((~torch.isclose(f_k, f_p, **TOL).all(dim=0)).sum())
    require(z_rel <= 0.01 and float(f_k[2].min()) > -0.1,
            f"{name} free-running: mean Σz rel err {z_rel}, min z {float(f_k[2].min())}")
    again = cr.contact_rollout(y, T_K11_FREE, params_vec=vec)
    require(torch.equal(f_k, again[0]) and torch.equal(z_k, again[1]), f"{name}: bitwise rerun")
    say(f"K11 {name} free-running B={B_K11_FREE} T={T_K11_FREE}: mean Σz {float(z_k.mean()):.6f}, "
        f"twin {float(z_p.mean()):.6f} (rel err {z_rel:.3e}, limit 1%), min z "
        f"{float(f_k[2].min()):.5f} (> -0.1), {apart} envs apart at rtol 2e-4 atol 2e-5 "
        f"(reported); bitwise equal on a rerun: ok")

    # The tiers: no arm contact, gated against the forced 48-candidate sweep.
    n = contact_states(torch, gen, B_SWEEP, tilt=0.02, z_lo=0.015)
    gated_run = lambda: cr.contact_rollout(n, T_K11_TIERS, params_vec=vec,  # noqa: E731
                                           record_tiers=True)
    forced_run = lambda: cr.contact_rollout(n, T_K11_TIERS, params_vec=vec,  # noqa: E731
                                            force48=True, record_tiers=True)
    (gated_ms,), gated = cuda_ms(gated_run, 1)
    (forced_ms,), forced = cuda_ms(forced_run, 1)
    require(torch.equal(gated[0], forced[0]) and torch.equal(gated[1], forced[1]),
            f"{name}: the 16-candidate tier bitwise the forced 48")
    g_mix, f_mix = gated[2].sum(dim=0).tolist(), forced[2].sum(dim=0).tolist()
    require(f_mix[1] == 0 and g_mix[1] > 0 and g_mix[1] + g_mix[2] == f_mix[2],
            f"{name}: tier mixes gated {g_mix}, forced {f_mix}")
    say(f"K11 {name} tiers, B={B_SWEEP} T={T_K11_TIERS}, nearly level bodies: the gated run "
        f"(substeps without a solve, on 16, on 48: {g_mix}) bitwise equal to the forced 48-"
        f"candidate sweep ({f_mix}); {gated_ms:.3f} ms against {forced_ms:.3f} ms: ok")

    ms = (main_ms + kern0) / 2
    mix = tiers.sum(dim=0).tolist()
    bound_ms, bound_by = bound(nbytes(big_t, f_t, z_t), contact_ops(tiers, cr._PGS_ITERS))
    say(f"time K11 {name} B={B_SWEEP} T={T_SWEEP}: {ms:.3f} ms (mean of 2 launches: the main "
        f"path's call, {main_ms:.3f}, and the kernel's with its tiers recorded, {kern0:.3f}), "
        f"{B_SWEEP * T_SWEEP / ms * 1e3:.4e} env-steps/s; substeps without a solve, on 16, on "
        f"48 candidates: {mix}; bound {bound_ms:.3f} ms by {bound_by}; one step at B={B_SWEEP} "
        f"from the contact-heavy states (medians of {T_K11_RESYNC}): K11 {kernel_step:.3f} ms, "
        f"twin {plain_step:.1f} ms, so the twin at T={T_SWEEP} would take about "
        f"{plain_step * T_SWEEP:.0f} ms (an estimate, scaled, not measured); on {gpu}")
    del big_t, f_t, z_t, x, y, n, gated, forced, f_k, f_p, again
    torch.cuda.empty_cache()
    return {"name": f"contact_rollout ({name}, K11)", "route": "cuda",
            "source": "reinmav_tpu_torch/csrc/contact_rollout.cu",
            "replaces": "reinmav_tpu/ops/pallas_tpuquad.py:588",
            "launches": launches["K11"], "max_abs_err": err, "mismatched_envs": outside,
            "knife_edge_env_steps": knife, "free_running_envs_apart": apart,
            "tier_mix": mix, "tiers_gated_ms": gated_ms, "tiers_forced48_ms": forced_ms,
            "tolerance": f"rtol 2e-4 atol 2e-5 per env over {T_K11_RESYNC} steps resynchronised "
                         f"at B={B_SWEEP}, 0 envs outside off the knife edges; max_abs_err there",
            "ms": ms, "plain_ms": plain_step, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "plain_at": f"contact-heavy states (13, {B_SWEEP}), horizon 1, zero action",
            "ms_at_plain_shape": kernel_step,
            "at": f"states (13, {B_SWEEP}), horizon {T_SWEEP}, zero action; plain_ms at plain_at"}


def ptxas_report(path) -> list[str]:
    """One line per kernel of ptxas's report: registers, spill stores and
    loads, shared memory."""
    import re

    rows, name, spill = [], None, ""
    for line in Path(path).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            rows.append((name, f"{m.group(1)} registers, {spill}{m.group(2)}"))
            name, spill = None, ""
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in rows),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
    except OSError:
        names = [n for n, _ in rows]
    if len(names) != len(rows):
        names = [n for n, _ in rows]
    short = [n.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
             for n in names]
    return [f"ptxas: {n}: {info}" for n, (_, info) in zip(short, rows)]



def main() -> int:
    import torch

    # 1. Device.
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1
    gpu = gpu_label()
    say(f"gpu: {gpu}  (nvidia-smi name, power.limit)")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    logging.basicConfig(level=logging.INFO, format="log: %(name)s: %(message)s",
                        stream=sys.stdout)

    import reinmav_tpu_torch
    from reinmav_tpu_torch import _build
    from reinmav_tpu_torch.ops import rollout as ro

    # 2. Build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    say(f"build: {time.perf_counter() - t0:.2f} s, nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"-> {lib_path.name}")
    for line in ptxas_report(_build.ptxas_log_path()):
        say(line)

    # 3. Philox known answers, on the device through the kernel library.
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))]
    got = ro.philox4x32_10(torch.tensor([c for c, _, _ in kat], device=dev),
                           torch.tensor([k for _, k, _ in kat], device=dev))
    for row, (_, _, expected) in zip(got.tolist(), kat):
        require(tuple(row) == expected, f"philox KAT {[hex(v) for v in row]} != {expected}")
    say("philox4x32-10 known answers: ok (zero and all-ones counter/key, on the device)")

    # 4. K1 against its plain twin.  The slice has no matmul; TF32 is set
    # off anyway, so that no reference here can run in reduced precision.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1234)

    def uniform_states(batch, scale):
        return (torch.rand((10, batch), generator=gen, device=dev) * 2.0 - 1.0) * scale

    tame = uniform_states(B_CHECK, 0.1)
    f_k, r_k = ro.quad3d_rollout_autoreset(tame, 17, T_NO_RESET, autoreset=False)
    f_p, r_p = ro.quad3d_rollout_reference(tame, 17, T_NO_RESET, autoreset=False)
    torch.cuda.synchronize()
    err_no_reset = float((f_k - f_p).abs().max())
    reward_rel = abs(float(r_k.double().sum() - r_p.double().sum())) / abs(float(r_p.double().sum()))
    require(torch.allclose(f_k, f_p, **TOL), "no-reset leg final states")
    require(reward_rel <= RTOL_REWARD, f"no-reset leg reward total, rel err {reward_rel}")
    say(f"K1 vs twin, no reset, B={B_CHECK} T={T_NO_RESET}: max |err| {err_no_reset:.3e}, "
        f"reward total rel err {reward_rel:.3e} (rtol 2e-4 atol 2e-5; reward rtol 1e-4): ok")

    full = uniform_states(B_CHECK, 1.0)
    f_k, r_k = ro.quad3d_rollout_autoreset(full, 99, T_RESET)
    f_p, r_p = ro.quad3d_rollout_reference(full, 99, T_RESET)
    torch.cuda.synchronize()
    mismatched = int((~torch.isclose(f_k, f_p, **TOL).all(dim=0)).sum())
    reward_rel_reset = (abs(float(r_k.double().sum() - r_p.double().sum()))
                        / abs(float(r_p.double().sum())))
    require(mismatched <= 0.001 * B_CHECK, f"auto-reset leg: {mismatched} envs mismatched")
    require(reward_rel_reset <= 1e-3, f"auto-reset leg reward total, rel err {reward_rel_reset}")
    say(f"K1 vs twin, auto-reset, B={B_CHECK} T={T_RESET}: {mismatched} of {B_CHECK} envs "
        f"mismatched (limit 0.1%), reward total rel err {reward_rel_reset:.3e} (rtol 1e-3): ok")

    f_k2, r_k2 = ro.quad3d_rollout_autoreset(full, 99, T_RESET)
    require(torch.equal(f_k, f_k2) and torch.equal(r_k, r_k2), "determinism per seed")
    require(bool(torch.isfinite(f_k).all()) and bool(torch.isfinite(r_k).all()), "finite")
    max_pos = float(f_k[0:3].norm(dim=0).max())
    require(max_pos < 3.5, f"envelope: max |p| {max_pos}")
    say(f"K1 determinism: bitwise equal on a rerun; envelope: finite, max |p| {max_pos:.3f} < 3.5: ok")

    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    small = env.vreset(gen, B_QUICK) * 0.1
    f_kern, r_kern = reinmav_tpu_torch.throughput_rollout(env, small, gen, 100, backend="kernel")
    f_eager, r_eager = reinmav_tpu_torch.throughput_rollout(env, small, gen, 100, backend="scan")
    require(torch.allclose(f_kern, f_eager, **TOL), "kernel path vs eager env core, states")
    rel = abs(float(r_kern.double().sum() - r_eager.double().sum())) / abs(float(r_eager.double().sum()))
    require(rel <= RTOL_REWARD, f"kernel path vs eager env core, reward rel err {rel}")
    say(f"throughput_rollout kernel vs eager env core, B={B_QUICK} T=100: "
        f"max |err| {float((f_kern - f_eager).abs().max()):.3e}: ok")

    # 5. The main path, through the public entry points.
    ro.quad3d_rollout_autoreset.launches = 0
    gen = torch.Generator(device=dev).manual_seed(0)
    states = env.vreset(gen, B_QUICK)
    final, traj = reinmav_tpu_torch.control_rollout(env, states, gen, horizon=T_QUICK)
    big = env.vreset(gen, B_MAIN)
    big_final, reward_sum = reinmav_tpu_torch.throughput_rollout(env, big, gen, horizon=T_MAIN)
    torch.cuda.synchronize()
    launches = ro.quad3d_rollout_autoreset.launches

    require(traj.state.shape == (T_QUICK, B_QUICK, 10), "trajectory shape")
    dist = float((final[:, :3] - final.new_tensor(REF)).norm(dim=-1).mean())
    done_frac = float(traj.done.float().mean())
    require(dist < 0.1, f"mean distance to {REF} at step {T_QUICK}: {dist}")
    say(f"control_rollout B={B_QUICK} T={T_QUICK}: mean distance to {REF} {dist:.4f} (< 0.1), "
        f"done fraction {done_frac:.2e}: ok")
    require(launches >= 1, "throughput_rollout did not launch K1")
    require(big_final.shape == (B_MAIN, 10) and reward_sum.shape == (B_MAIN,), "output shapes")
    require(bool(torch.isfinite(reward_sum).all()) and bool(torch.isfinite(big_final).all()),
            "finite reward sums and states")
    say(f"throughput_rollout B={B_MAIN} T={T_MAIN} backend=auto: K1 launches {launches}, "
        f"reward sums finite, mean {float(reward_sum.mean()):.3f}: ok")

    # 6. K1 against its twin at the main path's shape, and both timed there
    # in turns: plain, kernel, kernel, plain.
    big_t = big.T.contiguous()
    kernel_run = lambda: ro.quad3d_rollout_autoreset(big_t, 7, T_MAIN)  # noqa: E731
    plain_run = lambda: ro.quad3d_rollout_reference(big_t, 7, T_MAIN)  # noqa: E731
    kernel_run()  # warm-up
    ro.quad3d_rollout_reference(big_t, 7, 5)  # warm-up
    torch.cuda.synchronize()
    (plain0,), (f_p, r_p) = cuda_ms(plain_run, 1)
    kern0, (f_k, r_k) = cuda_ms(kernel_run, 5)
    kern1, _ = cuda_ms(kernel_run, 5)
    (plain1,), _ = cuda_ms(plain_run, 1)
    mismatched_main = int((~torch.isclose(f_k, f_p, **TOL).all(dim=0)).sum())
    max_abs_err = float((f_k - f_p).abs().max())
    reward_rel_main = (abs(float(r_k.double().sum() - r_p.double().sum()))
                       / abs(float(r_p.double().sum())))
    require(mismatched_main <= 0.001 * B_MAIN, f"main shape: {mismatched_main} envs mismatched")
    require(reward_rel_main <= 1e-3, f"main shape reward total, rel err {reward_rel_main}")
    say(f"K1 vs twin, auto-reset, B={B_MAIN} T={T_MAIN}: {mismatched_main} of {B_MAIN} envs "
        f"mismatched (limit 0.1%), max |err| {max_abs_err:.3e}, reward total rel err "
        f"{reward_rel_main:.3e} (rtol 1e-3): ok")
    kernel_ms, plain_ms = statistics.median(kern0 + kern1), (plain0 + plain1) / 2
    say(f"time K1 B={B_MAIN} T={T_MAIN}: {kernel_ms:.3f} ms per rollout (median of 10 "
        f"launches, each {min(kern0 + kern1):.3f} to {max(kern0 + kern1):.3f}), "
        f"{B_MAIN * T_MAIN / kernel_ms * 1e3:.4e} env-steps/s on {gpu}")
    say(f"time plain twin B={B_MAIN} T={T_MAIN}: {plain_ms:.1f} ms per rollout "
        f"(runs {plain0:.1f}, {plain1:.1f}), {B_MAIN * T_MAIN / plain_ms * 1e3:.4e} "
        f"env-steps/s on {gpu}")

    k1_bound, k1_by = bound(nbytes(big_t, f_k, r_k), OPS_K1 * B_MAIN * T_MAIN)
    kernels = [{
        "name": "quad3d_rollout_autoreset",
        "route": "cuda",
        "source": "reinmav_tpu_torch/csrc/quad3d_rollout.cu",
        "replaces": "reinmav_tpu/ops/pallas_rollout.py:591",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "mismatched_envs": mismatched_main,
        "tolerance": "rtol 2e-4 atol 2e-5 per env, <= 0.1% of envs may differ",
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "at": f"states {tuple(f_k.shape)}, horizon {T_MAIN}",
    }]
    del big, big_final, big_t, f_k, f_p, r_k, r_p, reward_sum
    torch.cuda.empty_cache()

    kernels += ppo_phases(torch, dev, gpu, env)
    kernels += hover_phases(torch, dev, gpu)
    kernels += offpolicy_phases(torch, dev, gpu)
    kernels += native_phases(torch, dev, gpu)
    # 24. K10; 25. K11 on each contact env.
    kernels.append(reinmav_phase(torch, dev, gpu))
    for line in ptxas_report(_build.ptxas_log_path()):
        if "contact_rollout" in line or "reinmav_rollout" in line:
            say(line)
    kernels += [contact_phase(torch, dev, gpu, name)
                for name in ("MujocoQuadForce-v0", "MujocoQuadQuat-v0")]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
