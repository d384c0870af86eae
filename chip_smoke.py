#!/usr/bin/env python3
"""Smoke run of the PyTorch port (reinmav_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

``--only hashes`` runs phases 1-3 and then only K1, every K2/K6 kind, K4
at (10, 4) and (13, 4) and K7 on every kind on fixed inputs like those of
phases 4, 6, 7, 10, 13, 15, 21 and 22, each drawn from a generator of its
own: each output's SHA-256, each kernel timed with its SASS and the
sampled SM clock, K2/K6 on its other instances and inputs, K4's clip
edge counted on phase 13's second input and on three more hover inputs,
and K7 in every mode leg, timed in its kind's training mode and at H = 32
and in the four modes; it prints no result line.  Run in turns in two
checkouts (the
parent's with this script and sass_report.py copied in), the digests show
whether two trees' kernels give the same bits.

Phases, in order; any failure raises and exits non-zero:

1. Device: a CUDA device is required (no CPU carry-on); prints the
   card's name and power limit from nvidia-smi.
2. Build: compiles the hand-written kernels from reinmav_tpu_torch/csrc/
   with nvcc and prints the build time, ptxas's registers and spills, and
   the static SASS of K5's and K10's substep loops, of K1's and K8/K9's
   horizon loops (their reset block apart) and of K2/K6's horizon loop an
   env-step, by pipe (reinmav_tpu_torch/sass_report.py on cuobjdump -sass
   of the library just built).
3. Philox known answers: Random123's two vectors, on the device,
   through the kernel library.
4. Kernel K1 against its plain PyTorch twin, on the card: a no-reset leg
   (65,536 envs x 200 steps), an auto-reset leg (65,536 x 1000, counting
   the envs that disagree), determinism, the state envelope, and the
   kernel path of throughput_rollout against the env core's eager loop;
   each leg's SHA-256.
5. The main path through the public API: make("quadrotor3d-v0"),
   vreset, control_rollout of 4096 envs x 400 steps (mean distance to
   the reference point), then throughput_rollout of 2,097,152 envs x
   1000 steps with backend="auto", which must launch K1.
6. K1 against its plain twin at the main path's shape (2,097,152 envs
   x 1000 steps, auto-reset on, one seed on both sides), and both timed
   there with CUDA events after a warm-up, in env-steps/s; the output's
   SHA-256, K1's registers, its horizon loop's SASS an env-step and the SM
   clock sampled during the timed launches, with the issue time they imply.
7. Kernel K2 (the fused PPO rollout) against its plain twin at the
   training path's 32,768 envs x 32 steps, with action noise and resets
   on: the envs that disagree anywhere in their trajectory, the relative
   error of logp, value, reward and the moment sums; both timed; the
   outputs' SHA-256, the instance's registers, its SASS an env-step and
   the SM clock, as phase 6.
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
   its twin timed.  Beside that gate, K4 resynchronised: each pass a
   one-pass launch from the twin's state after the pass before, the
   samples within 16 ulps of the ratio or value clip replaced (counted),
   0 entries of the gradient, params and moments outside (phases 13 and
   21 run it too).
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
   its twin at 32,768 x 32 with noise and resets on, as phase 7 (digest,
   registers, SASS, clock included); then K3
   and K4 built for the 13-dim observation against their twins on that
   trajectory, at phases 8 and 10's tolerances, with bitwise reruns; all
   timed.  K4 also on a second input, K6-hover's trajectory from hover
   states of a generator of their own (K4_SECOND_INPUTS[0]), at phase 10's
   gates; on both inputs the samples within 4 and 16 ulps of the clip
   edge 1 +- clip_eps on the twin's trajectory are counted, and K4 is held
   to its twin again with their advantages masked (printed, not gated).
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
   equal; K7 and its twin timed in the mode each kind trains with, with
   its ptxas registers, resident CTAs an SM and the SM clock.
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
   flag that differs), whose env-steps are counted; a bitwise rerun; the
   same free run with the per-env counts (taut env-steps of the slung-load
   kinds, done env-steps of quadrotor2d-v0) in kernel and twin, their
   shares printed, the slung-load kinds' within 1 percentage point of each
   other, the counting kernel bitwise the main path's; the horizon loop's
   SASS, its registers and the SM clock sampled during the timed launches,
   with the issue time that SASS implies.
21. For each of those envs: the fused PPO rollout (K6-rest) against its
   twin at 32,768 x 32 with noise and resets on (quadrotor2d-v0 as phase
   7; the slung-load kinds one step at a time from the twin's state off
   the sphere, the free-running count reported; digest, registers, SASS
   and clock as phase 7; for the slung-load kinds the taut env-steps of a
   free-running 256-step rollout counted by K6's counting instance and by
   the twin, within 1 percentage point, the counting instance bitwise the
   main path's), K3 and K4 built for its
   (obs, action) dims, (5, 2), (9, 2) or (16, 4), against their twins as
   phases 8 and 10; then 2 warm-up and 5 timed updates of the default path
   (K6 and K4 once per update, K3 never) and of fused_update="off" (K6
   once, K3 16 times), each update's mean_reward within 10% of the other.
22. K7 on each of those kinds against its twin in the five mode legs of
   phase 15 at 65,536 envs, 2 x 256 (for the slung-load kinds also the
   taut env-steps of 200 free-running iterations, K7's counting kernel
   against the twin's, within 1 point); then SAC and TD3 through
   train_iters at that size, K7 once per iteration.
23. The CLI on quadrotor2d-v0, as phase 11's.
24. Kernel K10 (reinmav-v0's rollout of 50/51-substep steps), at
   benchmarks/sweep.py:133-135's sizes: throughput_rollout(make(
   "reinmav-v0")) through the public API at 131,072 x 500 and at 8192 x 500
   must launch K10 once each (the layout its wrapper picks, lanes_per_env,
   printed), with reward sums exactly 90 x 500 and no reset; K10 in every
   layout (lanes_per_env 1, 2) against its twin free-running at 131,072
   and at 8192 x 50 from perturbed init states: bit for bit the twin's
   states and every step's substep count, a bitwise rerun; its
   straight-line atan2f and divisions bit for bit the library's on 2^23
   operand triples and every triple of special values; its counts over 500
   steps equal to the float32 recurrence's (14 x 51 in 400 steps from t =
   0); every layout timed at 500 steps at 131,072, 32,768, 24,576, 16,384
   and 8192 envs (the main path's states; the dispatch's cutover), with
   the SM clock sampled meanwhile and the issue time the substep's SASS
   implies there; K10 at 131,072 x 50 and the twin there (its time at 500
   steps is an estimate, scaled, in the text only).
25. Kernel K11 (the contact envs' rollout with the coupled contact solve),
   for each of MujocoQuadForce-v0 and MujocoQuadQuat-v0: throughput_rollout
   at 131,072 x 500 through the public API must launch it once (zero reward
   sums, the bodies resting on the plane) and be bitwise the kernel's run
   that records its tier mix (the substeps that solved nothing, 16 or 48
   candidates), from which the bound is counted; K11 against its twin 10
   steps one at a time from the twin's state at 131,072 envs from contact-
   heavy states, 0 envs outside rtol 2e-4 / atol 2e-5 off the knife edges (a
   candidate within 1e-6 of the plane), which are counted; the pairing of
   two envs a warp: envs with no contact, on the 16- and on the 48-candidate
   tier in every ordered pair of warp neighbours, and odd batches (1, 3,
   4097), bit for bit the twin's over 3 steps (+0 and -0 counted equal)
   with equal tier counts; free-running at 8192 x 100, Σz bit for bit the
   twin's (+0 and -0 counted equal) and min z > -0.1; the forced
   48-candidate sweep bitwise the gated one;
   bitwise reruns; K11 timed at 131,072 x 500 and on one step at 131,072,
   the twin on one step (its time at 500 steps is an estimate, scaled, in
   the text only); ptxas's registers and spills of K3, K4, K5, K10 and K11
   (phases 10, 13 and 21 print K4's at each (obs, action) pair).
26. The GRU learner (rl/recurrent.py, eager, no kernel) at the CLI's
   default shape (1024 envs x 128 steps, hidden 64): 2 warm-up and 5 timed
   train_step calls on quadrotor2d-v0, 1 and 2 on quadrotor3d-v0, finite
   metrics, no kernel launched, env-steps/s; one collection on the card
   (float32, TF32 off) against the CPU's in float64 from one state with
   the same action noise and reset states (envs apart at most 1%), and the
   first minibatch's gradient from the CPU's trajectory (error norm over
   norm at most 1e-3).
27. The GRU learning run of tests/test_recurrent.py:86-109's config, 40
   updates: the episode-return proxy's mean over the last 5 updates above
   the first 5's.
28. The GRU CLI in subprocesses: one update with a checkpoint, then play
   with --html, and --gif where matplotlib is installed (where it is not,
   --gif must exit before training, naming it).
29. The geometric controller (quadrotor3d-v0, the demos' circle) and the
   RPY PID (MujocoQuadForce-v1, control_rpy.py's loop), 4096 envs x 400
   steps each on the card in float32 against the CPU in float64: positions
   within 1 mm.
30-31. GymAdapter flying quadrotor3d-v0 400 steps with control() (final
   distance to the target under 0.5 m), VectorGymAdapter at 4096 envs x
   200 steps of zero thrust (final_obs counted and masked), both on cuda;
   where gymnasium is not installed, their step functions run the loops.
32. chunked_throughput_rollout at 2,097,152 x 1000 on quadrotor3d-v0 with
   a 3 ms budget: at least 4 chunks, K1 once a chunk, its wall against one
   throughput_rollout call; on the eager backend at 4096 x 50 bitwise the
   unchunked call.
33. save_html (and save_gif where matplotlib is installed) of a card
   rollout, one LiveViewer request on port 0, time_fn and trace on a K1
   call, NanGuard.  The wall of phases 26-33 is printed.
34-36. compute_dtype="bfloat16", for every kind of the fused PPO rollout
   (quadrotor3d-v0, the hover task, quadrotor2d-v0, the slung-load envs):
   K2/K6's bf16 instance against its bf16 twin at 32,768 x 32 (phase 7's
   gate; the slung-load kinds resynchronised as phase 21), K3's on a
   262,144-sample minibatch of that trajectory (phase 8's tolerances), K4's
   one 4 x 4 update held to its twin resynchronised each pass (phase 10's
   resynchronised gate), each timed in turns with its float32 instance on
   the same inputs, with registers and spills and its bf16 bound (products
   at 989 TFLOP/s); then the kind's bf16 training paths: the default
   (K2/K6 + K4 once an update) and fused_update="off" (K3 16 times), 2
   warm-up and 5 timed updates on quadrotor3d-v0 and 3 on the others, each
   update's mean_reward within 10% of the float32 path's from the same
   state, the params finite and float32.
37. K7's bf16 instance on every kind against its bf16 twin in phase 15's
   five mode legs at 65,536 envs, 2 x 256, timed in turns with the float32
   instance; then the bf16 off-policy path of the kind: SAC on the hover
   task at the bench config (20 iterations), 3 iterations of SAC or TD3 on
   the others, K7 once an iteration.
38. The CLI once with --compute_dtype=bfloat16 (3 updates at 32,768 x 32).
39. One rank on NCCL (a spawned process, world size 1) at 32,768 x 32 on
   quadrotor3d-v0, 3 updates a leg: the mesh mode bitwise the unsharded
   train_step (K2 and K4 once an update), the shard_map step (K2 once, K3
   16 times an update, the NCCL all-reduces counted), each update's
   mean_reward within 10% of the unsharded step's; all three timed.
40. Two ranks on the one card over gloo: sharded_dense_rollout of 1,048,576
   of 2,097,152 quadrotor3d-v0 envs each for 1000 steps (K1 once a rank,
   no collective, bitwise equal on a rerun, the two ranks' results apart;
   the first call and the rerun timed); then 16,384 of the 32,768 envs
   each: after 3 shard_map updates the replicas' params and Adam moments
   bitwise equal (K2 3, K3 48 a rank); the mesh mode's params against the one-rank
   run's (this process, one rank and no group): the first update bitwise,
   every update within rtol 2e-4 / atol 1e-6, the largest difference
   printed (K2 3, K4 3 a rank).
41. SAC on the two ranks at the bench config split (65,536 envs, batch
   8192 a rank, a 2^21-column ring, 2 x 256): 20 iterations, K7 once an
   iteration on each rank, the replicas' actor and critics bitwise equal,
   the time an iteration; TD3 on quadrotor3d-v0 at 8192 envs, 5 iterations.
42. The collective checkpoint on two ranks: 2 shard_map updates, a save,
   the group torn down, a fresh group restoring into a state of another
   seed, 2 more updates: bitwise the 4 uninterrupted on each rank.
43. The CLI under python -m torch.distributed.run --nproc_per_node=2 with
   --shard_map, 3 updates at 32,768 x 32: rank 0 logs one line an update,
   rank 1 none.
44. The examples on the card (reinmav_tpu_torch.examples): control_quat
   and control_rpy 150 steps on the circle (final radius within 0.2 m of
   0.5), reinmav_sim 50 steps against
   the min-jerk reference, train_quadrotor2d_ppo at its full size (K6 and
   K4 once an update, then a 1000-step play); control_quat's plots and
   train_vector_env refuse by name where matplotlib or gymnasium is not
   installed.  The wall of phases 39-44 is printed; ``--only parallel``
   runs phases 1-3 and 39-44.

The second-to-last line is a JSON object describing each kernel of the
paths (K1-K11, and the bf16 instances of K2/K6, K3, K4 and K7, whose
bound counts their products at the tensor cores' bf16 rate and whose
``f32_ms`` is the float32 instance's time in the same turns): its
launches on its main path, its error against its twin,
its time and its twin's (each measured; where the twin ran at a smaller
shape than the kernel, ``plain_at`` names that shape and
``ms_at_plain_shape`` is the kernel's time there), and its bound (the least
time the card could take: the larger of its bytes over the memory rate and
its FP32 operations over the FP32 rate); K1's, K2's, K3's, K4's and
K7's ``launches_sharded`` are their launches on phases 39-41's
multi-rank paths.  The last line is {"ok": true, "device": {...}}.
The script imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import logging
import math
import os
import socket
import statistics
import subprocess
import sys
import threading
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
HOVER_FRAME_SKIP = 2  # MujocoQuadForce-v1's, hover_rollout's default: substeps a step
OPS_ROLLOUT = {10: OPS_K2, 13: 20_352 + OPS_K5}
OPS_LOSS = {10: OPS_K3, 13: 57_728}
B_HOVER_CHECK = 65_536
HOVER_ACTIONS = ((0.0, 0.0, 0.0, 0.0), (0.75, 0.73, 0.74, 0.76))
HOVER = "MujocoQuadForce-v1"
HOVER_RET_VAR = 4.0 * (98.0 / 1.4) ** 2
#: Phase 13's second input for K4 at obs 13 (the states ``--only hashes``
#: gives K6-hover: a generator of their own, seed 13), and other inputs
#: that ``--only hashes`` also tries: (generator seed, z_lo, z_hi) of the
#: hover states K6-hover's trajectory starts from.
K4_SECOND_INPUTS = ((13, 0.35, 1.0), (1313, 0.31, 1.5), (1316, 0.3, 1.2), (1317, 0.32, 1.3))
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
# slung steps' taut branch), kept for K8/K9's own steps in
# csrc/closed_loop_rollout.cu (the same operations, a product by 1 / mass
# for a division): the planar PD controller 18, the geometric
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
K10_KERNELS = ("reinmav_rollout_kernel", "reinmav_rollout_lanes_kernel")
B_K10_LAYOUTS = (B_SWEEP, 32_768, 24_576, 16_384, B_REINMAV)  # every layout timed at these
# K11, FP32 operations, a hand count from csrc/contact_rollout.cu and
# hover_common.cuh (sqrt, rsqrt, sin, cos and divisions as one each): per
# substep the rigid body (rotation 30, free wrench 50, gyroscopic term 9,
# integration 80) and the z test of the 48 candidates (20 each); per
# substep that solves, the env's frame 40 and, per candidate of its tier
# (16 or 48), the setup 190 and, per sweep stage, 22 (the projected update
# 15, the arm products 3, its share of the four sums 4), plus 12 per stage
# for the env (eF and the wrench).
OPS_K11 = dict(rigid=170, ztest=20, frame=40, setup=190, stage_cand=22, stage_env=12)
# K11's resynchronised check runs 4 steps (10 through PR 14: its twin at full width takes
# about 7 s a step, and the whole smoke must stay well inside its time limit).
T_K11_RESYNC, B_K11_FREE, T_K11_FREE, T_K11_TIERS, T_K11_PAIRS = 10, 8192, 100, 10, 3
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


class SmClock:
    """Samples nvidia-smi's SM clock (one query every 0.1 s, in a thread)
    while the ``with`` block runs; ``mhz`` is the median of the samples
    (NaN if none came)."""

    def __enter__(self):
        self.samples, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=60).stdout.split()
            if out and out[0].replace(".", "", 1).isdigit():
                self.samples.append(float(out[0]))
            self._stop.wait(0.1)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.mhz = statistics.median(self.samples) if self.samples else math.nan
        return False


def issue_ms(instructions: int, threads_substeps: int, mhz: float) -> float:
    """Milliseconds that ``instructions`` a substep, run by one thread for
    each of ``threads_substeps`` substeps, take to issue at one
    warp-instruction a clock on each of the card's four schedulers an SM."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return instructions * threads_substeps / 32 / (4 * sms * mhz * 1e6) * 1e3


@functools.lru_cache(maxsize=None)
def _sass_counts() -> dict:
    from reinmav_tpu_torch import _build, sass_report

    return sass_report.report(_build.build(), Path("chiprun_out") / "smoke_sass")


def substep_sass(short_name: str) -> dict:
    """The static SASS of one pass of the substep loop of the kernel named
    ``short_name``, from cuobjdump -sass of the library this run built:
    ``{"total", "fp32_int", "mufu", "other"}`` (a static count: the slow
    paths that a branch skips included; the innermost loop that holds a
    MUFU instruction, the loops nested in it left out)."""
    sub = _sass_counts()[short_name]["substep"]
    require(sub is not None, f"{short_name}: no substep loop found in its SASS")
    return dict(total=sub["n"], fp32_int=sub["fp32/int"], mufu=sub["mufu"], other=sub["other"])


#: The closed-loop template's loop struct of each env, as it appears in the
#: demangled kernel name (closed_loop_kernel<...Quad2d...>).
CLOSED_LOOP_TAG = {"quadrotor2d-v0": "Quad2d", "quadrotor2d-slungload-v0": "Slung2d",
                   "quadrotor3d-slungload-v0": "Slung3d"}


def closed_loop_kernel_name(name: str) -> str:
    """The demangled name of the instantiation that the main path of env
    ``name`` launches (the one without counts)."""
    found = [k for k in _sass_counts() if k.startswith("closed_loop_kernel<")
             and CLOSED_LOOP_TAG[name] in k and not k.replace(" ", "").endswith(",true>")]
    require(len(found) == 1, f"{name}: closed-loop kernels {found} in the SASS")
    return found[0]


def horizon_sass(name: str) -> dict:
    """The static SASS of one pass of the horizon loop of env ``name``'s
    closed-loop kernel: :func:`loop_sass` of it."""
    return loop_sass(closed_loop_kernel_name(name))


def k1_kernel_name() -> str:
    """K1's main-path instance: the closed-loop template's Quad3dLoop with
    auto-reset, without counts (or ``quad3d_rollout_kernel``, K1's own
    kernel in a library built before K1 joined the template)."""
    found = [k for k in _sass_counts() if k.replace(" ", "") ==
             "closed_loop_kernel<Quad3dLoop<true>,false>"]
    return found[0] if found else "quad3d_rollout_kernel"


def loop_sass(short: str) -> dict:
    """The static SASS of one pass of the horizon loop of the closed-loop
    kernel ``short``: ``substep_sass``'s counts, plus ``reset`` (the
    Philox span of the auto-reset, by class, or None) and ``step`` (the
    loop's count less the part of that span it holds: what an env-step
    without a reset issues at most)."""
    counts = substep_sass(short)
    reset = _sass_counts()[short]["reset"]
    counts["reset"] = None if reset is None else {
        k: reset[k] for k in ("n", "fp32/int", "mufu", "other", "in_loop")}
    counts["step"] = counts["total"] - (0 if reset is None else reset["in_loop"])
    return counts


#: The env struct of each kind in K2/K6's demangled instance names.
PPO_STRUCT = {"quadrotor3d-v0": "Quad3dEnv", "MujocoQuadForce-v1": "HoverEnv",
              "quadrotor2d-v0": "Quad2dEnv", "quadrotor2d-slungload-v0": "Slung2dEnv",
              "quadrotor3d-slungload-v0": "Slung3dEnv"}


def ppo_instance(name: str, bf16: bool = False) -> str:
    """The demangled name of the K2/K6 instance env ``name``'s main path
    launches: both normalisers on, no counts, float32 (or with ``bf16`` its
    bf16 instance)."""
    struct = PPO_STRUCT[name]
    head = f"ppo_rollout_kernel<reinmav::{struct},true,true"
    names = ((f"{head},false,true>",) if bf16 else
             (f"{head}>", f"{head},false>", f"{head},false,false>"))
    found = [k for k in _sass_counts() if k.replace(" ", "") in names]
    require(len(found) == 1, f"{name}: K2/K6 instances {found} in the SASS")
    return found[0]


def ppo_sass(name: str, bf16: bool = False) -> dict:
    """The instructions an env-step of env ``name``'s K2/K6 instance (its
    bf16 instance with ``bf16``) issues at most without slow paths, by
    class, and the horizon loop's static count (sass_report.env_step_count
    on the library this run built)."""
    from reinmav_tpu_torch import sass_report

    return sass_report.env_step_count(_sass_counts()[ppo_instance(name, bf16)]["insns"])


def cta_issue_ms(instructions: int, batch: int, threads: int, steps: int, mhz: float) -> float:
    """Milliseconds that ``instructions`` an env-step, one env a thread in
    CTAs of ``threads``, take to issue for ``steps`` steps at one
    warp-instruction a clock on each scheduler, on the SM that holds the
    most CTAs (ceil(CTAs / SMs), its warps spread over 4 schedulers)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = -(-(-(-batch // threads)) // sms)
    return instructions * per_sm * threads / 32 / 4 * steps / (mhz * 1e6) * 1e3


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes in order (its first 16 hex digits): two
    trees' runs on the same inputs print the same digest when, and only
    when, their outputs are bitwise equal."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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


def k4_setup(torch, dev, cfg, params, adv, tile: int, n_tiles: int, d: int, adim: int):
    """K4's inputs besides the batch for one 4 x 4 update: the epochs'
    shuffles (seed 9), each pass's advantage stats, the params, a fresh
    Adam state and the keyword arguments of ``ppo_update``."""
    from reinmav_tpu_torch.rl import ppo

    e_, m_ = cfg.num_epochs, cfg.num_minibatches
    gen = torch.Generator().manual_seed(9)
    perm_all = torch.cat([ppo._shuffle_indices(gen, n_tiles, dev)
                          for _ in range(e_)]).to(torch.int32).contiguous()
    adv_stats = ppo.pass_adv_stats(adv.reshape(-1), perm_all, tile, e_ * m_, True)
    params = params.contiguous()
    opt = ppo.make_optimizer(cfg).init(params)
    kw = dict(d=d, adim=adim, tile=tile, n_minibatches=m_, n_epochs=e_, clip_eps=cfg.clip_eps,
              value_clip_eps=cfg.value_clip_eps, value_coef=cfg.value_coef,
              ent_coef=cfg.entropy_coef, lr=cfg.learning_rate, max_grad_norm=cfg.max_grad_norm)
    return perm_all, adv_stats, params, opt, kw


def twin_ratio(torch, data, cols, net, d: int, adim: int, bf16: bool = False):
    """The PPO ratio and value of the columns ``cols`` of ``data`` under
    the flat params ``net``, in the twin's float32 operations (K3's twin,
    ops/ppo_loss.py): each tower layer a matmul and tanh, the heads, then
    logp and exp(logp - old logp); with ``bf16`` the products' operands
    rounded to bf16, as the twin's bf16 mode rounds them."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.rl import networks

    r = networks.bf16_round if bf16 else (lambda t: t)  # noqa: E731
    p = networks.Layout(d, adim, (64, 64)).unflatten(net)
    mb = data[:, cols]
    acts = {}
    for tower in ("pi", "vf"):
        h = mb[:d]
        for layer in p[tower]:
            h = torch.tanh(r(layer["w"].T) @ r(h) + layer["b"][:, None])
        acts[tower] = h
    mean = r(p["pi_out"]["w"].T) @ r(acts["pi"]) + p["pi_out"]["b"][:, None]
    if hasattr(pl, "value_head"):  # the twin's own rounding order, where it has one
        value = pl.value_head(r(acts["vf"]), r(p["vf_out"]["w"][:, 0]), p["vf_out"]["b"][0])
    else:
        value = (p["vf_out"]["w"].T @ acts["vf"] + p["vf_out"]["b"][:, None])[0]
    ls = p["log_std"]
    var = torch.exp(2.0 * ls)[:, None]
    diff = mb[d:d + adim] - mean
    if hasattr(pl, "logp_ratio"):
        return pl.logp_ratio(diff, var, ls, mb[d + adim])[2], value
    logp = -0.5 * (diff * diff / var).sum(dim=0) - ls.sum() - 0.5 * adim * pl._LOG_2PI
    return torch.exp(logp - mb[d + adim]), value


#: Ulps of the ratio within which a sample counts as on the clip edge.
CLIP_EDGE_ULPS = (4, 16)


def value_edges(torch, value, old_value, ret, value_clip_eps: float):
    """The value term's knife edges, counted as :func:`clip_edges` counts
    the ratio's: samples whose ``|value - old_value|`` lies within each
    ``CLIP_EDGE_ULPS`` of ``value_clip_eps`` (where ``vin`` flips), and
    samples outside the value clip whose squared errors ``sq1``, ``sq2``
    lie within that many ulps of each other (where ``vs1``/``vs2`` flip and
    the value gradient jumps between ``e1`` and 0)."""
    eps = float(torch.tensor(value_clip_eps, dtype=torch.float32))
    vdiff = value - old_value
    vcl = old_value + torch.clamp(vdiff, -eps, eps)
    sq1, sq2 = (value - ret) ** 2, (vcl - ret) ** 2
    outside = vdiff.abs() >= eps
    ulp_v = torch.finfo(torch.float32).eps * max(eps, 1e-30)
    ulp_sq = torch.finfo(torch.float32).eps * torch.maximum(sq1, sq2).double().clamp_min(1e-30)
    return ({w: ((vdiff.abs().double() - eps).abs() <= w * ulp_v) for w in CLIP_EDGE_ULPS},
            {w: outside & ((sq1.double() - sq2.double()).abs() <= w * ulp_sq)
             for w in CLIP_EDGE_ULPS})


def clip_edges(torch, ratio, adv_n, clip_eps: float):
    """Masks of the samples whose ratio lies within each ``CLIP_EDGE_ULPS``
    of 1 +- clip_eps (the float32 ``1 - clip_eps``, ``1 + clip_eps`` and
    ``|ratio - 1| < clip_eps`` of K4 and the twin), and of the ``tie``
    samples (pg1 == pg2) outside the clip."""
    eps = torch.tensor(clip_eps, dtype=torch.float32)
    lo, hi = float(1.0 - eps), float(1.0 + eps)
    r = ratio.double()
    ulp = torch.where(r < 1.0, 2.0 ** -24, 2.0 ** -23)
    dist = torch.minimum((r - lo).abs(), (r - hi).abs()) / ulp
    clipped = torch.clamp(ratio, lo, hi)
    outside = (ratio - 1.0).abs() >= float(eps)
    tie = (ratio * adv_n == clipped * adv_n) & outside
    return {w: dist <= w for w in CLIP_EDGE_ULPS}, tie


def k4_clip_edge(torch, data, adv_stats, perm_all, params, opt, kw, label: str) -> dict:
    """K4 against its twin as it stands and, for each window of
    ``CLIP_EDGE_ULPS``, with the advantages of the samples on the clip
    edge set to their pass's shift (a normalised advantage of 0 in that
    pass), in both: the edge samples of the twin's run one pass at a time
    (:func:`clip_edges`), their counts and the ties', and the Adam moments
    and params outside MOMENT_TOL / UPDATE_TOL in each run.  A masked run's
    edges are recounted on its own trajectory and added, up to three
    times.  Prints and returns the counts; gates nothing."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_update as pu
    from reinmav_tpu_torch.rl import networks

    d, adim, tile = kw["d"], kw["adim"], kw["tile"]
    n_passes = kw["n_epochs"] * kw["n_minibatches"]
    tpm = perm_all.shape[0] // n_passes
    one = {**kw, "n_epochs": 1, "n_minibatches": 1}
    adv_row = d + adim + 2

    def edges(batch):
        """The twin's run one pass at a time: ``{window: {pass: edge
        columns}}`` and the counts by window."""
        net, state = params, opt
        found = {w: {} for w in CLIP_EDGE_ULPS}
        counts = {f"within_{w}_ulps": 0 for w in CLIP_EDGE_ULPS}
        counts["ties_outside"] = 0
        counts.update({f"value_{k}_{w}_ulps": 0 for k in ("clip", "tie") for w in CLIP_EDGE_ULPS})
        for q in range(n_passes):
            perm = perm_all[q * tpm:(q + 1) * tpm]
            cols = pl._gather_columns(perm, tile)
            ratio, value = twin_ratio(torch, batch, cols, net, d, adim)
            adv_n = (batch[adv_row, cols] - adv_stats[q, 0]) * adv_stats[q, 1]
            near, tie = clip_edges(torch, ratio, adv_n, kw["clip_eps"])
            for w, m in near.items():
                counts[f"within_{w}_ulps"] += int(m.sum())
                found[w][q] = cols[m]
            counts["ties_outside"] += int(tie.sum())
            vclip, vtie = value_edges(torch, value, batch[d + adim + 1, cols],
                                      batch[d + adim + 3, cols], kw["value_clip_eps"])
            for w in CLIP_EDGE_ULPS:
                counts[f"value_clip_{w}_ulps"] += int(vclip[w].sum())
                counts[f"value_tie_{w}_ulps"] += int(vtie[w].sum())
            net, state, _, _ = pu.ppo_update_reference(batch, adv_stats[q:q + 1], perm, net,
                                                       state, None, **one)
        return found, counts

    layout = networks.Layout(d, adim, (64, 64))

    def outside(batch):
        k = pu.ppo_update(batch, adv_stats, perm_all, params, opt, None, **kw)
        tw_params, tw_opt, _, _ = pu.ppo_update_reference(batch, adv_stats, perm_all, params,
                                                          opt, None, **kw)
        torch.cuda.synchronize()
        bad = ~torch.isclose(k.opt_state.mu, tw_opt.mu, **MOMENT_TOL)
        groups = {}
        for path, sl in layout.slices.items():
            groups[path[0]] = groups.get(path[0], 0) + int(bad[sl].sum())
        return {"params": count_outside(k.params, tw_params, UPDATE_TOL),
                "mu": count_outside(k.opt_state.mu, tw_opt.mu, MOMENT_TOL),
                "nu": count_outside(k.opt_state.nu, tw_opt.nu, MOMENT_TOL),
                "mu_max_abs_err": float((k.opt_state.mu - tw_opt.mu).abs().max()),
                "mu_by_group": {g: n for g, n in groups.items() if n}}

    found, counts = edges(data)
    result = {**counts, "outside_as_is": outside(data)}
    text = []
    for w in CLIP_EDGE_ULPS:
        masked, cols, rounds, now = data.clone(), set(), 0, found[w]
        while rounds < 3:
            new = [c for c in now.values() if not set(c.tolist()) <= cols]
            if rounds and not new:
                break
            for q, c in now.items():
                masked[adv_row, c] = adv_stats[q, 0]
                cols.update(c.tolist())
            rounds += 1
            now = edges(masked)[0][w]
        r = outside(masked)
        result[f"outside_masked_{w}_ulps"] = {**r, "samples": len(cols), "rounds": rounds}
        text.append(f"within {w} ulps ({len(cols)} samples, {rounds} rounds): {r['mu']} "
                    f"({r['mu_by_group']}), {r['nu']}, {r['params']} (max |err| "
                    f"{r['mu_max_abs_err']:.3e})")
    a = result["outside_as_is"]
    say(f"{label} clip edge (clip_eps {kw['clip_eps']:g}, {n_passes} passes of {tpm * tile} "
        f"samples, the twin's run one pass at a time): samples "
        + ", ".join(f"{v} {k.replace('_', ' ')}" for k, v in counts.items())
        + f"; K4 vs twin as it stands: {a['mu']} Adam first moments (by group "
        f"{a['mu_by_group']}), {a['nu']} second moments outside rtol 2e-4 atol 5e-8 (max |err| "
        f"{a['mu_max_abs_err']:.3e}), {a['params']} params outside rtol 2e-4 atol 1e-6; with "
        f"the advantages of the samples on the edge "
        f"set to their pass's shift, " + "; ".join(text))
    return result


def k4_phase(torch, dev, gpu: str, cfg, params, data, adv, tile: int, n_tiles: int,
             adim: int, clip_edge: str | None = None) -> dict:
    """Phase 10: K4 on the phase-7 trajectory, one 4 x 4 update from the
    rollout's own params (so pass 0's ratios are 1, as in training).
    ``clip_edge``: a label under which :func:`k4_clip_edge` counts the
    clip edge first (phase 13).  Returns K4's timings and errors for the
    ``kernels`` line."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_update as pu
    from reinmav_tpu_torch.rl import ppo

    n = data.shape[1]
    e_, m_ = cfg.num_epochs, cfg.num_minibatches
    n_passes, tpm = e_ * m_, n_tiles // m_
    d = data.shape[0] - adim - 4  # obs rows of the stacked batch
    perm_all, adv_stats, params, opt, kw = k4_setup(torch, dev, cfg, params, adv, tile, n_tiles,
                                                    d, adim)
    edge = (None if clip_edge is None else
            k4_clip_edge(torch, data, adv_stats, perm_all, params, opt, kw, clip_edge))
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
    # Beside the gate above: every pass resynchronised to the twin's state.
    resync = k4_resync(torch, data, adv_stats, perm_all, params, opt, kw, f"K4 obs {d} float32")
    say(f"K4 pass-0 gradient: bitwise equal to one K3 launch, max |err| {grad0_err:.3e} against "
        f"the twin's (rtol 2e-3 atol 2e-6); params and moments within tolerance of the twin; vs "
        f"the K3 loop max |err| {loop_err:.3e} (rtol 2e-4 atol 1e-6, moments atol 5e-8); metrics "
        f"{', '.join(f'{x} {float(v):.5g}' for x, v in k.metrics.items())} (rtol 1e-4 atol "
        f"1e-6 of the twin); bitwise equal on a rerun: ok")
    ms, plain_ms = statistics.median(kern0 + kern1), statistics.median(p0 + p1)
    bound_ms, bound_by = bound(
        nbytes(data, perm_all, adv_stats, params, opt.mu, opt.nu, k.params, k.opt_state.mu,
               k.opt_state.nu, k.grad0) + 4 * pu.N_METRIC_SUMS, OPS_LOSS[d] * mb * n_passes)
    registers = k4_registers(d, adim)
    say(f"time K4 obs {d}, {e_} x {m_} passes of {mb}: {ms:.4f} ms (median of 20 launches, each "
        f"{min(kern0 + kern1):.4f} to {max(kern0 + kern1):.4f}), twin {plain_ms:.3f} ms (median of "
        f"20), bound {bound_ms:.4f} ms by {bound_by}, ptxas ppo_update_kernel<{d}, {adim}, false, "
        f"false> {registers}, on {gpu}")
    return dict(max_abs_err=errs["params"][0], outside=errs["params"][1], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, registers=registers,
                at=f"{n_passes} passes of {mb} samples gathered in tiles of {tile} from {n}",
                resync=resync, **({} if edge is None else {"clip_edge": edge}))


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


def training_phase(torch, dev, gpu: str, env, cfg, label: str, updates: int | None = None,
                   **train_kw):
    """Drive 2 warm-up and 5 timed updates of ``train_step`` from seed 0
    (``updates`` in all, the first 2 the warm-up, when given), with every
    kernel count set to 0 just before; returns the launch counts, the walls
    and the summaries."""
    state = ppo_state(env, cfg, dev)
    counters = kernel_counters()
    from reinmav_tpu_torch.rl.ppo import train_step

    for fn in counters.values():
        fn.launches = 0
    walls, summaries = [], []
    for _ in range(WARMUP_UPDATES + TIMED_UPDATES if updates is None else updates):
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


def k6_states(torch, env, gen):
    """``make_states(train_state)`` of the fused PPO rollout's checks for
    env ``env`` (phases 7, 13, 21), drawn from ``gen``: quadrotor3d states
    twice as wide as a reset (the envs beyond |p| = 3 reset at once; no
    draw), hover states between z = 0.35 and 1, the native states at 1.5
    times a reset's spread."""
    if env.name == "quadrotor3d-v0":
        return lambda state: (state.env_states.T * 2.0).contiguous()
    if env.name == HOVER:
        return lambda state: hover_states(torch, gen, gen.device, B_PPO, 0.35, 1.0)
    return lambda state: native_states(torch, env, gen, B_PPO, 1.5)


def k2_inputs(torch, dev, env, make_states, ret_var: float = 4.0):
    """The fused PPO rollout's inputs at B_PPO x T_PPO for env ``env``:
    warmed normalisers (``ret_var`` the return normaliser's variance), a
    spread of running returns, log_std -0.5, the start states
    ``make_states(train_state)``.  Returns ``(cfg, layout, obs_norm,
    ret_norm, params, consts, k2_args, k2_kw)``."""
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.rl import networks, ppo

    d = env.obs_dim
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
    rets = torch.linspace(-1.0, 1.0, B_PPO, device=dev)
    k2_args = (make_states(state), rets, 21, params, consts, T_PPO)
    k2_kw = dict(params_vec=pr.env_params_vec(env), env_kind=env.name)
    return cfg, layout, obs_norm, ret_norm, params, consts, k2_args, k2_kw


#: The per-instance numbers that K2/K6's and K7's entries of the ``kernels``
#: line carry where their phase measured them.
EXTRA_KEYS = ("registers", "sass_per_env_step", "sm_clock_mhz", "issue_ms", "taut_share",
              "taut_share_twin", "occupancy")


def extras(numbers: dict) -> dict:
    return {k: numbers[k] for k in EXTRA_KEYS if k in numbers}


def k2_sass_line(label: str, name: str, ms: float, clock, gpu: str) -> dict:
    """Print K2/K6's instance for env ``name``: ptxas's registers, the
    instructions an env-step issues at most (sass_report), the issue time
    they imply at the SM clock sampled during the timed launches, against
    ``ms``; return them for the ``kernels`` line."""
    sass = ppo_sass(name)
    issue = cta_issue_ms(sass["per_env_step"], B_PPO, 128, T_PPO, clock.mhz)
    kernel = ppo_instance(name)
    registers = kernel_registers(kernel)
    say(f"{label}: {kernel}, ptxas {registers}; its horizon loop {sass['static']} static SASS "
        f"instructions, {sass['per_env_step']} an env-step without slow paths ({sass}), would "
        f"take {issue:.4f} ms to issue for B={B_PPO} T={T_PPO} at "
        f"{clock.mhz:.0f} MHz (the SM clock sampled during the timed launches; "
        f"{len(clock.samples)} samples; 2 warps a scheduler), against {ms:.4f} ms measured "
        f"({issue / ms:.3f} of the issue slots), on {gpu}")
    return {"registers": registers, "sass_per_env_step": sass, "sm_clock_mhz": clock.mhz,
            "issue_ms": issue}


#: Steps of the free-running taut counts of K6 (at B_PPO) and K7 (at B_OFF).
T_TAUT_K6, T_TAUT_K7 = 256, 200


def k6_taut(torch, env, k2_args, k2_kw, label: str) -> dict:
    """Phase 21's taut counts of a slung-load kind: K6's counting instance
    and the twin, free-running T_TAUT_K6 steps from phase 21's inputs; the
    shares of taut env-steps within 1 point of each other, the counting
    kernel's outputs bitwise the main path's."""
    from reinmav_tpu_torch.ops import ppo_rollout as pr

    args = (*k2_args[:5], T_TAUT_K6)
    n_k = torch.zeros(B_PPO, dtype=torch.int32, device=k2_args[0].device)
    n_p = torch.zeros_like(n_k)
    counted = pr.ppo_rollout(*args, counts=n_k, **k2_kw)
    main = pr.ppo_rollout(*args, **k2_kw)
    require(all(torch.equal(a, b) for a, b in zip(counted, main)),
            f"{label}: the counting kernel's outputs bitwise the main path's")
    del counted, main
    pr.ppo_rollout_reference(*args, counts=n_p, **k2_kw)
    share_k = float(n_k.double().sum()) / (B_PPO * T_TAUT_K6)
    share_p = float(n_p.double().sum()) / (B_PPO * T_TAUT_K6)
    require(abs(share_k - share_p) <= 0.01, f"{label}: taut share {share_k:.5f} vs the twin's "
                                            f"{share_p:.5f}")
    say(f"{label} counts, free-running B={B_PPO} T={T_TAUT_K6}: taut env-steps, kernel "
        f"{share_k:.6f} of all, twin {share_p:.6f} (within 1 point: ok); the counting kernel "
        f"bitwise the main path's outputs: ok")
    return {"taut_share": share_k, "taut_share_twin": share_p}


def k7_taut(torch, env, states_t, args_at, label: str) -> dict:
    """Phase 22's taut counts of a slung-load kind: K7's counting kernel
    and the twin, each free-running T_TAUT_K7 iterations on its own states
    from ``states_t`` (``args_at(states, seed)`` the collect_step arguments);
    the shares within 1 point, the counting kernel bitwise the main
    path's."""
    from reinmav_tpu_torch.ops import offpolicy as op

    batch = states_t.shape[1]
    n_k = torch.zeros(batch, dtype=torch.int32, device=states_t.device)
    n_p = torch.zeros_like(n_k)
    x_k = x_p = states_t
    for t in range(T_TAUT_K7):
        counted = op.collect_step(*args_at(x_k, 100 + t), counts=n_k)
        if t == 0:
            main = op.collect_step(*args_at(x_k, 100 + t))
            require(all(torch.equal(a, b) for a, b in zip(counted, main)),
                    f"{label}: the counting kernel's outputs bitwise the main path's")
        x_k = counted[0]
        x_p = op.collect_step_reference(*args_at(x_p, 100 + t), counts=n_p)[0]
    share_k = float(n_k.double().sum()) / (batch * T_TAUT_K7)
    share_p = float(n_p.double().sum()) / (batch * T_TAUT_K7)
    require(abs(share_k - share_p) <= 0.01, f"{label}: taut share {share_k:.5f} vs the twin's "
                                            f"{share_p:.5f}")
    say(f"{label} counts, free-running B={batch}, {T_TAUT_K7} iterations: taut env-steps, "
        f"kernel {share_k:.6f} of all, twin {share_p:.6f} (within 1 point: ok); the counting "
        f"kernel bitwise the main path's: ok")
    return {"taut_share": share_k, "taut_share_twin": share_p}


def fused_kernel_checks(torch, dev, gpu: str, env, make_states, names,
                        ret_var: float = 4.0, clip_edge: bool = False) -> tuple[dict, dict, dict]:
    """Phases 7, 8 and 10 (quadrotor3d-v0) or 13 (the hover task): the
    fused PPO rollout kernel (K2 or K6-hover) against its twin at 32,768 x
    32 with noise and resets on, K3 against its twin on one full minibatch
    of that trajectory, K4 against its twin over one update on it.
    ``make_states(state)`` gives the rollout's ``(D, B)`` start states,
    ``names`` the labels of the three kernels, ``ret_var`` the return
    normaliser's variance (a warmed one, of the env's reward scale),
    ``clip_edge`` whether K4's clip edge is counted (:func:`k4_clip_edge`).
    Returns each kernel's numbers for the ``kernels`` line."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.rl import networks, ppo

    k2_name, k3_name, k4_name = names
    d = env.obs_dim
    cfg, layout, obs_norm, ret_norm, params, consts, k2_args, k2_kw = k2_inputs(
        torch, dev, env, make_states, ret_var)
    states_t, rets = k2_args[:2]
    k2_run = lambda: pr.ppo_rollout(*k2_args, **k2_kw)  # noqa: E731
    k2_plain = lambda: pr.ppo_rollout_reference(*k2_args, **k2_kw)  # noqa: E731
    k2_run()  # warm-up
    pr.ppo_rollout_reference(states_t, rets, 21, params, consts, 2, **k2_kw)  # warm-up
    torch.cuda.synchronize()
    (plain0,), ref = cuda_ms(k2_plain, 1)
    with SmClock() as clock:
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
    sass = k2_sass_line(k2_name, env.name, k2_ms, clock, gpu)
    say(f"sha256 {k2_name} B={B_PPO} T={T_PPO} (seed 21): {digest(*out)}")
    rollout = dict(max_abs_err=k2_err, mismatched=mismatched, ms=k2_ms, plain_ms=k2_plain_ms,
                   bound_ms=k2_bound, bound_by=k2_by,
                   at=f"states ({env.obs_dim}, {B_PPO}), horizon {T_PPO}", **sass)
    if env.name in TETHER:
        rollout.update(k6_taut(torch, env, k2_args, k2_kw, k2_name))

    # K3 against its twin on one full minibatch of that trajectory, with
    # the params moved off the rollout's, so that ratios leave 1 and clip.
    n = B_PPO * T_PPO
    data, adv, tile, n_tiles = k4_batch(torch, cfg, layout, obs_norm, params, out)
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
    update = k4_phase(torch, dev, gpu, cfg, params, data, adv, tile, n_tiles, env.action_dim,
                      clip_edge=f"{k4_name}, input 1" if clip_edge else None)
    del out, ref, again, data, adv
    torch.cuda.empty_cache()
    return rollout, loss, update


def k4_batch(torch, cfg, layout, obs_norm, params, out):
    """K3's and K4's batch from a fused PPO rollout ``out`` at B_PPO x
    T_PPO: GAE from the rollout's params, the ``(D + A + 4, n)`` rows, the
    advantages and the shuffle tiling.  Returns ``(data, adv, tile,
    n_tiles)``."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.rl import networks, ppo

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
    return data, adv, tile, n_tiles


def ppo_phases(torch, dev, gpu: str, env) -> list[dict]:
    """Phases 7-11: K2, K3 and K4 against their twins at the training
    path's shapes, the K3-loop training path, the default (K4) training
    path and the CLI.  Returns the three kernels' entries of the
    ``kernels`` line."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.rl import ppo

    # 7, 8 and 10.
    cfg = ppo.PpoConfig(num_envs=B_PPO, rollout_len=T_PPO, fused_update="off")
    k2, k3, k4 = fused_kernel_checks(torch, dev, gpu, env, k6_states(torch, env, None),
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
        **extras(k2),
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


def k4_on_hover_states(torch, dev, gpu: str, env, make_states, label: str) -> dict:
    """K4 at obs 13 against its twin (phase 10's gates, the clip edge
    counted) on K6-hover's trajectory at B_PPO x T_PPO from
    ``make_states(state)``, as phase 13 builds its batch."""
    from reinmav_tpu_torch.ops import ppo_rollout as pr

    cfg, layout, obs_norm, _, params, _, k2_args, k2_kw = k2_inputs(
        torch, dev, env, make_states, HOVER_RET_VAR)
    out = pr.ppo_rollout(*k2_args, **k2_kw)
    data, adv, tile, n_tiles = k4_batch(torch, cfg, layout, obs_norm, params, out)
    del out
    return k4_phase(torch, dev, gpu, cfg, params, data, adv, tile, n_tiles, env.action_dim,
                    clip_edge=label)


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
    with SmClock() as clock:
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
    k5_sass = substep_sass("hover_rollout_kernel")
    k5_issue = issue_ms(k5_sass["total"], B_MAIN * T_MAIN * HOVER_FRAME_SKIP, clock.mhz)
    say(f"K5's substep loop, {k5_sass['total']} static SASS instructions ({k5_sass}), would "
        f"take {k5_issue:.3f} ms to issue for B={B_MAIN} T={T_MAIN} at {clock.mhz:.0f} MHz (the "
        f"SM clock sampled during the timed launches; {len(clock.samples)} samples), against "
        f"{k5_ms:.3f} ms measured, on {gpu}")
    at_k5 = f"states {tuple(f_k.shape)}, horizon {T_MAIN}, zero action"
    del big_t, f_k, f_p, r_k, r_p
    torch.cuda.empty_cache()

    # 13. K6-hover, K3 and K4 at obs 13, from states between z = 0.35 and 1.
    # The hover reward is about 98 a step against quadrotor3d's -1.4, so
    # the return normaliser's variance is scaled by (98 / 1.4)^2 from
    # phase 7's 4.0: normalised rewards of quadrotor3d's size, not all
    # clipped at 10 as an unwarmed normaliser would leave them.
    k6, k3, k4 = fused_kernel_checks(
        torch, dev, gpu, env, k6_states(torch, env, gen),
        ("K6-hover", "K3 (obs 13)", "K4 (obs 13)"), ret_var=HOVER_RET_VAR, clip_edge=True)
    # K4 at obs 13 on a second input: K6-hover's trajectory from hover
    # states of a generator of their own, over a wider z range.
    seed2, z_lo, z_hi = K4_SECOND_INPUTS[0]
    gen2 = torch.Generator(device=dev).manual_seed(seed2)
    k4_second = k4_on_hover_states(
        torch, dev, gpu, env, lambda state: hover_states(torch, gen2, dev, B_PPO, z_lo, z_hi),
        f"K4 (obs 13), input 2 (seed {seed2}, z in [{z_lo:g}, {z_hi:g}])")
    k4["second_input"] = {k: k4_second[k] for k in ("max_abs_err", "outside", "clip_edge")}

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
              "envs that agree", {"mismatched_envs": k5_mismatched,
                                  "registers": kernel_registers("hover_rollout_kernel"),
                                  "sass_per_substep": k5_sass, "sm_clock_mhz": clock.mhz,
                                  "issue_ms": k5_issue}),
        entry("ppo_rollout (MujocoQuadForce-v1, K6-hover)", "reinmav_tpu_torch/csrc/ppo_rollout.cu",
              "reinmav_tpu/ops/pallas_ppo_rollout.py:703", main_launches["K2"], k6,
              "rtol 2e-4 atol 2e-5 per env over its whole trajectory, <= 0.1% of envs may "
              "differ; max_abs_err over the envs that agree",
              {"mismatched_envs": k6["mismatched"], **extras(k6)}),
        entry("ppo_loss_grads_gather (obs 13)", "reinmav_tpu_torch/csrc/ppo_loss.cu",
              "reinmav_tpu/ops/pallas_ppo.py:424", loop_launches["K3"],
              {**k3, "at": f"{k3['at']}; launches on the hover fused_update=\"off\" path"},
              "grads rtol 2e-3 atol 2e-6, metrics rtol 2e-4 atol 1e-6, bitwise repeatable"),
        entry("ppo_update (obs 13)", "reinmav_tpu_torch/csrc/ppo_update.cu",
              "reinmav_tpu/ops/pallas_ppo_update.py:304", main_launches["K4"], k4,
              "params rtol 2e-4 atol 1e-6, moments rtol 2e-4 atol 5e-8 of the twin and of the K3 "
              "loop; pass-0 gradient bitwise K3's; bitwise repeatable; on two inputs",
              {"entries_outside_rtol_2e-4_atol_1e-6": k4["outside"],
               "clip_edge": k4["clip_edge"], "second_input": k4["second_input"]}),
    ]


def _fork(torch, state):
    """An independent copy of an off-policy state: the ring is updated in
    place and the generator advances, so two runs from one state need two."""
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    return state._replace(buffer=state.buffer.clone(), generator=gen)


def k7_states(torch, env, gen, batch: int = B_OFF):
    """K7's start states ``(D, B)`` for env ``env`` (phases 15 and 22,
    ``--only hashes``), from ``gen``: perturbed hover states, the first 1%
    just above the z = 0.3 floor and falling (they end at once);
    quadrotor3d states twice a reset's spread (the envs past |p| = 3 end at
    once); :func:`native_states` for the other kinds."""
    if env.name == HOVER:
        s = hover_states(torch, gen, gen.device, batch, 0.35, 1.0)
        s[2, :batch // 100], s[9, :batch // 100] = 0.302, -1.0
        return s
    if env.name == "quadrotor3d-v0":
        return (env.vreset(gen, batch).T * 2.0).contiguous()
    return native_states(torch, env, gen, batch)


def k7_args(torch, env, states_t, mode: str, warm: float, noise: float, hidden=(H_SAC, H_SAC),
            seed: int = 15):
    """``collect_step``'s arguments for one leg: a perturbed actor of
    ``hidden`` widths (init seed 31, off its 0.01 head init by 0.05 N(0, 1)
    of seed 32, so that the actions spread over [-1, 1]), the consts of
    ``warm`` and ``noise``, the env's default params."""
    from reinmav_tpu_torch.ops import offpolicy as op
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.rl import sac

    dev = states_t.device
    a = env.action_dim
    layout = sac.MlpLayout((env.obs_dim, *hidden, 2 * a if mode.startswith("sac") else a))
    flat = sac.init_mlp(layout, torch.Generator().manual_seed(31)).to(dev)
    flat = flat + 0.05 * torch.randn(flat.shape, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(32))
    consts = sac.collect_consts(env, torch.tensor(warm > 0.5, device=dev), noise)
    return (env.name, mode, states_t, seed, consts, pr.env_params_vec(env),
            *op.actor_kernel_args(layout.layers(flat)))


def k7_bound(states_t, args, new, block) -> tuple[float, str, int]:
    """K7's bound for one launch: its inputs read once, its outputs written
    once, the actor's products and the env step's operations; returns
    ``(ms, what bounds it, operations per env)``."""
    d = states_t.shape[0]
    w1, _, w2, _, w3, _ = args[6:]
    h1, h2, out = w1.shape[1], w2.shape[1], w3.shape[1]
    ops_per_env = 2 * (d * h1 + h1 * h2 + h2 * out) + OPS_ENV_STEP[d]
    ms, by = bound(nbytes(states_t, new, block, args[4], *args[6:]),
                   ops_per_env * states_t.shape[1])
    return ms, by, ops_per_env


def k7_timed(torch, args, reps: int = 20):
    """K7 timed on ``args``: the median and range of ``reps`` launches
    after a warm-up, and the outputs."""
    from reinmav_tpu_torch.ops import offpolicy as op

    op.collect_step(*args)
    torch.cuda.synchronize()
    ms, out = cuda_ms(lambda: op.collect_step(*args), reps)
    return statistics.median(ms), min(ms), max(ms), out


def k7_instance(name: str, mode: str, count: bool = False, bf16: bool = False) -> str | None:
    """The demangled name of K7's instance for env ``name`` and ``mode``
    in the library this run built (the counting kernel's with ``count``,
    the bf16 instance with ``bf16``)."""
    from reinmav_tpu_torch.ops import offpolicy as op

    head = "offpolicy_collect_count_kernel<" if count else "offpolicy_collect_kernel<"
    tails = ((f",{op.MODES[mode]}>",) if count else
             (f",{op.MODES[mode]},{'true' if bf16 else 'false'}>",) if bf16 else
             (f",{op.MODES[mode]}>", f",{op.MODES[mode]},false>"))
    found = [k for k in _sass_counts() if k.startswith(head) and PPO_STRUCT[name] in k
             and k.replace(" ", "").endswith(tails)]
    return found[0] if len(found) == 1 else None


def k7_occupancy(env, mode: str, hidden=(H_SAC, H_SAC)) -> str:
    """K7's resident CTAs an SM and dynamic shared memory for a launch of
    env ``env``, ``mode`` and ``hidden`` widths, from the library's
    occupancy query (``offpolicy_collect_occupancy``), or "not reported"
    for a library without it."""
    import ctypes

    from reinmav_tpu_torch import _build
    from reinmav_tpu_torch.ops import offpolicy as op
    from reinmav_tpu_torch.ops import ppo_rollout as pr

    lib = _build.load_library()
    if not hasattr(lib, "offpolicy_collect_occupancy"):
        return "not reported by this library"
    ctas, smem = ctypes.c_int(), ctypes.c_longlong()
    rc = lib.offpolicy_collect_occupancy(pr.ENVS[env.name].kind_id, op.MODES[mode], *hidden,
                                         ctypes.byref(ctas), ctypes.byref(smem))
    _build.check(rc, "offpolicy_collect_occupancy")
    return f"{ctas.value} CTAs an SM, {smem.value} B of dynamic shared memory a CTA"


def k7_phase(torch, dev, gpu: str, env, states_t, timed_mode: str) -> dict:
    """Phase 15 for one kind: K7 against its twin at B_OFF envs and H_SAC
    wide, in every mode leg of K7_MODES, counting the envs whose block or
    new state leaves TOL; a rerun bitwise equal; then K7 and its twin
    timed in ``timed_mode`` (the mode the kind's training path runs), in
    turns.  Returns K7's numbers for the ``kernels`` line."""
    from reinmav_tpu_torch.ops import offpolicy as op

    d, a = env.obs_dim, env.action_dim
    batch = states_t.shape[1]
    errs, mismatches, timed = [], [], None
    for mode, warm, noise in K7_MODES:
        args = k7_args(torch, env, states_t, mode, warm, noise)
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
            timed = args, (new_k, blk_k)

    args, (new_k, blk_k) = timed
    out = args[-1].shape[0]
    taut = k7_taut(torch, env, states_t, lambda x, seed: (*args[:2], x, seed, *args[4:]),
                   f"K7 {env.name}") if env.name in TETHER else {}
    kernel_run = lambda: op.collect_step(*args)  # noqa: E731
    plain_run = lambda: op.collect_step_reference(*args)  # noqa: E731
    kernel_run()
    plain_run()  # warm-ups
    torch.cuda.synchronize()
    p0, _ = cuda_ms(plain_run, 3)
    with SmClock() as clock:
        kern0, _ = cuda_ms(kernel_run, 10)
        kern1, _ = cuda_ms(kernel_run, 10)
    p1, _ = cuda_ms(plain_run, 3)
    ms, plain_ms = statistics.median(kern0 + kern1), statistics.median(p0 + p1)
    bound_ms, bound_by, ops_per_env = k7_bound(states_t, args, new_k, blk_k)
    instance = k7_instance(env.name, timed_mode)
    registers = "not reported" if instance is None else kernel_registers(instance)
    occupancy = k7_occupancy(env, timed_mode)
    say(f"time K7 {env.name} {timed_mode}, B={batch} H={H_SAC}: {ms:.4f} ms (median of 20 "
        f"launches, each {min(kern0 + kern1):.4f} to {max(kern0 + kern1):.4f}, SM clock "
        f"{clock.mhz:.0f} MHz), twin {plain_ms:.3f} ms (median of 6), bound {bound_ms:.4f} ms by "
        f"{bound_by} ({ops_per_env} operations per env); {instance}: ptxas {registers}; "
        f"{occupancy}; on {gpu}")
    return dict(max_abs_err=max(errs), mismatched=max(mismatches), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, registers=registers,
                sm_clock_mhz=clock.mhz, occupancy=occupancy,
                at=f"states ({d}, {batch}), actor {d}-{H_SAC}-{H_SAC}-{out}, mode {timed_mode}",
                **taut)


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
    k7_hover = k7_phase(torch, dev, gpu, hover, k7_states(torch, hover, gen), "sac")
    k7_quad = k7_phase(torch, dev, gpu, quad, k7_states(torch, quad, gen), "td3")

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
                "library_ms": None, "at": f"{numbers['at']}; launches on {path}",
                **extras(numbers)}

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
    with SmClock() as clock:
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

    # The same free run with the per-env counts: taut env-steps (the slung
    # kinds) or done env-steps, the resets (quad2d), in kernel and twin.
    n_k = torch.empty(B_MAIN, dtype=torch.int32, device=dev)
    n_p = torch.empty_like(n_k)
    counted = cl.closed_loop_rollout(name, big_t, 7, T_MAIN, counts=n_k)
    require(torch.equal(counted[0], f_k) and torch.equal(counted[1], r_k),
            f"{name}: the counting kernel's states and rewards bitwise the main path's")
    del counted
    cl.closed_loop_rollout_reference(name, big_t, 7, T_MAIN, counts=n_p)
    share_k = float(n_k.double().sum()) / (B_MAIN * T_MAIN)
    share_p = float(n_p.double().sum()) / (B_MAIN * T_MAIN)
    what = "taut" if name in TETHER else "done (reset)"
    if name in TETHER:
        require(abs(share_k - share_p) <= 0.01,
                f"{name}: taut share {share_k:.5f} vs the twin's {share_p:.5f}")
    say(f"K8/K9 {name} counts, free-running B={B_MAIN} T={T_MAIN}: {what} env-steps, kernel "
        f"{share_k:.6f} of all, twin {share_p:.6f}"
        f"{' (within 1 point: ok)' if name in TETHER else ''}; the counting kernel bitwise the "
        f"main path's states and rewards: ok")
    del n_k, n_p

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
    sass = horizon_sass(name)
    issue = issue_ms(sass["step"], B_MAIN * T_MAIN, clock.mhz)
    kernel = closed_loop_kernel_name(name)
    registers = kernel_registers(kernel)
    say(f"K8/K9 {name}: {kernel}, ptxas {registers}; its horizon loop, {sass['step']} static "
        f"SASS instructions an env-step without the reset block ({sass}), would take "
        f"{issue:.3f} ms to issue for B={B_MAIN} T={T_MAIN} at {clock.mhz:.0f} MHz (the SM clock "
        f"sampled during the timed launches; {len(clock.samples)} samples), against {ms:.3f} ms "
        f"measured, on {gpu}")
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
            "library_ms": None, "at": f"states ({d}, {B_MAIN}), horizon {T_MAIN}, auto-reset",
            "registers": registers, "sass_per_env_step": sass, "sm_clock_mhz": clock.mhz,
            "issue_ms": issue, f"{what.split()[0]}_share": share_k,
            f"{what.split()[0]}_share_twin": share_p}


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
            torch, dev, gpu, env, k6_states(torch, env, gen),
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
        k7 = k7_phase(torch, dev, gpu, env, k7_states(torch, env, gen), "sac")
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
                  {"free_running_envs_apart": k6["mismatched"], **extras(k6)}),
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
                  {"mismatched_envs": k7["mismatched"], "td3_launches": k7_launches["td3"],
                   **extras(k7)}),
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


def euler_operands(torch, gen, n: int):
    """(a, b, cphi) for K10's Euler angle: n magnitudes 2^-70 to 2^70 of
    either sign, n of the physical range (|a|, |b| <= 1, cphi in (0, 1]),
    and every triple of zeros, infinities, NaN, subnormals and the ends of
    the kernel's straight-line range with their neighbours."""
    dev = gen.device

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    def wide():
        sign = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        return sign * torch.exp2(u(-70.0, 70.0))

    lo, hi = torch.tensor([2.0 ** -60, 2.0 ** 60], device=dev)
    special = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1e-40, -1e-40, 1.0, -1.0],
                           device=dev)
    special = torch.cat([special, torch.stack([lo, hi, torch.nextafter(lo, torch.zeros_like(lo)),
                                               torch.nextafter(hi, torch.full_like(hi, math.inf))])])
    grid = torch.cartesian_prod(special, special, special)
    return tuple(torch.cat([wide(), u(*rng), grid[:, k]])
                 for k, rng in enumerate(((-1.0, 1.0), (-1.0, 1.0), (0.0, 1.0))))


def reinmav_phase(torch, dev, gpu: str) -> dict:
    """Phase 24: K10.  throughput_rollout(make("reinmav-v0")) through the
    public API at B_SWEEP x T_SWEEP and at B_REINMAV x T_SWEEP must launch K10
    once each, with reward sums exactly 90 T_SWEEP and the time T_SWEEP steps
    of dt on; K10 against its twin free-running at B_SWEEP and at B_REINMAV x
    T_K10_CHECK in every layout (lanes_per_env 1, 2): bit for bit the
    twin's states and every step's substep count, a bitwise rerun; its
    straight-line atan2f and divisions bit for bit the library's on wide,
    physical and special operands; the counts over T_SWEEP steps from
    random times equal to the float32 recurrence's; every layout timed at
    each batch of B_K10_LAYOUTS from the main path's states, the twin at
    B_SWEEP.
    Returns K10's entry of the ``kernels`` line."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import reinmav_rollout as rr

    env = reinmav_tpu_torch.make("reinmav-v0")
    gen = torch.Generator(device=dev).manual_seed(24)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counters = kernel_counters()
    t_end = torch.zeros((), device=dev)
    for _ in range(T_SWEEP):
        t_end = t_end + torch.tensor(env.params.dt, device=dev)
    main_launches, main_states, chosen = {}, {}, {}
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
        main_states[batch] = states.T.contiguous()
        chosen[batch] = rr.lanes_per_env_for(batch, sms)
        dist = float((final[:, 0:3] - 1.0).norm(dim=1).mean())
        say(f"throughput_rollout(reinmav-v0) B={batch} T={T_SWEEP} backend=auto: K10 launches "
            f"{launches['K10']} (lanes_per_env {chosen[batch]} on {sms} SMs), reward sums "
            f"{float(reward_sum[0]):.1f} in every env, time {float(final[0, 13]):.6f}, mean "
            f"distance to the trajectory's end (1, 1, 1) {dist:.4f}: ok")
    del final, reward_sum, states

    # K10 against its twin, free-running, in every layout, at both batches.
    check = {}
    for batch in (B_SWEEP, B_REINMAV):
        x = reinmav_states(torch, gen, batch)
        plain_check = lambda: rr.reinmav_rollout_reference(  # noqa: E731
            x, T_K10_CHECK, record_substeps=True)
        (plain0,), (f_p, n_p) = cuda_ms(plain_check, 1)
        for lanes in rr.LANES_PER_ENV:
            f_k, n_k = rr.reinmav_rollout(x, T_K10_CHECK, record_substeps=True,
                                          lanes_per_env=lanes)
            err = float((f_k - f_p).abs().max())
            require(torch.equal(n_k, n_p), f"K10 lanes_per_env={lanes} B={batch}: counts")
            require(err <= 1e-3, f"K10 lanes_per_env={lanes} B={batch}: max |err| {err}")
            require(torch.equal(f_k.view(torch.int32), f_p.view(torch.int32)),
                    f"K10 lanes_per_env={lanes} B={batch}: not the twin's bits")
            again = rr.reinmav_rollout(x, T_K10_CHECK, record_substeps=True, lanes_per_env=lanes)
            require(torch.equal(f_k, again[0]) and torch.equal(n_k, again[1]),
                    f"K10 lanes_per_env={lanes} B={batch}: bitwise rerun")
        outside = int((~torch.isclose(f_k, f_p, **TOL).all(dim=0)).sum())
        check[batch] = dict(x=x, plain=plain_check, plain0=plain0, err=err, outside=outside)
        say(f"K10 vs twin, free-running B={batch} T={T_K10_CHECK} from t = 0, lanes_per_env "
            f"{', '.join(map(str, rr.LANES_PER_ENV))}: bit for bit the twin's states and every "
            f"step's substep count ({int((n_k == 51).sum())} env-steps of 51), max |err| "
            f"{err:.3e} (limit 1e-3); bitwise equal on a rerun: ok")
        del f_k, f_p, n_k, n_p, again
    a, b, cphi = euler_operands(torch, gen, 1 << 22)
    psi, library = rr.euler_angle_check(a, b, cphi)
    same = int((psi.view(torch.int32) == library.view(torch.int32)).sum())
    require(same == a.numel(), f"K10's Euler angle: {same} of {a.numel()} operand triples are "
                               f"atan2f's bits")
    say(f"K10's straight-line atan2f and divisions: {same} of {a.numel()} operand triples (wide, "
        f"physical, special) bit for bit the library's: ok")
    del a, b, cphi, psi, library
    x_long = reinmav_states(torch, gen, B_REINMAV, t_hi=4.0)
    x_long[13, : B_REINMAV // 2] = 0.0
    _, n_long = rr.reinmav_rollout(x_long, T_SWEEP, record_substeps=True)
    require(torch.equal(n_long, rr.substep_counts(x_long[13], T_SWEEP)),
            "K10's counts over the horizon are the float32 recurrence's")
    fifty_one = int((n_long[:400, 0] == 51).sum())
    require(fifty_one == 14, f"14 x 51 substeps in 400 steps from t = 0, got {fifty_one}")
    say(f"K10 B={B_REINMAV} T={T_SWEEP} from times in [0, 4]: counts equal to the float32 "
        f"recurrence's, 14 x 51 in the first 400 steps from t = 0: ok")

    # Every layout timed at each batch of B_K10_LAYOUTS (the main path's
    # states: every env at the init state), in two rounds.
    for batch in B_K10_LAYOUTS:
        if batch not in main_states:
            main_states[batch] = env.vreset(gen, batch).T.contiguous()
            chosen[batch] = rr.lanes_per_env_for(batch, sms)
    times = {(b, lanes): [] for b in B_K10_LAYOUTS for lanes in rr.LANES_PER_ENV}
    with SmClock() as clock:
        for _ in range(2):
            for (batch, lanes), samples in times.items():
                run = lambda: rr.reinmav_rollout(main_states[batch], T_SWEEP,  # noqa: E731
                                                 lanes_per_env=lanes)
                run()
                samples += cuda_ms(run, 5)[0]
    ms_by = {(b, lanes): statistics.median(v) for (b, lanes), v in times.items()}
    sass = {name: substep_sass(name) for name in K10_KERNELS}
    ms, small_ms = ms_by[(B_SWEEP, chosen[B_SWEEP])], ms_by[(B_REINMAV, chosen[B_REINMAV])]
    c = check[B_SWEEP]
    kernel_check = lambda: rr.reinmav_rollout(c["x"], T_K10_CHECK)  # noqa: E731
    check_ms = statistics.median(cuda_ms(kernel_check, 5)[0])
    (plain1,), _ = cuda_ms(c["plain"], 1)
    plain_ms = (c["plain0"] + plain1) / 2
    big_t = main_states[B_SWEEP]
    substeps = int(rr.substep_counts(big_t[13], T_SWEEP).sum(dtype=torch.int64))
    bound_ms, bound_by = bound(2 * nbytes(big_t), OPS_K10_SUBSTEP * substeps)
    small_t = main_states[B_REINMAV]
    small_substeps = int(rr.substep_counts(small_t[13], T_SWEEP).sum(dtype=torch.int64))
    small_bound, _ = bound(2 * nbytes(small_t), OPS_K10_SUBSTEP * small_substeps)
    issue = {}
    for batch in B_K10_LAYOUTS:
        n_sub = int(rr.substep_counts(main_states[batch][13], T_SWEEP).sum(dtype=torch.int64))
        issue[batch] = issue_ms(sass["reinmav_rollout_kernel"]["total"], n_sub, clock.mhz)
        say(f"time K10 B={batch} T={T_SWEEP} by lanes_per_env: " + ", ".join(
            f"{lanes}: {ms_by[(batch, lanes)]:.3f} ms (each {min(times[(batch, lanes)]):.3f} to "
            f"{max(times[(batch, lanes)]):.3f})" for lanes in rr.LANES_PER_ENV) +
            f"; medians of 10; the dispatch takes {chosen[batch]}; one env a thread's substep "
            f"loop, {sass['reinmav_rollout_kernel']['total']} static SASS instructions, would "
            f"take {issue[batch]:.3f} ms to issue ({n_sub} substeps) at {clock.mhz:.0f} MHz (the "
            f"SM clock sampled during the timed launches); on {gpu}")
    say(f"K10's substep loops (static SASS; the 2-warp loop holds both warps' parts, each warp "
        f"running its own): {sass}")
    say(f"time K10 B={B_SWEEP} T={T_SWEEP}: {ms:.3f} ms, {B_SWEEP * T_SWEEP / ms * 1e3:.4e} "
        f"env-steps/s; bound {bound_ms:.3f} ms by {bound_by} ({substeps} substeps of "
        f"{OPS_K10_SUBSTEP} operations); at B={B_SWEEP} T={T_K10_CHECK}: K10 {check_ms:.3f} ms "
        f"(median of 5), twin {plain_ms:.1f} ms (runs {c['plain0']:.1f}, {plain1:.1f}), so the "
        f"twin at T={T_SWEEP} would take about {plain_ms * T_SWEEP / T_K10_CHECK:.0f} ms (an "
        f"estimate, scaled, not measured); at B={B_REINMAV} T={T_SWEEP}: K10 {small_ms:.3f} ms, "
        f"bound {small_bound:.3f} ms ({small_substeps} substeps); on {gpu}")
    err, outside = c["err"], c["outside"]
    del big_t, small_t, x_long, main_states, check, c
    torch.cuda.empty_cache()
    return {"name": "reinmav_rollout (reinmav-v0, K10)", "route": "cuda",
            "source": "reinmav_tpu_torch/csrc/reinmav_rollout.cu",
            "replaces": "reinmav_tpu/ops/pallas_reinmav.py:245",
            "launches": main_launches[B_SWEEP], "launches_at_8192": main_launches[B_REINMAV],
            "max_abs_err": err, "envs_outside_rtol_2e-4_atol_2e-5": outside,
            "tolerance": f"bit for bit the twin's states and substep counts free-running over "
                         f"{T_K10_CHECK} steps at B={B_SWEEP} and B={B_REINMAV}, every layout",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "plain_at": f"states (14, {B_SWEEP}), horizon {T_K10_CHECK}",
            "ms_at_plain_shape": check_ms, "ms_at_8192": small_ms,
            "bound_ms_at_8192": small_bound,
            "lanes_per_env": {str(b): chosen[b] for b in B_K10_LAYOUTS},
            "ms_by_lanes_per_env": {str(b): {str(lanes): ms_by[(b, lanes)]
                                             for lanes in rr.LANES_PER_ENV}
                                    for b in B_K10_LAYOUTS},
            "registers": {name: kernel_registers(name) for name in K10_KERNELS},
            "sass_per_substep": sass, "sm_clock_mhz": clock.mhz,
            "issue_ms_one_env_a_thread": {str(b): issue[b] for b in B_K10_LAYOUTS},
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
    z_apart = int(not_same_bits(torch, z_k, z_p).sum())
    require(z_apart == 0 and float(f_k[2].min()) > -0.1,
            f"{name} free-running: {z_apart} envs' Σz not the twin's bits (mean rel err "
            f"{z_rel}), min z {float(f_k[2].min())}")
    again = cr.contact_rollout(y, T_K11_FREE, params_vec=vec)
    require(torch.equal(f_k, again[0]) and torch.equal(z_k, again[1]), f"{name}: bitwise rerun")
    say(f"K11 {name} free-running B={B_K11_FREE} T={T_K11_FREE}: mean Σz {float(z_k.mean()):.6f}, "
        f"twin {float(z_p.mean()):.6f}, every env's Σz bit for bit the twin's, min z "
        f"{float(f_k[2].min()):.5f} (> -0.1), {apart} envs apart at rtol 2e-4 atol 2e-5 "
        f"(reported); bitwise equal on a rerun: ok")

    pairs = contact_pairs(torch, gen, vec, name)

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
            "pairing_check_envs": pairs, "registers": kernel_registers("contact_rollout_kernel"),
            "tier_mix": mix, "tiers_gated_ms": gated_ms, "tiers_forced48_ms": forced_ms,
            "tolerance": f"rtol 2e-4 atol 2e-5 per env over {T_K11_RESYNC} steps resynchronised "
                         f"at B={B_SWEEP}, 0 envs outside off the knife edges; max_abs_err there",
            "ms": ms, "plain_ms": plain_step, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "plain_at": f"contact-heavy states (13, {B_SWEEP}), horizon 1, zero action",
            "ms_at_plain_shape": kernel_step,
            "at": f"states (13, {B_SWEEP}), horizon {T_SWEEP}, zero action; plain_ms at plain_at"}


def contact_pairs(torch, gen, vec, name: str) -> int:
    """Phase 25's pairing check of K11's two envs a warp: envs with no
    contact (in flight), on the 16-candidate tier (nearly level, low) and on
    the 48 (an arm corner below the plane in the first substep), in every
    ordered pair of warp neighbours (envs 2i and 2i + 1), and odd batches of
    1, 3 and 4097 (a half-warp without an env), over T_K11_PAIRS steps:
    states and Σz bit for bit the twin's (+0 and -0 counted equal), tier
    counts equal.  Returns the number of envs checked."""
    from reinmav_tpu_torch.ops import contact_rollout as cr

    fly = contact_states(torch, gen, 64)
    fly[2] += 1.0
    level = contact_states(torch, gen, 64, tilt=0.02, z_lo=0.015)
    pool = contact_states(torch, gen, 8192)
    _, _, first = cr.contact_rollout_reference(pool, 1, params_vec=vec, frame_skip=1,
                                               record_tiers=True)
    wide = pool[:, first[:, 2] == 1][:, :64]
    require(wide.shape[1] == 64, f"{name} pairing: {wide.shape[1]} envs on the 48 tier")
    kinds = (fly, level, wide)
    used, cols = [0, 0, 0], []
    for _ in range(7):
        for a in range(3):
            for b in range(3):
                for k in (a, b):
                    cols.append(kinds[k][:, used[k]])
                    used[k] += 1
    paired = torch.stack(cols, dim=1)
    # The odd batches end on an env in contact alone in its warp.
    alone = wide[:, -1:]
    three = torch.stack([level[:, -1], wide[:, -2], wide[:, -3]], dim=1)
    checked, mixes = 0, []
    for x in (paired, alone, three, pool[:, :4097]):
        x = x.contiguous()
        f_k, z_k, t_k = cr.contact_rollout(x, T_K11_PAIRS, params_vec=vec, record_tiers=True)
        f_p, z_p, t_p = cr.contact_rollout_reference(x, T_K11_PAIRS, params_vec=vec,
                                                     record_tiers=True)
        bits = (not_same_bits(torch, f_k, f_p).any(dim=0) | not_same_bits(torch, z_k, z_p)
                | (t_k != t_p).any(dim=1))
        require(not bool(bits.any()), f"{name} pairing, batch {x.shape[1]}: "
                                      f"{int(bits.sum())} envs not the twin's bits")
        checked += x.shape[1]
        mixes.append(t_k.sum(dim=0).tolist())
    say(f"K11 {name} pairing, {T_K11_PAIRS} steps: {paired.shape[1]} envs in every ordered pair "
        f"of no contact / 16 / 48 candidates, and batches of 1, 3 and 4097, bit for bit the "
        f"twin's (states, Σz; +0 and -0 counted equal), tier counts equal (mixes {mixes}): ok")
    return checked


def not_same_bits(torch, a, b):
    """Where ``a`` and ``b`` differ in their bits, +0 and -0 counted equal:
    K11 leaves the wrench of an env without contact untouched, while its
    twin adds a zero wrench to it when another env of the batch has
    contact (the TPU kernel: another env of its tile), and -0 + 0 is +0."""
    return (a.view(torch.int32) != b.view(torch.int32)) & ~((a == 0) & (b == 0))


def k4_registers(d: int, adim: int, bf16: bool = False) -> str:
    """ptxas's registers and spills of K4's clip-mode instance at (d,
    adim), float32 or bf16 (a library built before the bf16 instances
    names the float32 one without the dtype)."""
    found = kernel_registers(f"ppo_update_kernel<{d}, {adim}, false, {'true' if bf16 else 'false'}>")
    if found == "not reported" and not bf16:
        return kernel_registers(f"ppo_update_kernel<{d}, {adim}, false>")
    return found


def kernel_registers(short_name: str) -> str:
    """ptxas's registers and spills of the kernel whose demangled name
    starts with ``short_name`` (the first match), or "not reported"."""
    from reinmav_tpu_torch import _build

    for line in _build.ptxas_report():
        head, _, info = line.partition(": ")[2].partition(": ")
        if head.startswith(short_name):
            return info
    return "not reported"


def k1_check_states(torch, gen):
    """Phase 4's states, (10, B_CHECK) each, from ``gen``: U(-1, 1) times
    0.1 (the no-reset leg) and times 1 (the auto-reset leg)."""
    return tuple((torch.rand((10, B_CHECK), generator=gen, device=gen.device) * 2.0 - 1.0) *
                 scale for scale in (0.1, 1.0))


def k1_sass_line(ms: float, clock, gpu: str) -> dict:
    """Print K1's main-path instance: ptxas's registers, its horizon loop's
    static SASS an env-step without the reset block, and the issue time
    that implies at the sampled SM clock, against ``ms``."""
    kernel = k1_kernel_name()
    sass = loop_sass(kernel)
    issue = issue_ms(sass["step"], B_MAIN * T_MAIN, clock.mhz)
    registers = kernel_registers(kernel)
    say(f"K1: {kernel}, ptxas {registers}; its horizon loop, {sass['step']} static SASS "
        f"instructions an env-step without the reset block ({sass}), would take {issue:.3f} ms "
        f"to issue for B={B_MAIN} T={T_MAIN} at {clock.mhz:.0f} MHz (the SM clock sampled during "
        f"the timed launches; {len(clock.samples)} samples), against {ms:.3f} ms measured, on "
        f"{gpu}")
    return {"registers": registers, "sass_per_env_step": sass, "sm_clock_mhz": clock.mhz,
            "issue_ms": issue}


def hash_phase(torch, dev, gpu: str) -> None:
    """``--only hashes``: K1 and every K2/K6 kind on the inputs of phases
    4, 6, 7, 13 and 21, each output's SHA-256 (the same digests the full
    run prints), each kernel timed as there, with its SASS and the SM
    clock: a quick A/B of two trees, run in turns in one call."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.ops import rollout as ro

    tame, full = k1_check_states(torch, torch.Generator(device=dev).manual_seed(1234))
    say(f"sha256 K1 no reset B={B_CHECK} T={T_NO_RESET} (seed 17): "
        f"{digest(*ro.quad3d_rollout_autoreset(tame, 17, T_NO_RESET, autoreset=False))}")
    say(f"sha256 K1 auto-reset B={B_CHECK} T={T_RESET} (seed 99): "
        f"{digest(*ro.quad3d_rollout_autoreset(full, 99, T_RESET))}")
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    big_t = env.vreset(torch.Generator(device=dev).manual_seed(5), B_MAIN).T.contiguous()
    kernel_run = lambda: ro.quad3d_rollout_autoreset(big_t, 7, T_MAIN)  # noqa: E731
    kernel_run()
    torch.cuda.synchronize()
    with SmClock() as clock:
        kern, out = cuda_ms(kernel_run, 10)
    ms = statistics.median(kern)
    say(f"sha256 K1 auto-reset B={B_MAIN} T={T_MAIN} (seed 7): {digest(*out)}")
    say(f"time K1 B={B_MAIN} T={T_MAIN}: {ms:.3f} ms per rollout (median of 10 launches, each "
        f"{min(kern):.3f} to {max(kern):.3f}) on {gpu}")
    k1_sass_line(ms, clock, gpu)
    del big_t, out
    for name in PPO_STRUCT:
        env = reinmav_tpu_torch.make(name)
        gen = torch.Generator(device=dev).manual_seed(13 if name == HOVER else 21)
        cfg, layout, obs_norm, _, params, _, k2_args, k2_kw = k2_inputs(
            torch, dev, env, k6_states(torch, env, gen), HOVER_RET_VAR if name == HOVER else 4.0)
        run = lambda: pr.ppo_rollout(*k2_args, **k2_kw)  # noqa: E731
        run()
        torch.cuda.synchronize()
        with SmClock() as clock:
            kern, out = cuda_ms(run, 20)
        ms = statistics.median(kern)
        label = "K2" if name == "quadrotor3d-v0" else "K6-hover" if name == HOVER else f"K6 {name}"
        say(f"sha256 {label} B={B_PPO} T={T_PPO} (seed 21): {digest(*out)}")
        say(f"time {label} B={B_PPO} T={T_PPO}: {ms:.4f} ms (median of 20 launches, each "
            f"{min(kern):.4f} to {max(kern):.4f}) on {gpu}")
        k2_sass_line(label, name, ms, clock, gpu)
        if name in ("quadrotor3d-v0", HOVER):
            # K4 at (10, 4) and (13, 4) on this trajectory, as phases 10 and 13.
            batch = k4_batch(torch, cfg, layout, obs_norm, params, out)
            k4_hash(torch, dev, gpu, cfg, params, *batch, env.action_dim,
                    f"K4 ({env.obs_dim}, {env.action_dim})", clip=name == HOVER)
            del batch
        del out
        # The same inputs through the other instances: the normalisers
        # off, the tether always slack or always taut (its length 1000 or
        # 0), a quarter of the envs.
        probes = {f"normalize (obs, rewards) {no, nr}": dict(normalize_obs=no,
                                                            normalize_rewards=nr)
                  for no, nr in ((False, False), (True, False), (False, True))}
        if name in TETHER:
            for length in (1000.0, 0.0):
                pvec = k2_kw["params_vec"].clone()
                pvec[4] = length  # tether_length, in both slung kinds' params
                probes[f"tether length {length:g}"] = dict(params_vec=pvec)
        times = {}
        for what, kw in [*probes.items(), (f"B={B_PPO // 4}", None)]:
            if kw is None:
                args = (k2_args[0][:, :B_PPO // 4].contiguous(), k2_args[1][:B_PPO // 4],
                        *k2_args[2:])
                probe = lambda: pr.ppo_rollout(*args, **k2_kw)  # noqa: E731
            else:
                probe = lambda: pr.ppo_rollout(*k2_args, **{**k2_kw, **kw})  # noqa: E731
            probe()
            times[what] = statistics.median(cuda_ms(probe, 20)[0])
        say(f"time {label} B={B_PPO} T={T_PPO}, other instances and inputs (medians of 20): "
            + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + f", on {gpu}")
        del k2_args
        torch.cuda.empty_cache()
    hover = reinmav_tpu_torch.make(HOVER)
    for seed2, z_lo, z_hi in K4_SECOND_INPUTS[1:]:  # the first is K6-hover's input above
        gen2 = torch.Generator(device=dev).manual_seed(seed2)
        cfg, layout, obs_norm, _, params, _, k2_args, k2_kw = k2_inputs(
            torch, dev, hover, lambda state: hover_states(torch, gen2, dev, B_PPO, z_lo, z_hi),
            HOVER_RET_VAR)
        out = pr.ppo_rollout(*k2_args, **k2_kw)
        batch = k4_batch(torch, cfg, layout, obs_norm, params, out)
        del out, k2_args
        k4_hash(torch, dev, gpu, cfg, params, *batch, hover.action_dim,
                f"K4 (13, 4), seed {seed2}, z in [{z_lo:g}, {z_hi:g}]", clip=True)
        del batch
        torch.cuda.empty_cache()
    k7_hash(torch, dev, gpu)


def k4_hash(torch, dev, gpu: str, cfg, params, data, adv, tile: int, n_tiles: int, adim: int,
            label: str, clip: bool) -> None:
    """``--only hashes``: one K4 update on ``data`` as phase 10 runs it,
    the SHA-256 of its params, moments and metric sums, its time (median
    of 20) and, with ``clip``, the clip-edge counts
    (:func:`k4_clip_edge`)."""
    from reinmav_tpu_torch.ops import ppo_update as pu

    d = data.shape[0] - adim - 4
    perm_all, adv_stats, params, opt, kw = k4_setup(torch, dev, cfg, params, adv, tile, n_tiles,
                                                    d, adim)
    run = lambda: pu.ppo_update(data, adv_stats, perm_all, params, opt, None,  # noqa: E731
                                keep_grad0=True, **kw)
    run()
    torch.cuda.synchronize()
    ms, k = cuda_ms(run, 20)
    say(f"sha256 {label}, one update of {kw['n_epochs']} x {kw['n_minibatches']} passes: "
        f"{digest(k.params, k.opt_state.mu, k.opt_state.nu, k.grad0, *k.metrics.values())}")
    say(f"time {label}: {statistics.median(ms):.4f} ms an update (median of 20 launches, each "
        f"{min(ms):.4f} to {max(ms):.4f}) on {gpu}")
    if clip:
        k4_clip_edge(torch, data, adv_stats, perm_all, params, opt, kw, label)
        k4_forward_orders(torch, data, params, d, adim, label)


def k4_forward_orders(torch, data, params, d: int, adim: int, label: str,
                      n: int = 16_384) -> None:
    """Which summation order the twin's products (cuBLAS, float32) follow
    on ``n`` samples of ``data``: the share of each layer's outputs bit for
    bit equal to float32 FMA chains emulated in float64 (a product exact,
    one rounding to float32 a step): from 0 over k in order with the bias
    added last; from the bias over k in order (K4's first layer); from the
    bias in groups of 4 (K4's second layer, ``tile8x8_by4``).  Layers 1 and
    2 of both towers and the two heads.  Prints the shares."""
    from reinmav_tpu_torch.rl import networks

    p = networks.Layout(d, adim, (64, 64)).unflatten(params)
    f32 = torch.float32

    def chain(w, x, acc):
        for k in range(w.shape[0]):
            acc = (acc.double() + w[k].double()[:, None] * x[k].double()[None, :]).to(f32)
        return acc

    def by4(w, x, acc):
        for k in range(0, w.shape[0], 4):
            t = (w[k + 1].double()[:, None] * x[k + 1].double()[None, :]).to(f32)
            for q in (0, 2, 3):
                t = (t.double() + w[k + q].double()[:, None] * x[k + q].double()[None, :]).to(f32)
            acc = acc + t
        return acc

    shares = {}
    for tower in ("pi", "vf"):
        x = data[:d, :n]
        layers = [*p[tower], p[f"{tower}_out"]]
        for i, layer in enumerate(layers):
            w, b = layer["w"], layer["b"]
            ref = w.T @ x + b[:, None]
            zero = torch.zeros_like(ref)
            orders = {"0 then bias": chain(w, x, zero) + b[:, None],
                      "bias first": chain(w, x, zero + b[:, None])}
            if w.shape[0] % 4 == 0:
                orders["bias first, groups of 4"] = by4(w, x, zero + b[:, None])
            name = f"{tower} {'head' if i == len(layers) - 1 else f'layer {i + 1}'}"
            shares[name] = {k: float((v == ref).double().mean()) for k, v in orders.items()}
            x = torch.tanh(ref)
    say(f"{label} forward orders, the twin's products against FMA chains ({n} samples; share "
        f"of outputs bit for bit equal): " + "; ".join(
            f"{name}: " + ", ".join(f"{k} {v:.4f}" for k, v in o.items())
            for name, o in shares.items()))


#: K7's mode of each kind's training path in the smoke run (phases 15, 22).
K7_TIMED_MODE = {"quadrotor3d-v0": "td3"}


def k7_hash(torch, dev, gpu: str) -> None:
    """``--only hashes``: K7 on every kind, on phase 15's and 22's inputs
    drawn from a generator of their own (seed 15): each mode leg's SHA-256
    of the new states and the block; the kind's training mode timed as
    phase 15 times it, with the SM clock, the bound, registers and
    occupancy; then the same launch at other widths and modes (a median of
    20 each): H = 32, and sac, sac_det, td3, td3_det at H_SAC."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import offpolicy as op

    for name in PPO_STRUCT:
        env = reinmav_tpu_torch.make(name)
        states_t = k7_states(torch, env, torch.Generator(device=dev).manual_seed(15))
        for mode, warm, noise in K7_MODES:
            args = k7_args(torch, env, states_t, mode, warm, noise)
            say(f"sha256 K7 {name} {mode} warm {warm:g} noise {noise:g} B={B_OFF} H={H_SAC}: "
                f"{digest(*op.collect_step(*args))}")
        mode = K7_TIMED_MODE.get(name, "sac")
        noise = dict((m, n) for m, _, n in K7_MODES)[mode]
        args = k7_args(torch, env, states_t, mode, 0.0, noise)
        with SmClock() as clock:
            ms, lo, hi, (new, block) = k7_timed(torch, args)
        bound_ms, bound_by, ops_per_env = k7_bound(states_t, args, new, block)
        instance = k7_instance(name, mode)
        say(f"time K7 {name} {mode} B={B_OFF} H={H_SAC}: {ms:.4f} ms (median of 20 launches, each "
            f"{lo:.4f} to {hi:.4f}; SM clock {clock.mhz:.0f} MHz, {len(clock.samples)} samples), "
            f"bound {bound_ms:.4f} ms by {bound_by} ({ops_per_env} operations per env); "
            f"{instance}: ptxas {kernel_registers(instance) if instance else 'not reported'}; "
            f"{k7_occupancy(env, mode)}; on {gpu}")
        times = {}
        for what, m, n, hidden in (("H=32", mode, noise, (32, 32)), ("sac", "sac", 0.0, None),
                                   ("sac_det", "sac_det", 0.0, None), ("td3", "td3", 0.3, None),
                                   ("td3_det", "td3_det", 0.0, None)):
            probe = k7_args(torch, env, states_t, m, 0.0, n, hidden or (H_SAC, H_SAC))
            times[what] = k7_timed(torch, probe)[0]
        say(f"time K7 {name} B={B_OFF}, other widths and modes (medians of 20; {mode} at H=32): "
            + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + f", on {gpu}")
        del states_t, new, block
        torch.cuda.empty_cache()


# Phases 26-33: the modules around the learners, which run no
# kernel of their own (the GRU learner, the controllers, the gymnasium
# adapters, the renderers and profiling) and chunked_throughput_rollout,
# which launches K1 once a chunk.
GRU_ENVS = {"quadrotor2d-v0": (WARMUP_UPDATES, TIMED_UPDATES), "quadrotor3d-v0": (1, 2)}
B_GRU, T_GRU, H_GRU = 1024, 128, 64  # the CLI's defaults (--num_env, --rollout_len, --num_hidden)
GRU_TRAJ_TOL = dict(rtol=1e-3, atol=1e-4)  # float32 on the card against float64 on the CPU
GRU_GRAD_RTOL = 1e-3  # the minibatch gradient's error norm over its norm
GRU_LEARN = dict(num_envs=128, rollout_len=32, hidden=32, embed=32, learning_rate=1e-3,
                 entropy_coef=1e-3)  # tests/test_recurrent.py:86-109's configuration
GRU_LEARN_UPDATES, GRU_LEARN_WINDOW = 40, 5
B_CTRL, T_CTRL = 4096, 400
CTRL_POS_TOL = 1e-3  # metres, the card's float32 flight against the CPU's float64
B_VEC, T_VEC = 4096, 200
CHUNK_BUDGET_S = 3e-3  # about a quarter of K1's 2,097,152 x 1000 call: at least 4 chunks


def gru_states(torch, env, cfg, seed: int):
    """The same GRU train state on the CPU in float64 and on the card in
    float32."""
    from reinmav_tpu_torch.rl import recurrent

    cpu = recurrent.init_train_state(env, cfg, seed, device="cpu", dtype=torch.float64)
    dev = torch.device("cuda", 0)
    f32 = lambda t: t.to(dev, torch.float32)  # noqa: E731
    card = cpu._replace(params=f32(cpu.params),
                        opt_state=cpu.opt_state._replace(count=cpu.opt_state.count.to(dev),
                                                         mu=f32(cpu.opt_state.mu),
                                                         nu=f32(cpu.opt_state.nu)),
                        env_states=f32(cpu.env_states), h=f32(cpu.h),
                        prev_done=f32(cpu.prev_done))
    return cpu, card


def replay_env(env, resets):
    """``env`` whose ``reset_fn`` returns the given states, one a call."""
    import dataclasses

    pending = iter(resets)

    def reset_fn(params, generator, batch, device, dtype):
        return next(pending).to(device=device, dtype=dtype)

    return dataclasses.replace(env, reset_fn=reset_fn)


def gru_phase(torch, dev, gpu: str) -> dict:
    """26. The GRU learner's train_step on the card at the CLI's default
    shape, on each env of GRU_ENVS with its (warm-up, timed) updates:
    finite metrics, no kernel launched, env-steps/s.  Then one update's collection on the card (TF32
    off) against the same on the CPU in float64, from one state with the
    same action noise and reset states, and the first minibatch's gradient
    on the card against the CPU's from the CPU's trajectory."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.rl import recurrent

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = recurrent.RecurrentPpoConfig(num_envs=B_GRU, rollout_len=T_GRU, hidden=H_GRU,
                                       embed=H_GRU)
    numbers = {}
    for env_id, (warm, n_timed) in GRU_ENVS.items():
        env = reinmav_tpu_torch.make(env_id)
        state = recurrent.init_train_state(env, cfg, 0, device=dev)
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        walls, rows = [], []
        for _ in range(warm + n_timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = recurrent.train_step(env, cfg, state)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rows.append({k: float(v) for k, v in metrics.items()})
        require(all(math.isfinite(v) for row in rows for v in row.values()),
                f"GRU {env_id}: finite metrics")
        launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
        require(not launched, f"GRU {env_id}: no kernel of the port runs, launched {launched}")
        timed = walls[warm:]
        wall = statistics.median(timed)
        numbers[env_id] = wall
        say(f"GRU train_step {env_id} B={B_GRU} T={T_GRU} H={H_GRU}: wall {wall * 1e3:.1f} ms "
            f"(median of {n_timed}, {min(timed) * 1e3:.1f} to {max(timed) * 1e3:.1f}; warm-up "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls[:warm])}), "
            f"{B_GRU * T_GRU / wall:.4e} env-steps/s on {gpu}; no kernel launched; last update "
            + ", ".join(f"{k} {v:.5g}" for k, v in rows[-1].items()))

    env_id = next(iter(GRU_ENVS))
    env = reinmav_tpu_torch.make(env_id)
    cpu, card = gru_states(torch, env, cfg, 21)
    gen = torch.Generator().manual_seed(22)
    noise = torch.randn((T_GRU, env.action_dim, B_GRU), generator=gen, dtype=torch.float64)
    resets = [env.vreset(gen, B_GRU, dtype=torch.float64) for _ in range(T_GRU)]
    layout = recurrent.GruLayout.of(env, cfg)
    out = {}
    for name, state in (("cpu", cpu), ("card", card)):
        tree = layout.unflatten(state.params)
        (_, _, _), traj = recurrent.collect(replay_env(env, resets), cfg, tree, state,
                                            torch.Generator(device=state.params.device), noise)
        out[name] = traj
    ref, got = out["cpu"], out["card"]
    obs_ok = torch.isclose(got.obs.double().cpu(), ref.obs, **GRU_TRAJ_TOL).all(dim=(0, 1))
    done_apart = int((got.done.double().cpu() != ref.done).any(dim=0).sum())
    apart = int((~obs_ok).sum())
    err = float((got.obs.double().cpu() - ref.obs)[:, :, obs_ok].abs().max())
    lp_err = float((got.log_prob.double().cpu() - ref.log_prob)[:, obs_ok].abs().max())
    require(apart <= 0.01 * B_GRU, f"GRU collection: {apart} of {B_GRU} envs apart")
    say(f"GRU collection on the card (float32, TF32 off) vs the CPU (float64), {env_id} "
        f"B={B_GRU} T={T_GRU}, same noise and resets: {apart} of {B_GRU} envs apart (limit 1%; "
        f"rtol 1e-3 atol 1e-4 on every obs), max |obs err| {err:.3e}, max |logp err| "
        f"{lp_err:.3e} on the others, {done_apart} envs with a done flag apart: ok")

    with torch.no_grad():
        _, _, _, last = recurrent.policy_step(layout.unflatten(cpu.params), cpu.h,
                                              cpu.env_states.T[:env.obs_dim], cpu.prev_done)
        adv, ret = recurrent.compute_gae(cfg, ref, last)
    idx = torch.randperm(B_GRU, generator=gen)[:B_GRU // cfg.num_minibatches]
    mb = tuple(x.index_select(-1, idx) for x in (ref.obs, ref.action, ref.log_prob, adv, ret,
                                                 ref.done_prev))
    h0 = (cpu.h * (1.0 - cpu.prev_done)[None, :]).index_select(-1, idx)
    g_cpu, m_cpu = recurrent.minibatch_grads(layout, cpu.params, cfg, mb, h0)
    g_card, m_card = recurrent.minibatch_grads(layout, card.params, cfg,
                                               tuple(x.to(dev, torch.float32) for x in mb),
                                               h0.to(dev, torch.float32))
    g_card = g_card.double().cpu()
    rel = float((g_card - g_cpu).norm() / g_cpu.norm())
    require(rel <= GRU_GRAD_RTOL, f"GRU minibatch gradient: relative error {rel}")
    say(f"GRU first-minibatch gradient ({B_GRU // cfg.num_minibatches} envs x {T_GRU} steps, "
        f"{g_cpu.numel()} params) on the card vs the CPU in float64 from the CPU's trajectory: "
        f"|err| / |g| {rel:.3e} (limit {GRU_GRAD_RTOL:g}), max |err| "
        f"{float((g_card - g_cpu).abs().max()):.3e}, loss {float(m_card[0]):.6g} vs "
        f"{float(m_cpu[0]):.6g}: ok")
    return numbers


def gru_learning_phase(torch, dev, gpu: str) -> None:
    """27. tests/test_recurrent.py:86-109's learning run on the card: the
    episode-return proxy (mean reward / done fraction) of the last
    GRU_LEARN_WINDOW updates above that of the first."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.rl import recurrent

    env = reinmav_tpu_torch.make("quadrotor2d-v0")
    cfg = recurrent.RecurrentPpoConfig(**GRU_LEARN)
    state = recurrent.init_train_state(env, cfg, 3, device=dev)
    proxies = []
    t0 = time.perf_counter()
    for _ in range(GRU_LEARN_UPDATES):
        state, met = recurrent.train_step(env, cfg, state)
        proxies.append(float(met["mean_reward"]) / max(float(met["mean_episode_done_frac"]),
                                                       1e-4))
    wall = time.perf_counter() - t0
    first = statistics.mean(proxies[:GRU_LEARN_WINDOW])
    last = statistics.mean(proxies[-GRU_LEARN_WINDOW:])
    require(math.isfinite(last) and last > first, f"GRU learning: {first} -> {last}")
    say(f"GRU learning, quadrotor2d-v0 {GRU_LEARN}, {GRU_LEARN_UPDATES} updates in {wall:.1f} s on "
        f"{gpu}: episode-return proxy, mean of the first {GRU_LEARN_WINDOW} {first:.4f} -> of the "
        f"last {GRU_LEARN_WINDOW} {last:.4f} (single updates {proxies[0]:.4f} -> "
        f"{proxies[-1]:.4f}): ok")


def has_module(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def gru_cli_phase(gpu: str) -> None:
    """28. The GRU CLI in subprocesses: train one update at the default
    shape with a checkpoint, then play 200 steps with --html, and with
    --gif where matplotlib is installed; where it is not, --gif must exit
    before training, naming it."""
    from reinmav_tpu_torch.rl import run

    root = Path(__file__).resolve().parent
    out = root / "chiprun_out"
    ck = out / "smoke_gru_ckpt"
    base = [sys.executable, "-m", "reinmav_tpu_torch.rl.run", "--network=gru",
            "--env=quadrotor2d-v0"]
    gif = has_module("matplotlib") and has_module("PIL")
    play = [*base, f"--load_path={ck}", "--play", f"--play_steps={PLAY_STEPS}",
            f"--html={out / 'smoke_gru_play.html'}"]
    if gif:
        play.append(f"--gif={out / 'smoke_gru_play.gif'}")
    else:
        try:
            run.main(["--network=gru", "--play", f"--gif={out / 'smoke_gru_play.gif'}"])
            raise RuntimeError("--gif without matplotlib did not exit")
        except SystemExit as e:
            refusal = str(e)
        require("--gif needs matplotlib" in refusal, f"--gif refusal: {refusal}")
        say(f"cli gru --gif: matplotlib is not installed on this machine; the CLI exits before "
            f"training with: {refusal}")
    runs = {"train": [*base, f"--num_timesteps={B_GRU * T_GRU}", "--log_interval=1",
                      f"--save_path={ck}"], "play": play}
    for name, cmd in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
        if proc.returncode != 0:
            raise RuntimeError(f"the GRU CLI ({name}) exited {proc.returncode}:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        require(bool(rows) and all(math.isfinite(v) for v in rows[-1].values()
                                   if isinstance(v, float)), f"the GRU CLI ({name}) lines")
        if name == "play":
            require(rows[-1]["play_steps"] == PLAY_STEPS, "the GRU CLI's play line")
            for key in ("html", "gif") if gif else ("html",):
                require(Path(rows[-1][key]).stat().st_size > 1000, f"the GRU CLI's {key}")
        say(f"cli gru {name}: exit 0 in {time.perf_counter() - t0:.1f} s on {gpu}; last line "
            f"{json.dumps(rows[-1])}")


def fly_controllers(torch, device, dtype, init_geo, init_pid):
    """The two standalone controllers flown batched on ``device``:
    geometric on quadrotor3d-v0 along the demos' circle, the RPY PID on
    MujocoQuadForce-v1 (control_rpy.py's loop); the final states."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.controllers import geometric, rpy_pid

    geo_env = reinmav_tpu_torch.make("quadrotor3d-v0")
    s = init_geo.to(device, dtype)
    gains = geometric.Gains()
    for t in range(T_CTRL):
        ref = geometric.circle_reference(t * 0.01, z=2.0, dtype=dtype, device=device)
        a = geometric.control(gains, s[:, 0:3], s[:, 3:7], s[:, 7:10], ref)
        s = geo_env.vstep(s, a).state
    pid_env = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    p = pid_env.params
    dt = p.dt * p.frame_skip
    q = init_pid.to(device, dtype)
    carry = rpy_pid.init_carry(dtype, device, (q.shape[0],))
    for t in range(T_CTRL):
        pos_d = torch.tensor([0.5 * math.cos(dt * t), 0.5 * math.sin(dt * t), 1.0], dtype=dtype,
                             device=device)
        yaw_d = math.remainder(dt * t, 2 * math.pi)
        forces, carry = rpy_pid.control(rpy_pid.Gains(), carry, q[:, 0:3], q[:, 3:7], pos_d, yaw_d,
                                        dt, p.mass, p.gravity)
        q = pid_env.vstep(q, forces).state
    return s, q


def controllers_phase(torch, dev, gpu: str) -> None:
    """29. geometric and rpy_pid flown batched on the card in float32
    against the same flights on the CPU in float64."""
    import reinmav_tpu_torch

    gen = torch.Generator().manual_seed(29)
    geo0 = reinmav_tpu_torch.make("quadrotor3d-v0").vreset(gen, B_CTRL, dtype=torch.float64) * 0.3
    pid0 = reinmav_tpu_torch.make("MujocoQuadForce-v1").vreset(gen, B_CTRL, dtype=torch.float64)
    pid0[:, 0:3] += torch.rand((B_CTRL, 3), generator=gen, dtype=torch.float64) * 0.2 - 0.1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geo_card, pid_card = fly_controllers(torch, dev, torch.float32, geo0, pid0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    geo_cpu, pid_cpu = fly_controllers(torch, "cpu", torch.float64, geo0, pid0)
    for name, card, cpu in (("geometric on quadrotor3d-v0", geo_card, geo_cpu),
                            ("rpy_pid on MujocoQuadForce-v1", pid_card, pid_cpu)):
        err = float((card[:, 0:3].double().cpu() - cpu[:, 0:3]).abs().max())
        require(bool(torch.isfinite(card).all()) and err < CTRL_POS_TOL,
                f"{name}: max |position err| {err}")
        say(f"controllers: {name}, B={B_CTRL} T={T_CTRL}: card (float32) vs CPU (float64) max "
            f"|position err| {err:.3e} m (limit {CTRL_POS_TOL:g}); mean final z "
            f"{float(cpu[:, 2].mean()):.4f}: ok")
    say(f"controllers: both flights {wall:.2f} s on {gpu} (eager)")


def gym_phases(torch, dev, gpu: str) -> float:
    """30-31. The gymnasium adapters on the card: GymAdapter flying
    quadrotor3d-v0 400 steps with control(); VectorGymAdapter, B_VEC envs x
    T_VEC steps of zero thrust, its final_obs counted.  Where gymnasium is
    not installed, the adapters' own step functions (single_step,
    batched_step: the whole of their work a step) run the same loops.
    Returns the vector step's wall."""
    import numpy as np

    import reinmav_tpu_torch
    from reinmav_tpu_torch.compat import gym_env, vector_env

    gym = has_module("gymnasium")
    if not gym:
        say("gym: gymnasium is not installed on this machine; the adapters' step functions "
            "(compat.gym_env.single_step, compat.vector_env.batched_step) run the loops")
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    if gym:
        adapter = gym_env.make("quadrotor3d-v0")
        require(adapter.device.type == "cuda", "GymAdapter device")
        obs, _ = adapter.reset(seed=3)
        control, step = adapter.control, lambda a: adapter.step(a)[:3]
        reset = lambda: adapter.reset()[0]  # noqa: E731
    else:
        gen = torch.Generator(device=dev).manual_seed(3)
        box = {"s": env.reset(gen)}
        obs = box["s"][:10].cpu().numpy()
        control = lambda: env.control(box["s"]).cpu().numpy()  # noqa: E731

        def step(a):
            box["s"], o, r, term, _ = gym_env.single_step(env, box["s"], a)
            return o, r, term

        def reset():
            box["s"] = env.reset(gen)
            return box["s"][:10].cpu().numpy()
    resets = 0
    t0 = time.perf_counter()
    for _ in range(400):
        obs, reward, term = step(control())
        require(bool(np.isfinite(obs).all()), "GymAdapter: finite obs")
        if term:
            obs = reset()
            resets += 1
    wall = time.perf_counter() - t0
    dist = float(np.linalg.norm(obs[:3] - np.array(REF)))
    require(dist < 0.5 or resets > 0, f"GymAdapter: distance {dist} to {REF} after 400 steps")
    say(f"{'GymAdapter' if gym else 'gym_env.single_step'} quadrotor3d-v0 on cuda: 400 steps of "
        f"control() + step() in {wall:.2f} s ({wall / 400 * 1e3:.2f} ms a step on {gpu}), final z "
        f"{float(obs[2]):.4f}, distance to {REF} {dist:.4f}, resets {resets}: ok")

    zero = np.zeros((B_VEC, 4), np.float32)
    if gym:
        vec = vector_env.make_vec("quadrotor3d-v0", B_VEC)
        vec.reset(seed=0)

        def vstep():
            obs, rew, term, trunc, infos = vec.step(zero)
            return obs, rew, term | trunc, infos.get("_final_obs"), infos.get("final_obs")
    else:
        vgen = torch.Generator(device=dev).manual_seed(0)
        vbox = {"s": env.vreset(vgen, B_VEC)}

        def vstep():
            vbox["s"], obs, final, rew, term, trunc, ended = vector_env.batched_step(
                env, vbox["s"], zero, vgen)
            return obs, rew, term | trunc, ended if ended.any() else None, final
    vstep()  # warm-up
    final, steps = 0, []
    for _ in range(T_VEC):
        t0 = time.perf_counter()
        obs, rew, ended_flags, mask, final_obs = vstep()
        steps.append(time.perf_counter() - t0)
        if mask is not None:
            require(bool(np.array_equal(mask, ended_flags)) and
                    not np.isnan(final_obs[mask]).any(), "VectorGymAdapter: final_obs")
            final += int(mask.sum())
    require(obs.shape == (B_VEC, 10) and rew.dtype == np.float64 and final > 0
            and bool(np.isfinite(obs).all()), "VectorGymAdapter outputs")
    per_step = statistics.median(steps)
    say(f"{'VectorGymAdapter' if gym else 'vector_env.batched_step'} quadrotor3d-v0 on cuda, "
        f"B={B_VEC} x {T_VEC} steps of zero thrust: {final} final_obs delivered, wall "
        f"{per_step * 1e3:.3f} ms a step (median; {min(steps) * 1e3:.3f} to "
        f"{max(steps) * 1e3:.3f}), {B_VEC / per_step:.4e} env-steps/s on {gpu}: ok")
    return per_step


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def chunked_phase(torch, dev, gpu: str) -> dict:
    """32. chunked_throughput_rollout at the main path's 2,097,152 x 1000
    on quadrotor3d-v0 with a budget that forces at least 4 chunks: K1
    launches once a chunk; its wall against one throughput_rollout call.
    Then on the eager backend at 4096 x 50, bitwise the unchunked call."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import rollout as ro

    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    gen = torch.Generator(device=dev).manual_seed(32)
    states = env.vreset(gen, B_MAIN)
    handler = _Lines()
    core_log = logging.getLogger("reinmav_tpu_torch.envs.core")
    core_log.addHandler(handler)
    try:
        reinmav_tpu_torch.throughput_rollout(env, states, gen, 10)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_one, r_one = reinmav_tpu_torch.throughput_rollout(env, states, gen, T_MAIN)
        torch.cuda.synchronize()
        one = time.perf_counter() - t0
        ro.quad3d_rollout_autoreset.launches = 0
        t0 = time.perf_counter()
        f_ch, r_ch = reinmav_tpu_torch.chunked_throughput_rollout(
            env, states, gen, T_MAIN, device_time_budget_s=CHUNK_BUDGET_S)
        torch.cuda.synchronize()
        chunked = time.perf_counter() - t0
        launches = ro.quad3d_rollout_autoreset.launches
    finally:
        core_log.removeHandler(handler)
    (summary,) = [line for line in handler.lines if " chunks of " in line]
    n_chunks = int(summary.split("): ")[1].split(" chunks")[0])
    require(n_chunks >= 4 and launches == n_chunks, f"chunked: {summary}, K1 launches {launches}")
    require(bool(torch.isfinite(f_ch).all()) and bool(torch.isfinite(r_ch).all()),
            "chunked: finite")
    one_mean = float(r_one.double().mean())
    rel = abs(float(r_ch.double().mean()) - one_mean) / abs(one_mean)
    say(f"chunked_throughput_rollout quadrotor3d-v0 B={B_MAIN} T={T_MAIN}, budget "
        f"{CHUNK_BUDGET_S * 1e3:g} ms: {summary.split('): ')[1]}, K1 launches {launches} (one a "
        f"chunk), wall {chunked * 1e3:.2f} ms against {one * 1e3:.2f} ms for one throughput_rollout "
        f"call on {gpu}; mean reward sum {float(r_ch.mean()):.4f} vs {float(r_one.mean()):.4f} "
        f"(rel {rel:.2e}; the chunks are other Philox streams): ok")

    small = env.vreset(gen, B_QUICK)
    f_ref, r_ref = reinmav_tpu_torch.throughput_rollout(
        env, small, torch.Generator(device=dev).manual_seed(5), 50, backend="scan")
    f_e, r_e = reinmav_tpu_torch.chunked_throughput_rollout(
        env, small, torch.Generator(device=dev).manual_seed(5), 50, backend="scan",
        device_time_budget_s=1e-9, probe_steps=4)
    require(torch.equal(f_e, f_ref) and torch.equal(r_e, r_ref), "chunked eager: not bitwise")
    say(f"chunked_throughput_rollout eager backend on the card, B={B_QUICK} T=50 in chunks of 4, 4, "
        f"then 1: bitwise the unchunked call: ok")
    return {"chunked_ms": chunked * 1e3, "one_call_ms": one * 1e3, "chunks": n_chunks}


def render_phase(torch, dev, gpu: str) -> None:
    """33. save_html and save_gif of a rollout flown on the card, one
    LiveViewer request, and time_fn and trace on a K1 call."""
    import urllib.request

    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import rollout as ro
    from reinmav_tpu_torch.render import LiveViewer, save_gif, save_html
    from reinmav_tpu_torch.utils import profiling

    out = Path(__file__).resolve().parent / "chiprun_out"
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    gen = torch.Generator(device=dev).manual_seed(33)
    _, traj = reinmav_tpu_torch.control_rollout(env, env.vreset(gen, 64), gen, 200)
    states = traj.state[:, 0]
    html = save_html(env.name, states, str(out / "smoke_render.html"))
    require(Path(html).stat().st_size > 1000, "the HTML file")
    if has_module("matplotlib"):
        gif = Path(save_gif(env.name, states, str(out / "smoke_render.gif"), every=8)).name
        require((out / gif).stat().st_size > 1000, "the GIF file")
    else:
        try:
            save_gif(env.name, states, str(out / "smoke_render.gif"), every=8)
            raise RuntimeError("save_gif ran without matplotlib")
        except ModuleNotFoundError as e:
            require("matplotlib" in str(e), f"save_gif: {e}")
        gif = "no GIF (matplotlib is not installed on this machine: save_gif raises)"
    viewer = LiveViewer(env.name, port=0)
    try:
        for s in states[:20]:
            viewer.push(s)
        with urllib.request.urlopen(viewer.url + "frames.json?since=0", timeout=10) as r:
            body = json.loads(r.read())
        require(body["seq"] == 20 and len(body["frames"]) == 20, "LiveViewer frames")
    finally:
        viewer.close()
    big_t = env.vreset(gen, B_MAIN).T.contiguous()
    seconds, _ = profiling.time_fn(ro.quad3d_rollout_autoreset, big_t, 7, 100, warmup=1, iters=5)
    with profiling.trace(str(out / "smoke_trace")) as prof:
        ro.quad3d_rollout_autoreset(big_t, 7, 100)
        torch.cuda.synchronize()
    device_us = max((getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                     for e in prof.key_averages()), default=0.0)
    traces = [p.name for p in (out / "smoke_trace").iterdir() if p.name.endswith(".json")]
    require(seconds > 0 and bool(traces), "profiling")
    profiling.NanGuard.check(traj, "control_rollout")
    say(f"render: {Path(html).name} and {gif} of a card rollout, LiveViewer "
        f"{viewer.url} answered one frames request (20 frames); profiling: time_fn K1 B={B_MAIN} "
        f"T=100 {seconds * 1e3:.3f} ms (median of 5, CUDA events), trace {traces[0]}, the most "
        f"device time of an event in it {device_us / 1e3:.3f} ms "
        f"({'CUPTI' if device_us else 'not measured'}) on {gpu}: ok")


def modules_phases(torch, dev, gpu: str) -> None:
    """Phases 26-33 and their wall."""
    t0 = time.perf_counter()
    gru = gru_phase(torch, dev, gpu)
    gru_learning_phase(torch, dev, gpu)
    gru_cli_phase(gpu)
    controllers_phase(torch, dev, gpu)
    vec_step = gym_phases(torch, dev, gpu)
    chunked = chunked_phase(torch, dev, gpu)
    render_phase(torch, dev, gpu)
    say(f"phases 26-33 (GRU, controllers, gym adapters, chunking, renderers): "
        f"{time.perf_counter() - t0:.1f} s on {gpu}; " + json.dumps(
            {"gru_train_step_ms": {k: v * 1e3 for k, v in gru.items()},
             "vector_step_ms": vec_step * 1e3, **chunked}))


# Phases 34-40: compute_dtype="bfloat16", the bf16 instances of K2/K6, K3,
# K4 and K7 and the learners' bf16 paths.
BF16 = "bfloat16"
#: The tensor cores' dense bf16 rate (H100 SXM data sheet, at 700 W): the
#: bound of a bf16 instance counts its products at this rate.
PEAK_BF16_FLOPS = 989e12
#: bf16 updates of each path on the kinds but quadrotor3d-v0 (quadrotor3d-v0
#: runs 2 warm-up and 5 timed), and bf16 SAC iterations at the bench config.
BF16_UPDATES, BF16_SAC_WARMUP, BF16_SAC_ITERS, BF16_OFF_ITERS = 3, 3, 20, 3
#: Ulps of the ratio or value clip within which K4's resynchronised check
#: counts a sample as on the knife edge.
RESYNC_ULPS = 16


def bound_bf16(nbytes: float, product_flops: float, other_flops: float) -> tuple[float, str]:
    """The least milliseconds the card could take for work that moves
    ``nbytes``, does ``product_flops`` operations of bf16 products (at the
    tensor cores' rate) and ``other_flops`` FP32 operations, and which
    bounds it."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = (product_flops / PEAK_BF16_FLOPS + other_flops / PEAK_FP32_FLOPS) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def mlp_flops(d: int, a: int) -> int:
    """The 2 x 64 actor-critic's products an env-step or sample, forward:
    2 (64 D + 64 * 64) a tower, the heads 2 * 64 (A + 1)."""
    return 2 * (d * 128 + 2 * 64 * 64 + 64 * a + 64)


def bits_apart(torch, a, b) -> int:
    """Entries of ``a`` and ``b`` whose bits differ (+0 and -0 equal)."""
    if a.dtype == torch.bool:
        return int((a != b).sum())
    return int(not_same_bits(torch, a.contiguous(), b.contiguous()).sum())


def in_turns(torch, first, second, reps: int = 10):
    """``first`` and ``second`` timed in turns (first, second, second,
    first), ``reps`` launches each time: the two medians and ranges."""
    a0, _ = cuda_ms(first, reps)
    b0, _ = cuda_ms(second, reps)
    b1, _ = cuda_ms(second, reps)
    a1, _ = cuda_ms(first, reps)
    return ((statistics.median(a0 + a1), min(a0 + a1), max(a0 + a1)),
            (statistics.median(b0 + b1), min(b0 + b1), max(b0 + b1)))


def k4_resync(torch, data, adv_stats, perm_all, params, opt, kw, label: str,
              bf16: bool = False) -> dict:
    """K4 against its twin resynchronised: each pass q of the update as a
    one-pass K4 launch from the twin's params and Adam state after pass q -
    1 (the twin's own run, one pass at a time), on the pass's minibatch
    gathered, with the samples on a knife edge replaced by a copy of the
    pass's first sample that is not: within RESYNC_ULPS ulps of the ratio
    clip (1 +- clip_eps) or of the value clip (|value - old_value| =
    value_clip_eps, or sq1 = sq2 outside it), on the twin's forward.  The
    twin's one pass on the same batch is the reference: the pass's gradient
    within GRAD_TOL, the params within UPDATE_TOL, the Adam moments within
    MOMENT_TOL, every entry (gated), and the Adam count.  Returns the
    counts."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_update as pu

    cd = BF16 if bf16 else None
    d, adim, tile = kw["d"], kw["adim"], kw["tile"]
    n_passes = kw["n_epochs"] * kw["n_minibatches"]
    tpm = perm_all.shape[0] // n_passes
    one = {**kw, "n_epochs": 1, "n_minibatches": 1}
    ident = torch.arange(tpm, dtype=torch.int32, device=data.device)
    net, state = params, opt
    edges, out, errs = 0, {"grad": 0, "params": 0, "mu": 0, "nu": 0}, dict.fromkeys(
        ("grad", "params", "mu", "nu"), 0.0)
    for q in range(n_passes):
        perm = perm_all[q * tpm:(q + 1) * tpm].contiguous()
        cols = pl._gather_columns(perm, tile)
        stats = adv_stats[q:q + 1].contiguous()
        ratio, value = twin_ratio(torch, data, cols, net, d, adim, bf16)
        adv_n = (data[d + adim + 2, cols] - stats[0, 0]) * stats[0, 1]
        near, _ = clip_edges(torch, ratio, adv_n, kw["clip_eps"])
        vclip, vtie = value_edges(torch, value, data[d + adim + 1, cols], data[d + adim + 3, cols],
                                  kw["value_clip_eps"])
        edge = near[RESYNC_ULPS] | vclip[RESYNC_ULPS] | vtie[RESYNC_ULPS]
        batch = data[:, cols].contiguous()
        n_edge = int(edge.sum())
        if n_edge:
            keep = int((~edge).nonzero()[0, 0])
            batch[:, edge] = batch[:, keep:keep + 1]
        edges += n_edge
        k = pu.ppo_update(batch, stats, ident, net, state, None, keep_grad0=True,
                          compute_dtype=cd, **one)
        t_params, t_state, _, t_grad = pu.ppo_update_reference(batch, stats, ident, net, state,
                                                               None, compute_dtype=cd, **one)
        require(int(k.opt_state.count) == int(t_state.count), f"{label} resync: Adam count")
        for name, a, b, tol in (("grad", k.grad0, t_grad, GRAD_TOL),
                                ("params", k.params, t_params, UPDATE_TOL),
                                ("mu", k.opt_state.mu, t_state.mu, MOMENT_TOL),
                                ("nu", k.opt_state.nu, t_state.nu, MOMENT_TOL)):
            out[name] += count_outside(a, b, tol)
            errs[name] = max(errs[name], float((a - b).abs().max()))
        # The twin's own run on the pass as it is carries the state on.
        net, state, _, _ = pu.ppo_update_reference(data, stats, perm, net, state, None,
                                                   compute_dtype=cd, **one)
    torch.cuda.synchronize()
    say(f"{label} resynchronised ({n_passes} passes of {tpm * tile} samples, each from the "
        f"twin's state; {edges} samples within {RESYNC_ULPS} ulps of the ratio or value clip "
        f"replaced): entries outside, gradient {out['grad']} (rtol 2e-3 atol 2e-6), params "
        f"{out['params']} (rtol 2e-4 atol 1e-6), Adam mu {out['mu']} and nu {out['nu']} (rtol "
        f"2e-4 atol 5e-8); max |err| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    require(not any(out.values()), f"{label} resynchronised: entries outside {out}")
    return {"edge_samples": edges, "outside": out, "max_abs_err": errs}


def bf16_kind_phase(torch, dev, gpu: str, env, ret_var: float) -> list[dict]:
    """Phases 34-36 for one kind: the bf16 instances of K2/K6, K3 and K4
    against their bf16 twins at the main path's shapes, each timed in turns
    with its float32 instance on the same inputs, registers and spills
    beside; then the kind's bf16 training paths (K2/K6 + K4, and the K3
    loop), their launches counted.  Returns the three kernels' entries."""
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_rollout as pr
    from reinmav_tpu_torch.ops import ppo_update as pu
    from reinmav_tpu_torch.rl import ppo

    d, a, name = env.obs_dim, env.action_dim, env.name
    gen = torch.Generator(device=dev).manual_seed(34)
    cfg, layout, obs_norm, ret_norm, params, consts, k2_args, k2_kw = k2_inputs(
        torch, dev, env, k6_states(torch, env, gen), ret_var)
    kw16 = {**k2_kw, "compute_dtype": BF16}
    k2_name = {"quadrotor3d-v0": "K2", HOVER: "K6-hover"}.get(name, f"K6 {name}")

    # 34. K2/K6's bf16 instance against its bf16 twin.
    pr.ppo_rollout(*k2_args, **kw16)  # warm-up
    out = pr.ppo_rollout(*k2_args, **kw16)
    ref = pr.ppo_rollout_reference(*k2_args, **kw16)
    torch.cuda.synchronize()
    bad = _mismatched_envs(torch, out, ref)
    mismatched, ok = int(bad.sum()), ~bad
    apart = [bits_apart(torch, x, y) for x, y in zip(out, ref)]
    k2_err = max(float((x[..., ok] - y[..., ok]).abs().max())
                 for x, y in zip((*out[:5], out.final_states), (*ref[:5], ref.final_states)))
    # The gate: one step at a time from the twin's state.  Free-running,
    # a last-bit difference of the env step or the noise (FMA contraction,
    # library calls) moves an obs or a hidden unit across a bf16 rounding
    # edge now and then, and the env's trajectory parts: counted, not gated.
    x, r, outside, knife, v_apart, stats_rel = *k2_args[:2], 0, 0, 0, None
    for t in range(T_PPO):
        ks = pr.ppo_rollout(x, r, 21 + t, params, consts, 1, **kw16)
        ps = pr.ppo_rollout_reference(x, r, 21 + t, params, consts, 1, **kw16)
        safe = off_sphere(torch, env, x)
        outside += int((_mismatched_envs(torch, ks, ps) & safe).sum())
        knife += int((~safe).sum())
        v_apart += bits_apart(torch, ks.value, ps.value)
        if stats_rel is None:
            stats_rel = float(((ks.stats - ps.stats).abs() / ps.stats.abs().clamp_min(1.0)).max())
        x, r = ps.final_states, ps.returns
    del ks, ps, x, r
    limit = 0 if name in TETHER else int(0.001 * B_PPO)
    require(outside <= limit, f"{k2_name} bf16 vs twin, resynchronised: {outside} envs outside")
    gate = (f"resynchronised over {T_PPO} steps: {outside} env-steps outside rtol 2e-4 atol 2e-5 "
            f"(limit {limit}), {knife} within {KNIFE:g} of the tether sphere skipped, values "
            f"whose bits differ {v_apart} of {B_PPO * T_PPO}; free-running {mismatched} of "
            f"{B_PPO} envs apart (reported)")
    require(stats_rel <= 1e-3, f"{k2_name} bf16 moment sums, rel err {stats_rel}")
    again = pr.ppo_rollout(*k2_args, **kw16)
    require(all(torch.equal(x, y) for x, y in zip(out, again)), f"{k2_name} bf16 determinism")
    f32_out = pr.ppo_rollout(*k2_args, **k2_kw)
    require(not torch.equal(f32_out.value, out.value), f"{k2_name}: bf16 equals float32")
    (ms32, lo32, hi32), (ms, lo, hi) = in_turns(
        torch, lambda: pr.ppo_rollout(*k2_args, **k2_kw), lambda: pr.ppo_rollout(*k2_args, **kw16))
    plain = [cuda_ms(lambda: pr.ppo_rollout_reference(*k2_args, **kw16), 1)[0][0] for _ in range(2)]
    prod = mlp_flops(d, a) * B_PPO * T_PPO
    k2_bound, k2_by = bound_bf16(nbytes(*k2_args[:2], params, consts, *out), prod,
                                 OPS_ROLLOUT[d] * B_PPO * T_PPO - prod)
    regs, regs32 = (kernel_registers(ppo_instance(name, b)) for b in (True, False))
    say(f"{k2_name} bf16 vs bf16 twin, B={B_PPO} T={T_PPO}, noise and resets on "
        f"({int(ref.done.sum())} resets): {gate}; on the envs that agree max |err| {k2_err:.3e}; "
        f"entries whose bits differ by output {apart}; moment sums rel err {stats_rel:.3e}; "
        f"bitwise equal on a rerun: ok")
    say(f"time {k2_name} B={B_PPO} T={T_PPO}: bf16 {ms:.4f} ms ({lo:.4f} to {hi:.4f}), float32 "
        f"{ms32:.4f} ms ({lo32:.4f} to {hi32:.4f}) in turns, 20 launches each; bf16 twin "
        f"{statistics.median(plain):.2f} ms; bf16 bound {k2_bound:.4f} ms by {k2_by} (products "
        f"at 989 TFLOP/s); ptxas bf16 {regs}; float32 {regs32}; on {gpu}")
    rollout = dict(max_abs_err=k2_err, mismatched=mismatched, ms=ms, f32_ms=ms32,
                   plain_ms=statistics.median(plain), bound_ms=k2_bound, bound_by=k2_by,
                   registers=regs, f32_registers=regs32, bits_apart=apart)

    # 35. K3's bf16 instance on one full minibatch of that trajectory.
    n = B_PPO * T_PPO
    data, adv, tile, n_tiles = k4_batch(torch, cfg, layout, obs_norm, params, out)
    del f32_out, again, ref
    perm = ppo._shuffle_indices(torch.Generator().manual_seed(5), n_tiles, dev)
    tidx = perm.reshape(cfg.num_minibatches, -1)[0].to(torch.int32).contiguous()
    adv_mb = adv.reshape(n)[pl._gather_columns(tidx, tile)]
    zero = torch.zeros((), device=dev)
    adv_stats = torch.stack([adv_mb.mean(), 1.0 / (adv_mb.std(unbiased=False) + 1e-8), zero,
                             zero]).contiguous()
    net = (params + 0.02 * torch.randn(params.shape, generator=torch.Generator(
        device=dev).manual_seed(8), device=dev)).contiguous()
    kcfg = dict(d=d, adim=a, clip_eps=cfg.clip_eps, value_clip_eps=cfg.value_clip_eps,
                value_coef=cfg.value_coef, tile=tile)
    mb = tidx.numel() * tile
    k3 = lambda cd: pl.ppo_loss_grads_gather(data, adv_stats, tidx, net,  # noqa: E731
                                             ent_coef=0.01, compute_dtype=cd, **kcfg)
    g_k, m_k = k3(BF16)
    g_p, m_p = pl._finish(pl.ppo_loss_grads_reference(data, adv_stats, tidx, net,
                                                      compute_dtype=BF16, **kcfg), mb, 0.01, layout)
    g_again, _ = k3(BF16)
    g32, _ = k3(None)
    torch.cuda.synchronize()
    require(torch.allclose(g_k, g_p, **GRAD_TOL), f"K3 ({d}, {a}) bf16 vs twin, gradients")
    for m in pl.METRICS:
        require(torch.allclose(m_k[m], m_p[m], **METRIC_TOL), f"K3 ({d}, {a}) bf16 vs twin, {m}")
    require(torch.equal(g_k, g_again), f"K3 ({d}, {a}) bf16 determinism")
    require(float(m_k["clip_frac"]) > 0.0 and not torch.equal(g_k, g32),
            f"K3 ({d}, {a}) bf16: no clip, or bf16 equals float32")
    (ms32_3, _, _), (ms3, lo3, hi3) = in_turns(torch, lambda: k3(None), lambda: k3(BF16))
    plain3 = [cuda_ms(lambda: pl.ppo_loss_grads_reference(data, adv_stats, tidx, net,
                                                          compute_dtype=BF16, **kcfg), 1)[0][0]
              for _ in range(2)]
    k3_err = float((g_k - g_p).abs().max())
    k3_bound, k3_by = bound_bf16(nbytes(tidx, adv_stats, net, g_k) + mb * data.shape[0] * 4,
                                 OPS_LOSS[d] * mb, 0.0)
    regs3 = kernel_registers(f"ppo_loss_kernel<{d}, {a}, false, true>")
    regs3_32 = kernel_registers(f"ppo_loss_kernel<{d}, {a}, false, false>")
    say(f"K3 ({d}, {a}) bf16 vs bf16 twin, one minibatch of {mb} samples: grads max |err| "
        f"{k3_err:.3e}, rel err {rel_err(g_k, g_p):.3e} (rtol 2e-3 atol 2e-6), metrics "
        f"{', '.join(f'{m} {float(m_k[m]):.5g}' for m in pl.METRICS)} (rtol 2e-4 atol 1e-6); "
        f"bitwise equal on a rerun: ok")
    say(f"time K3 ({d}, {a}) minibatch {mb}: bf16 {ms3:.4f} ms ({lo3:.4f} to {hi3:.4f}), float32 "
        f"{ms32_3:.4f} ms in turns; bf16 twin {statistics.median(plain3):.2f} ms; bf16 bound "
        f"{k3_bound:.4f} ms by {k3_by}; ptxas bf16 {regs3}; float32 {regs3_32}; on {gpu}")
    loss = dict(max_abs_err=k3_err, ms=ms3, f32_ms=ms32_3, plain_ms=statistics.median(plain3),
                bound_ms=k3_bound, bound_by=k3_by, registers=regs3, f32_registers=regs3_32)

    # 36. K4's bf16 instance: one 4 x 4 update, held to its twin resynchronised.
    e_, m_ = cfg.num_epochs, cfg.num_minibatches
    perm_all, k4_stats, k4_params, opt, kw = k4_setup(torch, dev, cfg, params, adv, tile, n_tiles,
                                                      d, a)
    resync = k4_resync(torch, data, k4_stats, perm_all, k4_params, opt, kw,
                       f"K4 ({d}, {a}) bf16", bf16=True)
    k4 = lambda cd: pu.ppo_update(data, k4_stats, perm_all, k4_params, opt, None,  # noqa: E731
                                  compute_dtype=cd, **kw)
    k = k4(BF16)
    tw_params, tw_opt, _, _ = pu.ppo_update_reference(data, k4_stats, perm_all, k4_params, opt,
                                                      None, compute_dtype=BF16, **kw)
    again = k4(BF16)
    torch.cuda.synchronize()
    require(torch.equal(k.params, again.params) and
            all(torch.equal(x, y) for x, y in zip(k.opt_state, again.opt_state)),
            f"K4 ({d}, {a}) bf16 determinism")
    require(int(k.opt_state.count) == e_ * m_ and bool(torch.isfinite(k.params).all()),
            f"K4 ({d}, {a}) bf16 count or finite params")
    free = {x: count_outside(p, q, tol) for x, p, q, tol in (
        ("params", k.params, tw_params, UPDATE_TOL), ("mu", k.opt_state.mu, tw_opt.mu, MOMENT_TOL),
        ("nu", k.opt_state.nu, tw_opt.nu, MOMENT_TOL))}
    k4_err = float((k.params - tw_params).abs().max())
    (ms32_4, _, _), (ms4, lo4, hi4) = in_turns(torch, lambda: k4(None), lambda: k4(BF16), 5)
    (plain4,), _ = cuda_ms(lambda: pu.ppo_update_reference(
        data, k4_stats, perm_all, k4_params, opt, None, compute_dtype=BF16, **kw), 1)
    mb4 = perm_all.shape[0] // (e_ * m_) * tile
    k4_bound, k4_by = bound_bf16(
        nbytes(data, perm_all, k4_stats, k4_params, opt.mu, opt.nu, k.params, k.opt_state.mu,
               k.opt_state.nu) + 4 * pu.N_METRIC_SUMS, OPS_LOSS[d] * mb4 * e_ * m_, 0.0)
    regs4, regs4_32 = k4_registers(d, a, True), k4_registers(d, a)
    say(f"K4 ({d}, {a}) bf16, one update of {e_} x {m_} passes of {mb4}: free-running against "
        f"the bf16 twin (reported, not gated: a weight on a bf16 rounding edge can round the "
        f"other way once the params part in their last bit) params max |err| {k4_err:.3e}, "
        f"entries outside {free}; bitwise equal on a rerun: ok")
    say(f"time K4 ({d}, {a}) {e_} x {m_} passes of {mb4}: bf16 {ms4:.4f} ms ({lo4:.4f} to "
        f"{hi4:.4f}), float32 {ms32_4:.4f} ms in turns, 10 launches each; bf16 twin {plain4:.1f} "
        f"ms; bf16 bound {k4_bound:.4f} ms by {k4_by}; ptxas bf16 {regs4}; float32 {regs4_32}; "
        f"on {gpu}")
    update = dict(max_abs_err=max(resync["max_abs_err"]["params"], 0.0), ms=ms4, f32_ms=ms32_4,
                  plain_ms=plain4, bound_ms=k4_bound, bound_by=k4_by, registers=regs4,
                  f32_registers=regs4_32, resync=resync, free_running_outside=free)
    del data, adv, out, k, again
    torch.cuda.empty_cache()

    # The kind's bf16 training paths: the default (K2/K6 + K4) and the K3 loop.
    updates = WARMUP_UPDATES + TIMED_UPDATES if name == "quadrotor3d-v0" else BF16_UPDATES
    main_cfg = ppo.PpoConfig(num_envs=B_PPO, rollout_len=T_PPO, compute_dtype=BF16)
    runs = {}
    for label, c in (("default", main_cfg), ("K3 loop", main_cfg._replace(fused_update="off")),
                     ("float32", main_cfg._replace(compute_dtype="float32"))):
        runs[label] = training_phase(torch, dev, gpu, env, c, f"{name} {label} ppo update "
                                     f"({c.compute_dtype})", updates=updates)
    passes = main_cfg.num_epochs * main_cfg.num_minibatches
    quiet = {"K1": 0, "K5": 0, "K7": 0, "K8/K9": 0, "K10": 0, "K11": 0}
    require(runs["default"][0] == {**quiet, "K2": updates, "K3": 0, "K4": updates},
            f"{name} bf16 default path launches {runs['default'][0]}")
    require(runs["K3 loop"][0] == {**quiet, "K2": updates, "K3": updates * passes, "K4": 0},
            f"{name} bf16 K3 loop launches {runs['K3 loop'][0]}")
    rewards = {k: [s["mean_reward"] for s in v[2]] for k, v in runs.items()}
    for r, e in zip(rewards["default"], rewards["float32"]):
        require(abs(r - e) <= 0.1 * abs(e), f"{name} bf16 mean_reward {rewards}")
    timed = runs["default"][1][WARMUP_UPDATES:]
    say(f"{name} bf16 training: default path K2/K6 {runs['default'][0]['K2']} and K4 "
        f"{runs['default'][0]['K4']} launches in {updates} updates, the K3 loop K3 "
        f"{runs['K3 loop'][0]['K3']}; mean_reward per update bf16 "
        f"{[round(r, 4) for r in rewards['default']]}, float32 from the same state "
        f"{[round(r, 4) for r in rewards['float32']]} (rtol 0.1), the bf16 K3 loop "
        f"{[round(r, 4) for r in rewards['K3 loop']]}; bf16 update median "
        f"{statistics.median(timed):.2f} ms, float32 "
        f"{statistics.median(runs['float32'][1][WARMUP_UPDATES:]):.2f} ms; on {gpu}: ok")

    def entry(fn, source, replaces, numbers, launches, tolerance, at):
        return {"name": f"{fn} (bf16, {name})", "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": numbers["max_abs_err"],
                "tolerance": tolerance, "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
                "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
                "library_ms": None, "f32_ms": numbers["f32_ms"],
                "registers": numbers["registers"], "f32_registers": numbers["f32_registers"],
                "at": at}

    path = f"the bf16 training path of {name}"
    return [
        {**entry("ppo_rollout", "reinmav_tpu_torch/csrc/ppo_rollout.cu",
                 "reinmav_tpu/ops/pallas_ppo_rollout.py:703", rollout, runs["default"][0]["K2"],
                 "one step at a time from the twin's state over 32 steps: rtol 2e-4 atol 2e-5, "
                 "<= 0.1% of envs outside (the slung-load kinds 0, the env-steps near the tether "
                 "sphere skipped, as phase 21); free-running mismatches reported",
                 f"states ({d}, {B_PPO}), horizon {T_PPO}; launches on {path}"),
         "mismatched_envs_free_running": mismatched, "resync_outside": outside,
         "value_bits_apart_resync": v_apart, "bits_apart": apart},
        entry("ppo_loss_grads_gather", "reinmav_tpu_torch/csrc/ppo_loss.cu",
              "reinmav_tpu/ops/pallas_ppo.py:424", loss, runs["K3 loop"][0]["K3"],
              "grads rtol 2e-3 atol 2e-6, metrics rtol 2e-4 atol 1e-6, bitwise repeatable",
              f"minibatch of {mb} samples, obs {d}, action {a}; launches on {path} with "
              f"fused_update=\"off\""),
        {**entry("ppo_update", "reinmav_tpu_torch/csrc/ppo_update.cu",
                 "reinmav_tpu/ops/pallas_ppo_update.py:304", update, runs["default"][0]["K4"],
                 "resynchronised: each pass from the twin's state, the samples within 16 ulps of "
                 "the ratio or value clip replaced; gradient rtol 2e-3 atol 2e-6, params rtol 2e-4 "
                 "atol 1e-6, moments rtol 2e-4 atol 5e-8; max_abs_err the params' there",
                 f"{e_ * m_} passes of {mb4} samples; launches on {path}"),
         "resync": resync, "free_running_outside": free},
    ]


def bf16_offpolicy_phase(torch, dev, gpu: str, env, timed_mode: str) -> dict:
    """Phase 37 for one kind: K7's bf16 instance against its bf16 twin in
    the five mode legs of phase 15 at B_OFF envs, 2 x 256, timed in turns
    with the float32 instance in the kind's training mode; then the bf16
    off-policy training path (SAC on the hover task at the bench config,
    else 3 iterations of the kind's learner), K7 once an iteration.
    Returns the entry of the ``kernels`` line."""
    from reinmav_tpu_torch.ops import offpolicy as op
    from reinmav_tpu_torch.rl import sac, td3

    d, a, name = env.obs_dim, env.action_dim, env.name
    states_t = k7_states(torch, env, torch.Generator(device=dev).manual_seed(37))
    errs, mismatches, apart, timed = [], [], [], None
    for mode, warm, noise in K7_MODES:
        args = k7_args(torch, env, states_t, mode, warm, noise)
        new_k, blk_k = op.collect_step(*args, compute_dtype=BF16)
        new_p, blk_p = op.collect_step_reference(*args, compute_dtype=BF16)
        torch.cuda.synchronize()
        bad = ~(torch.isclose(new_k, new_p, **TOL).all(dim=0)
                & torch.isclose(blk_k, blk_p, **TOL).all(dim=0))
        mismatched, ok = int(bad.sum()), ~bad
        err = max(float((new_k[:, ok] - new_p[:, ok]).abs().max()),
                  float((blk_k[:, ok] - blk_p[:, ok]).abs().max()))
        again = op.collect_step(*args, compute_dtype=BF16)
        require(torch.equal(new_k, again[0]) and torch.equal(blk_k, again[1]),
                f"K7 bf16 {name} {mode}: bitwise equal on a rerun")
        require(mismatched <= 0.001 * B_OFF, f"K7 bf16 {name} {mode}: {mismatched} envs mismatched")
        require(bool(torch.isfinite(blk_k).all()), f"K7 bf16 {name} {mode}: a finite block")
        n_apart = bits_apart(torch, blk_k[d:d + a], blk_p[d:d + a])
        say(f"K7 bf16 vs bf16 twin, {name}, mode {mode}, warm {warm:g}: {mismatched} of {B_OFF} "
            f"envs mismatched (limit 0.1%), on the others max |err| {err:.3e}; action entries "
            f"whose bits differ {n_apart}; bitwise equal on a rerun: ok")
        errs.append(err)
        mismatches.append(mismatched)
        apart.append(n_apart)
        if (mode, warm) == (timed_mode, 0.0):
            timed = args, (new_k, blk_k)
    args, (new_k, blk_k) = timed
    (ms32, _, _), (ms, lo, hi) = in_turns(torch, lambda: op.collect_step(*args),
                                          lambda: op.collect_step(*args, compute_dtype=BF16))
    plain = [cuda_ms(lambda: op.collect_step_reference(*args, compute_dtype=BF16), 1)[0][0]
             for _ in range(2)]
    w1, _, w2, _, w3, _ = args[6:]
    prod = 2 * (d * w1.shape[1] + w2.shape[0] * w2.shape[1] + w3.shape[0] * w3.shape[1]) * B_OFF
    k7_b, k7_by = bound_bf16(nbytes(states_t, new_k, blk_k, args[4], *args[6:]), prod,
                             OPS_ENV_STEP[d] * B_OFF)
    inst, inst32 = k7_instance(name, timed_mode, bf16=True), k7_instance(name, timed_mode)
    regs = kernel_registers(inst) if inst else "not reported"
    regs32 = kernel_registers(inst32) if inst32 else "not reported"
    say(f"time K7 {name} {timed_mode}, B={B_OFF} H={H_SAC}: bf16 {ms:.4f} ms ({lo:.4f} to "
        f"{hi:.4f}), float32 {ms32:.4f} ms in turns, 20 launches each; bf16 twin "
        f"{statistics.median(plain):.2f} ms; bf16 bound {k7_b:.4f} ms by {k7_by}; {inst}: ptxas "
        f"{regs}; float32 {regs32}; on {gpu}")

    # The bf16 off-policy training path of the kind.
    if name == HOVER:
        module, iters = sac, BF16_SAC_ITERS
        cfg = sac.SacConfig(num_envs=B_OFF, batch_size=BATCH_SAC, buffer_capacity=RING_SAC,
                            hidden=(H_SAC, H_SAC), warmup_steps=0, compute_dtype=BF16)
    else:
        module, iters = (td3, sac)[timed_mode == "sac"], BF16_OFF_ITERS
        cls = sac.SacConfig if module is sac else td3.Td3Config
        cfg = cls(num_envs=B_OFF, batch_size=BATCH_SAC, buffer_capacity=RING_SAC,
                  hidden=(H_SAC, H_SAC), warmup_steps=0, compute_dtype=BF16)
    state = module.init_state(env, cfg, seed=0, device=dev)
    state, _, _, _ = offpolicy_iterations(torch, env, cfg, module, state, BF16_SAC_WARMUP)
    state, met, wall, launches = offpolicy_iterations(torch, env, cfg, module, state, iters)
    require(launches["K7"] == iters and sum(launches.values()) == iters,
            f"{name} bf16 off-policy launches {launches}")
    require(all(math.isfinite(v) for v in met.values()) and state.actor.dtype == torch.float32
            and bool(torch.isfinite(state.actor).all()), f"{name} bf16 off-policy metrics {met}")
    say(f"{name} bf16 {module.__name__.split('.')[-1]} training path, B={B_OFF} batch {BATCH_SAC} "
        f"2 x {H_SAC}: K7 launches {launches['K7']} in {iters} iterations, "
        f"{wall / iters:.3f} ms per iteration, {iters * B_OFF / wall * 1e3:.4e} env-steps/s; "
        f"metrics " + ", ".join(f"{k} {v:.5g}" for k, v in met.items()) + f"; on {gpu}: ok")
    del state
    torch.cuda.empty_cache()
    return {"name": f"offpolicy_collect (bf16, {name})", "route": "cuda",
            "source": "reinmav_tpu_torch/csrc/offpolicy_collect.cu",
            "replaces": "reinmav_tpu/ops/pallas_offpolicy.py:155", "launches": launches["K7"],
            "max_abs_err": max(errs), "mismatched_envs": max(mismatches),
            "action_bits_apart": apart,
            "tolerance": "rtol 2e-4 atol 2e-5 per env over its block and new state, <= 0.1% of "
                         "envs may differ, in five mode legs; bitwise repeatable",
            "ms": ms, "plain_ms": statistics.median(plain), "bound_ms": k7_b, "bound_by": k7_by,
            "library_ms": None, "f32_ms": ms32, "registers": regs, "f32_registers": regs32,
            "at": f"states ({d}, {B_OFF}), actor {d}-{H_SAC}-{H_SAC}-{w3.shape[1]}, mode "
                  f"{timed_mode}; launches on the bf16 {module.__name__.split('.')[-1]} path"}


def bf16_cli_phase(gpu: str) -> None:
    """Phase 38: the training CLI once with --compute_dtype=bfloat16, in a
    subprocess, at B_PPO x T_PPO for 3 updates."""
    root = Path(__file__).resolve().parent
    steps = 3 * B_PPO * T_PPO
    cmd = [sys.executable, "-m", "reinmav_tpu_torch.rl.run", "--compute_dtype=bfloat16",
           f"--num_env={B_PPO}", f"--rollout_len={T_PPO}", f"--num_timesteps={steps}",
           "--log_interval=1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(f"the bf16 CLI exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    train = [row for row in rows if "env_steps" in row]
    require(bool(train) and train[-1]["env_steps"] == steps and
            all(math.isfinite(v) for v in train[-1].values()), "the bf16 CLI's metrics")
    say(f"cli bf16: exit 0 in {time.perf_counter() - t0:.1f} s on {gpu}; last line "
        f"{json.dumps(train[-1])}")


def bf16_phases(torch, dev, gpu: str) -> list[dict]:
    """Phases 34-38 and their wall: the bf16 instances of K2/K6, K3 and K4
    on every kind (34-36), of K7 on every kind (37), with each kind's bf16
    training paths; the bf16 CLI (38).  Returns their entries of the
    ``kernels`` line."""
    import reinmav_tpu_torch

    t0 = time.perf_counter()
    entries = []
    for name in PPO_STRUCT:
        env = reinmav_tpu_torch.make(name)
        entries += bf16_kind_phase(torch, dev, gpu, env, HOVER_RET_VAR if name == HOVER else 4.0)
    for name in PPO_STRUCT:
        entries.append(bf16_offpolicy_phase(torch, dev, gpu, reinmav_tpu_torch.make(name),
                                            "td3" if name == "quadrotor3d-v0" else "sac"))
    bf16_cli_phase(gpu)
    say(f"phases 34-38 (compute_dtype bfloat16): {time.perf_counter() - t0:.1f} s on {gpu}")
    return entries


# Phases 39-44: the multi-rank paths (reinmav_tpu_torch.parallel), each
# rank a process spawned with the "spawn" start method after the library
# was built (a rank loads it, never builds it), its group formed from
# torchrun's variables: NCCL at one rank, gloo for two ranks on the one
# card (NCCL takes one rank a device).
PAR_UPDATES = 3  # PPO updates of each leg; the first is the warm-up
PAR_SAC_WARMUP, PAR_SAC_ITERS = 2, 20
PAR_TD3 = dict(num_envs=8192, batch_size=1024, buffer_capacity=1 << 16, warmup_steps=0)
PAR_TD3_ITERS = 5
PAR_CKPT = dict(num_envs=4096, rollout_len=16)
#: The examples' sizes on the card: their full size where that takes
#: seconds, else their reduced size (``--quick``): the eager loops of one
#: env launch a kernel an operation (control_quat about 23 ms a step on the
#: card), so the controllers fly 150 of their steps and reinmav-v0 (50
#: substeps a step) 50 of its 400.  The final radius of the demos' 0.5 m
#: circle: the mass-blind geometric controller flies about 0.41 m, the
#: lagging PID 0.58-0.66 m (both from 150 steps on).
PAR_EXAMPLE_STEPS = {"control_quat": 150, "control_rpy": 150, "reinmav_sim": 50}
CIRCLE_TOL = 0.2


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(torch, task: str, world: int, out_dir: Path) -> list:
    """Run ``task`` on ``world`` spawned ranks; returns each rank's result
    (what the task returned)."""
    import torch.multiprocessing as mp

    port = free_port()
    mp.spawn(rank_main, args=(world, port, task, str(out_dir)), nprocs=world, join=True,
             start_method="spawn")
    return [torch.load(out_dir / f"{task}_rank{r}.pt", weights_only=False) for r in range(world)]


def rank_main(rank: int, world: int, port: int, task: str, out_dir: str) -> None:
    """One spawned rank: torchrun's variables, the group
    (``distributed.init()`` in auto-detect mode), ``task``, its result
    saved for the parent.  Rank 0 logs the learners' paths."""
    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rank == 0:
        logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                            format=f"log[rank {rank} of {world}]: %(name)s: %(message)s")
    from reinmav_tpu_torch.parallel import distributed, make_mesh

    distributed.init(device="cuda")
    mesh = make_mesh()
    out = RANK_TASKS[task](torch, mesh)
    torch.save(out, Path(out_dir) / f"{task}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def ppo_leg(torch, step, state, updates: int = PAR_UPDATES) -> dict:
    """``updates`` calls of ``step`` from ``state`` with every kernel count
    and the collective counts set to 0 just before: the launches, the
    collectives, each update's wall (synchronised), summary and params."""
    from reinmav_tpu_torch.parallel import COLLECTIVES

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    COLLECTIVES.clear()
    walls, summaries, params = [], [], []
    for _ in range(updates):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, summary = step(state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        summaries.append({k: float(v) for k, v in summary.items()})
        params.append(state.params.detach().cpu().clone())
    require(all(math.isfinite(v) for s in summaries for v in s.values()), "finite metrics")
    return {"launches": {k: fn.launches for k, fn in counters.items() if fn.launches},
            "collectives": dict(COLLECTIVES), "walls": walls,
            "ms": statistics.median(walls[1:]), "summaries": summaries, "params": params,
            "state": state}


def ppo_setup(torch, mesh, num_envs: int | None = None, rollout_len: int | None = None,
              seed: int = 0):
    """quadrotor3d-v0, the PPO config (the bench shape by default) and a
    maker of this rank's shard of a fresh state of ``seed``."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.parallel import shard_state
    from reinmav_tpu_torch.rl import ppo

    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=num_envs or B_PPO, rollout_len=rollout_len or T_PPO)
    return env, cfg, lambda s=seed: shard_state(
        mesh, ppo.init_train_state(env, cfg, s, device=mesh.device))


def strip(leg: dict) -> dict:
    return {k: v for k, v in leg.items() if k != "state"}


def task_nccl1(torch, mesh) -> dict:
    """Phase 39, one rank on NCCL at the bench config: the unsharded step,
    the mesh mode (bitwise the unsharded step, K2 + K4 an update) and the
    shard_map step (K2 + 16 K3 an update, NCCL all-reduces)."""
    from reinmav_tpu_torch.rl import ppo

    require(mesh.backend == "nccl" and mesh.world_size == 1, f"one rank on NCCL, got {mesh}")
    env, cfg, fresh = ppo_setup(torch, mesh)
    plain = ppo_leg(torch, lambda s: ppo.train_step(env, cfg, s), fresh())
    meshed = ppo_leg(torch, lambda s: ppo.mesh_train_step(env, cfg, s, mesh), fresh())
    shardmap = ppo_leg(torch, lambda s: ppo.train_step(env, cfg, s, axis=mesh), fresh())
    return {"plain": strip(plain), "mesh": strip(meshed), "shard_map": strip(shardmap)}


def offpolicy_leg(torch, mesh, module, env_id: str, cfg, iters: int, warmup: int = 0) -> dict:
    """A sharded off-policy run: ``warmup`` iterations, then ``iters`` timed
    with the kernel counts set to 0 just before."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.parallel import COLLECTIVES, shard_state

    env = reinmav_tpu_torch.make(env_id)
    state = shard_state(mesh, module.init_state(env, cfg, 0, device=mesh.device))
    if warmup:
        state, _ = module.train_iters(env, cfg, state, warmup, axis=mesh)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    COLLECTIVES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = module.train_iters(env, cfg, state, iters, axis=mesh)  # reads the host
    wall = (time.perf_counter() - t0) * 1e3
    require(all(math.isfinite(v) for v in metrics.values()), f"{env_id}: finite metrics")
    return {"launches": {k: fn.launches for k, fn in counters.items() if fn.launches},
            "collectives": dict(COLLECTIVES), "ms_per_iteration": wall / iters,
            "actor": digest(state.actor, state.critics), "metrics": metrics,
            "b_local": state.env_states.shape[0], "ring_columns": state.buffer.shape[1]}


def checkpoint_path() -> Path:
    return Path(__file__).resolve().parent / "chiprun_out" / "smoke_parallel_ckpt"


def state_digest(state) -> str:
    return digest(*[x if hasattr(x, "numel") else __import__("torch").as_tensor(x)
                    for x in _leaves(state)])


def dense_leg(torch, mesh) -> dict:
    """Phase 40's closed-loop leg: ``sharded_dense_rollout`` of this rank's
    half of B_MAIN quadrotor3d-v0 envs for T_MAIN steps, K1 on the rank's
    shard, with the kernel counts set to 0 just before; a second call from
    the same states and seed must be bitwise the first."""
    import reinmav_tpu_torch
    from reinmav_tpu_torch.parallel import COLLECTIVES, sharded_dense_rollout

    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    states = env.vreset(torch.Generator(device=mesh.device).manual_seed(3), B_MAIN,
                        device=mesh.device)[mesh.shard(B_MAIN)].contiguous()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    COLLECTIVES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, rewards = sharded_dense_rollout(env, mesh, states, 7, T_MAIN)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    t0 = time.perf_counter()
    again = sharded_dense_rollout(env, mesh, states, 7, T_MAIN)
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t0) * 1e3
    require(bool(torch.isfinite(final).all() and torch.isfinite(rewards).all()),
            "phase 40: the sharded dense rollout's states and rewards are finite")
    require(torch.equal(final, again[0]) and torch.equal(rewards, again[1]),
            "phase 40: the sharded dense rollout is not deterministic per (seed, world size)")
    return {"launches": launches, "collectives": dict(COLLECTIVES), "ms": wall, "ms_warm": warm,
            "b_local": states.shape[0], "digest": digest(final, rewards),
            "mean_reward": float(rewards.mean())}


def task_gloo2(torch, mesh) -> dict:
    """Phases 40-42, two ranks on the one card over gloo: the closed-loop
    dense rollout (K1 a rank), the shard_map and mesh PPO legs at 16,384
    of the 32,768 envs each, SAC at the bench config split, TD3 small, and
    the checkpoint's save."""
    from reinmav_tpu_torch.rl import ppo, sac, td3
    from reinmav_tpu_torch.utils import checkpoint as ckpt

    require(mesh.backend == "gloo" and mesh.world_size == 2, f"two gloo ranks, got {mesh}")
    dense = dense_leg(torch, mesh)
    env, cfg, fresh = ppo_setup(torch, mesh)
    shardmap = ppo_leg(torch, lambda s: ppo.train_step(env, cfg, s, axis=mesh), fresh())
    shardmap["digest"] = digest(shardmap["state"].params, shardmap["state"].opt_state.mu)
    meshed = ppo_leg(torch, lambda s: ppo.mesh_train_step(env, cfg, s, mesh), fresh())
    sac_cfg = sac.SacConfig(num_envs=B_OFF, batch_size=BATCH_SAC, buffer_capacity=RING_SAC,
                            hidden=(H_SAC, H_SAC), warmup_steps=0)
    sac_leg = offpolicy_leg(torch, mesh, sac, HOVER, sac_cfg, PAR_SAC_ITERS, PAR_SAC_WARMUP)
    td3_leg = offpolicy_leg(torch, mesh, td3, "quadrotor3d-v0", td3.Td3Config(**PAR_TD3),
                            PAR_TD3_ITERS)
    # The checkpoint: 4 shard_map updates straight, and 2, a collective save.
    env_c, cfg_c, fresh_c = ppo_setup(torch, mesh, **PAR_CKPT)
    step = ppo.make_train_step_shardmap(env_c, cfg_c, mesh)
    straight, state = fresh_c(5), fresh_c(5)
    for _ in range(4):
        straight, _ = step(straight)
    for _ in range(2):
        state, _ = step(state)
    ckpt.save(str(checkpoint_path()), state, mesh)
    return {"dense": dense, "shard_map": strip(shardmap), "mesh": strip(meshed), "sac": sac_leg,
            "td3": td3_leg, "ckpt_ref": state_digest(straight)}


def task_restore(torch, mesh) -> dict:
    """Phase 42's second half: a fresh group restores the checkpoint into
    states of another seed and runs the last 2 updates."""
    from reinmav_tpu_torch.rl import ppo
    from reinmav_tpu_torch.utils import checkpoint as ckpt

    env_c, cfg_c, fresh_c = ppo_setup(torch, mesh, **PAR_CKPT)
    state = ckpt.restore(str(checkpoint_path()), fresh_c(6), mesh)
    require(state.env_states.device == mesh.device, "restored onto the rank's card")
    step = ppo.make_train_step_shardmap(env_c, cfg_c, mesh)
    for _ in range(2):
        state, _ = step(state)
    return {"resumed": state_digest(state)}


RANK_TASKS = {"nccl1": task_nccl1, "gloo2": task_gloo2, "restore": task_restore}


def collectives_per_update(leg: dict) -> dict:
    return {k: v / PAR_UPDATES for k, v in leg["collectives"].items()}


def parallel_cli_phase(gpu: str) -> float:
    """Phase 43: the CLI on two ranks under ``torch.distributed.run`` with
    ``--shard_map``: rank 0 logs each update, rank 1 nothing."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "reinmav_tpu_torch.rl.run", "--shard_map", f"--num_env={B_PPO}",
           f"--rollout_len={T_PPO}", f"--num_timesteps={PAR_UPDATES * B_PPO * T_PPO}",
           "--log_interval=1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the two-rank CLI exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    steps = [row["env_steps"] for row in rows if "env_steps" in row]
    require(steps == [float(B_PPO * T_PPO * (i + 1)) for i in range(PAR_UPDATES)],
            f"rank 0 alone logs one line an update: {steps}")
    require(all(math.isfinite(v) for row in rows for v in row.values()), "the CLI's metrics")
    say(f"phase 43, cli: torch.distributed.run --nproc_per_node=2 -m reinmav_tpu_torch.rl.run "
        f"--shard_map, {PAR_UPDATES} updates at {B_PPO} x {T_PPO}: exit 0 in {wall:.1f} s, "
        f"{len(steps)} metric lines (rank 0 only) on {gpu}; last {json.dumps(rows[-1])}")
    return wall


def examples_phase(torch, dev, gpu: str) -> dict:
    """Phase 44: the examples on the card, their simulations at
    :data:`PAR_EXAMPLE_STEPS`, PPO at its full size (K6 and K4 once an
    update); their plots and the gymnasium loop where the packages are
    installed, else their refusal by name."""
    from reinmav_tpu_torch.examples import (control_quat, control_rpy, reinmav_sim,
                                            train_quadrotor2d_ppo, train_vector_env)

    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    for name, module in (("control_quat", control_quat), ("control_rpy", control_rpy)):
        steps = PAR_EXAMPLE_STEPS[name]
        traj = timed(name, lambda: module.simulate(steps, dev))
        final = traj[-1].cpu()
        radius = math.hypot(float(final[0]), float(final[1]))
        require(traj.device.type == "cuda" and bool(torch.isfinite(traj).all()), f"{name} finite")
        require(abs(radius - 0.5) < CIRCLE_TOL,
                f"{name}: final radius {radius} on the 0.5 m circle (+- {CIRCLE_TOL})")
        say(f"phase 44, {name}: {steps} steps on the card in {walls[name]:.2f} s, final position "
            f"{[round(float(v), 4) for v in final[:3]]}, radius {radius:.4f} (circle 0.5) on {gpu}")
    steps = PAR_EXAMPLE_STEPS["reinmav_sim"]
    traj, desired = timed("reinmav_sim", lambda: reinmav_sim.simulate(steps, dev))
    err = float((traj[:, :3] - desired[:, :3]).abs().max())
    require(err < 0.01, f"reinmav_sim: |x - x_des| {err}")
    say(f"phase 44, reinmav_sim: {steps} steps on the card in {walls['reinmav_sim']:.2f} s, max "
        f"|x - x_des| {err:.3e} on {gpu}")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    rewards, ret = timed("train_quadrotor2d_ppo",
                         lambda: train_quadrotor2d_ppo.main(["--device=cuda"]))
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    n = len(rewards)
    require(launches == {"K2": n, "K4": n}, f"train_quadrotor2d_ppo: K6 + K4 an update, {launches}")
    require(all(math.isfinite(r) for r in rewards) and math.isfinite(ret), "finite rewards")
    say(f"phase 44, train_quadrotor2d_ppo: {n} updates at 512 x 64 and a 1000-step play in "
        f"{walls['train_quadrotor2d_ppo']:.2f} s, launches {launches}, mean_reward "
        f"{rewards[0]:.4f} -> {rewards[-1]:.4f}, play return {ret:.3f} on {gpu}")
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "examples"
    for name, module, package in (("control_quat", control_quat, "matplotlib"),
                                  ("train_vector_env", train_vector_env, "gymnasium")):
        argv = ["--quick", f"--out_dir={out_dir}"]
        if has_module(package):
            module.main(argv)
            say(f"phase 44, {name} --quick: ran ({package} installed)")
            continue
        try:
            module.main(argv)
        except SystemExit as e:
            require(f"needs {package}, which is not installed" in str(e), f"{name}: {e}")
            say(f"phase 44, {name}: refuses by name: {e}")
        else:
            raise RuntimeError(f"{name} ran without {package}")
    return walls


def parallel_phases(torch, dev, gpu: str) -> dict:
    """Phases 39-44 and their wall; returns what the kernels line records
    of them."""
    from reinmav_tpu_torch.rl import ppo

    t0 = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "smoke_parallel"
    out_dir.mkdir(parents=True, exist_ok=True)
    # 39. One rank on NCCL.
    walls = {}
    t1 = time.perf_counter()
    (one,) = spawn_ranks(torch, "nccl1", 1, out_dir)
    walls["39"] = time.perf_counter() - t1
    plain, meshed, sm = one["plain"], one["mesh"], one["shard_map"]
    for i, (a, b) in enumerate(zip(plain["params"], meshed["params"])):
        require(torch.equal(a, b), f"phase 39: the mesh step's params after update {i + 1} are "
                                   "not bitwise the unsharded step's")
    require(meshed["launches"] == {"K2": PAR_UPDATES, "K4": PAR_UPDATES},
            f"phase 39: mesh mode launches {meshed['launches']}")
    require(sm["launches"] == {"K2": PAR_UPDATES, "K3": 16 * PAR_UPDATES},
            f"phase 39: shard_map launches {sm['launches']}")
    require(sm["collectives"].get("all_reduce", 0) >= 16 * PAR_UPDATES,
            f"phase 39: shard_map all-reduces {sm['collectives']}")
    for i, (a, b) in enumerate(zip(plain["summaries"], sm["summaries"])):
        rel = abs(b["mean_reward"] - a["mean_reward"]) / abs(a["mean_reward"])
        require(rel <= 0.1, f"phase 39: update {i} mean_reward {b['mean_reward']} vs the "
                            f"unsharded {a['mean_reward']}")
    say(f"phase 39, one rank on NCCL, B={B_PPO} T={T_PPO}: unsharded {plain['ms']:.2f} ms an "
        f"update; mesh mode {meshed['ms']:.2f} ms, bitwise the unsharded step over "
        f"{PAR_UPDATES} updates, launches {meshed['launches']}, collectives an update "
        f"{collectives_per_update(meshed)}; shard_map {sm['ms']:.2f} ms, launches "
        f"{sm['launches']}, collectives an update {collectives_per_update(sm)}, mean_reward "
        f"{[round(s['mean_reward'], 4) for s in sm['summaries']]} vs unsharded "
        f"{[round(s['mean_reward'], 4) for s in plain['summaries']]} (within 10%) on {gpu}")
    # 40-42. Two ranks over gloo on the one card.
    t1 = time.perf_counter()
    two = spawn_ranks(torch, "gloo2", 2, out_dir)
    walls["40-42a"] = time.perf_counter() - t1
    dense = [two[r]["dense"] for r in range(2)]
    for r in range(2):
        require(dense[r]["launches"] == {"K1": 1} and not dense[r]["collectives"],
                f"phase 40: rank {r}'s dense rollout launches {dense[r]['launches']} and "
                f"collectives {dense[r]['collectives']} (K1 once, none)")
    require(dense[0]["digest"] != dense[1]["digest"],
            "phase 40: the two ranks' dense rollouts are equal")
    say(f"phase 40, sharded_dense_rollout on two gloo ranks, {dense[0]['b_local']} of the "
        f"{B_MAIN} quadrotor3d-v0 envs each, T={T_MAIN}: K1 once a rank, no collective, "
        f"{[round(d['ms'], 3) for d in dense]} ms on the rank's first kernel call (the library's "
        f"load in it), {[round(d['ms_warm'], 3) for d in dense]} ms on the rerun (synchronised, "
        f"both ranks at once), bitwise equal ({dense[0]['digest']}, {dense[1]['digest']}), "
        f"mean reward sums "
        f"{[round(d['mean_reward'], 3) for d in dense]} on {gpu}")
    require(two[0]["shard_map"]["digest"] == two[1]["shard_map"]["digest"],
            "phase 40: the shard_map replicas' params differ")
    for r in range(2):
        require(two[r]["shard_map"]["launches"] == {"K2": PAR_UPDATES, "K3": 16 * PAR_UPDATES},
                f"phase 40: rank {r} shard_map launches {two[r]['shard_map']['launches']}")
        require(two[r]["mesh"]["launches"] == {"K2": PAR_UPDATES, "K4": PAR_UPDATES},
                f"phase 40: rank {r} mesh launches {two[r]['mesh']['launches']}")
    # The one-rank run of the mesh mode (one rank, no group: the plain step).
    import reinmav_tpu_torch

    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=B_PPO, rollout_len=T_PPO)
    ref = ppo.init_train_state(env, cfg, 0, device=dev)
    ref_params = []
    for _ in range(PAR_UPDATES):
        ref, _ = ppo.train_step(env, cfg, ref)
        ref_params.append(ref.params.cpu())
    for r in range(2):
        require(all(torch.equal(a, b) for a, b in zip(two[r]["mesh"]["params"],
                                                      two[0]["mesh"]["params"])),
                "phase 40: the mesh replicas' params differ")
    require(torch.equal(two[0]["mesh"]["params"][0], ref_params[0]),
            "phase 40: the two-rank mesh mode's first update is not bitwise the one-rank run's")
    mesh_diff = [float((a - b).abs().max()) for a, b in zip(two[0]["mesh"]["params"], ref_params)]
    require(all(torch.allclose(a, b, **UPDATE_TOL)
                for a, b in zip(two[0]["mesh"]["params"], ref_params)),
            f"phase 40: the mesh mode against the one-rank run, max |diff| {mesh_diff}")
    say(f"phase 40, two gloo ranks on one card, {B_PPO // 2} of the {B_PPO} envs each: shard_map "
        f"{[round(two[r]['shard_map']['ms'], 2) for r in range(2)]} ms an update, replicas "
        f"bitwise equal after {PAR_UPDATES} updates (params and Adam mu {two[0]['shard_map']['digest']}), "
        f"launches a rank {two[0]['shard_map']['launches']}, collectives an update "
        f"{collectives_per_update(two[0]['shard_map'])}; mesh mode "
        f"{[round(two[r]['mesh']['ms'], 2) for r in range(2)]} ms an update, launches a rank "
        f"{two[0]['mesh']['launches']}, against the one-rank run: update 1 bitwise, max |diff| "
        f"by update {mesh_diff} (the moment sums add per rank; rtol 2e-4 atol 1e-6) on {gpu}")
    for name, n in (("sac", PAR_SAC_ITERS), ("td3", PAR_TD3_ITERS)):
        legs = [two[r][name] for r in range(2)]
        require(legs[0]["actor"] == legs[1]["actor"], f"phase 41: the {name} replicas differ")
        require(all(leg["launches"] == {"K7": n} for leg in legs),
                f"phase 41: {name} launches {[leg['launches'] for leg in legs]}")
        say(f"phase 41, {name} on two gloo ranks, {legs[0]['b_local']} envs and "
            f"{legs[0]['ring_columns']} ring columns a rank: {n} iterations, K7 {n} a rank, "
            f"{[round(leg['ms_per_iteration'], 2) for leg in legs]} ms an iteration, collectives "
            f"an iteration {({k: v / n for k, v in legs[0]['collectives'].items()})}, actor and "
            f"critics bitwise equal ({legs[0]['actor']}), mean_reward "
            f"{legs[0]['metrics']['mean_reward']:.5g} on {gpu}")
    t1 = time.perf_counter()
    resumed = spawn_ranks(torch, "restore", 2, out_dir)
    walls["42b"] = time.perf_counter() - t1
    for r in range(2):
        require(resumed[r]["resumed"] == two[r]["ckpt_ref"],
                f"phase 42: rank {r}'s resume differs from the uninterrupted run")
    say(f"phase 42, collective checkpoint on two ranks ({PAR_CKPT['num_envs']} x "
        f"{PAR_CKPT['rollout_len']}): 2 updates, save, a fresh group restores into a seed-6 "
        f"state, 2 more: bitwise the 4 uninterrupted, each rank ({two[0]['ckpt_ref']}, "
        f"{two[1]['ckpt_ref']}) on {gpu}")
    walls["43"] = parallel_cli_phase(gpu)
    example_walls = examples_phase(torch, dev, gpu)
    wall = time.perf_counter() - t0
    say(f"phases 39-44 (multi-rank paths, examples): {wall:.1f} s on {gpu}; spawned ranks and "
        f"the CLI by phase {json.dumps({k: round(v, 1) for k, v in walls.items()})} s, examples "
        f"{json.dumps({k: round(v, 2) for k, v in example_walls.items()})} s")
    return {
        "quad3d_rollout_autoreset": {"gloo2_dense_a_rank": two[0]["dense"]["launches"]["K1"]},
        "ppo_rollout": {"nccl1_mesh": meshed["launches"]["K2"], "nccl1_shard_map":
                        sm["launches"]["K2"], "gloo2_shard_map_a_rank":
                        two[0]["shard_map"]["launches"]["K2"], "gloo2_mesh_a_rank":
                        two[0]["mesh"]["launches"]["K2"]},
        "ppo_loss_grads_gather": {"nccl1_shard_map": sm["launches"]["K3"],
                                  "gloo2_shard_map_a_rank": two[0]["shard_map"]["launches"]["K3"]},
        "ppo_update": {"nccl1_mesh": meshed["launches"]["K4"],
                       "gloo2_mesh_a_rank": two[0]["mesh"]["launches"]["K4"]},
        "offpolicy_collect (MujocoQuadForce-v1)": {"gloo2_sac_a_rank":
                                                   two[0]["sac"]["launches"]["K7"]},
        "offpolicy_collect (quadrotor3d-v0)": {"gloo2_td3_a_rank": two[0]["td3"]["launches"]["K7"]},
    }


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=("hashes", "bf16", "parallel"),
                        help="after phases 1-3, run only the digests and times of K1 and "
                        "K2/K6 (hashes), phases 34-38 and their kernels line (bf16), or phases "
                        "39-44 (parallel); print no result line")
    only = parser.parse_args(argv).only

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
    for line in _build.ptxas_report():
        say(line)
    for name in ("hover_rollout_kernel", *K10_KERNELS):
        say(f"sass: {name}: substep loop {substep_sass(name)}")
    for name in NATIVE:
        say(f"sass: {closed_loop_kernel_name(name)}: horizon loop {horizon_sass(name)}")
    say(f"sass: {k1_kernel_name()}: horizon loop {loop_sass(k1_kernel_name())}")
    for name in PPO_STRUCT:
        say(f"sass: {ppo_instance(name)}: horizon loop {ppo_sass(name)}")

    # 3. Philox known answers, on the device through the kernel library.
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))]
    got = ro.philox4x32_10(torch.tensor([c for c, _, _ in kat], device=dev),
                           torch.tensor([k for _, k, _ in kat], device=dev))
    for row, (_, _, expected) in zip(got.tolist(), kat):
        require(tuple(row) == expected, f"philox KAT {[hex(v) for v in row]} != {expected}")
    say("philox4x32-10 known answers: ok (zero and all-ones counter/key, on the device)")
    if only == "hashes":
        hash_phase(torch, dev, gpu)
        return 0
    if only == "bf16":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        say(json.dumps({"kernels": bf16_phases(torch, dev, gpu)}))
        return 0
    if only == "parallel":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        say(json.dumps({"launches_sharded": parallel_phases(torch, dev, gpu)}))
        return 0

    # 4. K1 against its plain twin.  The slice has no matmul; TF32 is set
    # off anyway, so that no reference here can run in reduced precision.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1234)
    tame, full = k1_check_states(torch, gen)
    f_k, r_k = ro.quad3d_rollout_autoreset(tame, 17, T_NO_RESET, autoreset=False)
    f_p, r_p = ro.quad3d_rollout_reference(tame, 17, T_NO_RESET, autoreset=False)
    torch.cuda.synchronize()
    err_no_reset = float((f_k - f_p).abs().max())
    reward_rel = abs(float(r_k.double().sum() - r_p.double().sum())) / abs(float(r_p.double().sum()))
    require(torch.allclose(f_k, f_p, **TOL), "no-reset leg final states")
    require(reward_rel <= RTOL_REWARD, f"no-reset leg reward total, rel err {reward_rel}")
    say(f"K1 vs twin, no reset, B={B_CHECK} T={T_NO_RESET}: max |err| {err_no_reset:.3e}, "
        f"reward total rel err {reward_rel:.3e} (rtol 2e-4 atol 2e-5; reward rtol 1e-4): ok")
    say(f"sha256 K1 no reset B={B_CHECK} T={T_NO_RESET} (seed 17): {digest(f_k, r_k)}")

    f_k, r_k = ro.quad3d_rollout_autoreset(full, 99, T_RESET)
    f_p, r_p = ro.quad3d_rollout_reference(full, 99, T_RESET)
    torch.cuda.synchronize()
    mismatched = int((~torch.isclose(f_k, f_p, **TOL).all(dim=0)).sum())
    reward_rel_reset = (abs(float(r_k.double().sum() - r_p.double().sum()))
                        / abs(float(r_p.double().sum())))
    say(f"sha256 K1 auto-reset B={B_CHECK} T={T_RESET} (seed 99): {digest(f_k, r_k)}")
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
    with SmClock() as clock:
        kern0, (f_k, r_k) = cuda_ms(kernel_run, 5)
        kern1, _ = cuda_ms(kernel_run, 5)
    (plain1,), _ = cuda_ms(plain_run, 1)
    say(f"sha256 K1 auto-reset B={B_MAIN} T={T_MAIN} (seed 7): {digest(f_k, r_k)}")
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
    k1_sass = k1_sass_line(kernel_ms, clock, gpu)

    k1_bound, k1_by = bound(nbytes(big_t, f_k, r_k), OPS_K1 * B_MAIN * T_MAIN)
    kernels = [{
        "name": "quad3d_rollout_autoreset",
        "route": "cuda",
        "source": "reinmav_tpu_torch/csrc/closed_loop_rollout.cu",
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
        **k1_sass,
    }]
    del big, big_final, big_t, f_k, f_p, r_k, r_p, reward_sum
    torch.cuda.empty_cache()

    kernels += ppo_phases(torch, dev, gpu, env)
    kernels += hover_phases(torch, dev, gpu)
    kernels += offpolicy_phases(torch, dev, gpu)
    kernels += native_phases(torch, dev, gpu)
    # 24. K10; 25. K11 on each contact env.
    kernels.append(reinmav_phase(torch, dev, gpu))
    for line in _build.ptxas_report():
        if any(k in line for k in ("contact_rollout", "reinmav_rollout", "hover_rollout",
                                   "ppo_loss_kernel", "ppo_update_kernel")):
            say(line)
    kernels += [contact_phase(torch, dev, gpu, name)
                for name in ("MujocoQuadForce-v0", "MujocoQuadQuat-v0")]
    # 26-33. The modules around the learners, and chunking.
    modules_phases(torch, dev, gpu)
    # 34-38. compute_dtype="bfloat16".
    kernels += bf16_phases(torch, dev, gpu)
    # 39-44. The multi-rank paths and the examples.
    sharded = parallel_phases(torch, dev, gpu)
    for entry in kernels:
        if entry["name"] in sharded:
            entry["launches_sharded"] = sharded[entry["name"]]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
