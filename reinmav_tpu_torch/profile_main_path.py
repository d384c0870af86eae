"""Wall time and device idle share of the port's main-path calls.

Run on a machine with one CUDA device, from the root of a checkout::

    python3 -m reinmav_tpu_torch.profile_main_path

Measures, after a warm-up:

- ``throughput_rollout`` of 2,097,152 envs x 1000 steps (``backend="auto"``,
  which runs the K1 kernel): host-clock wall time per call, ended by
  ``torch.cuda.synchronize()``, over 5 calls;
- ``control_rollout`` of 4096 envs x 400 steps, the eager loop, with and
  without the trajectory collected: wall time per call;
- one PPO update (``reinmav_tpu_torch.rl.ppo.train_step``) of 32,768
  envs x 32 steps with the default config (K2 for the rollout, ONE K4
  launch for the 16 passes of the update) and, beside it, with
  ``fused_update="off"`` (K3 for each of the 16 minibatch gradients and
  the optimiser in eager PyTorch): wall time per update over 5 updates,
  after 2 warm-up updates;
- the hover task (``MujocoQuadForce-v1``): ``throughput_rollout`` of
  2,097,152 envs x 1000 steps (the K5 kernel), and one default PPO update
  of 32,768 x 32 (K6-hover for the rollout, one K4 launch at obs 13);
- SAC on the hover task at the reference bench's config (65,536 envs,
  batch 8192, a 2^21-column ring, 2 x 256 nets, one update per
  iteration, no warmup): ``reinmav_tpu_torch.rl.sac.train_iters`` of 10
  iterations (one K7 launch each for the collection, the updates through
  autograd), wall time per call over 3 calls after a warm-up call;
- each call once more under ``torch.profiler`` (the eager loop at 50
  steps): the device kernels launched, and the device idle share.  For
  the learners also the shares of the wall time that K2, K3, K4, K7 and
  the other device kernels (the eager glue: GAE, advantage moments, the
  optimiser, the off-policy updates) are busy, and the host time inside
  the learners' ``ppo.*`` and ``sac.*`` profiler spans.

Device busy time is the union of the device-side intervals of every
kernel and copy the profiler recorded (overlaps counted once).  The idle
share is ``1 - busy / wall``, printed twice: against the profiled call's
own wall time (which carries the profiler's overhead) and against the
mean unprofiled wall time of the same call.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

import reinmav_tpu_torch

B_MAIN, T_MAIN = 2_097_152, 1000
B_QUICK, T_QUICK, T_PROFILED = 4096, 400, 50
B_PPO, T_PPO = 32_768, 32
B_SAC, BATCH_SAC, RING_SAC, SAC_ITERS = 65_536, 8192, 1 << 21, 10
#: Device kernels by their name: K2 or K6-hover (with its moment
#: reduction), K3 (with its partials' reduction), K4, K5 and K7.
KERNEL_GROUPS = {"K2/K6-hover": "ppo_rollout", "K3": "ppo_loss", "K4": "ppo_update",
                 "K5": "hover_rollout", "K7": "offpolicy_collect"}
#: The learners' host spans (torch.profiler.record_function).
SPANS = ("ppo.", "sac.")


def _wall_ms(fn, reps: int) -> list[float]:
    """Host-clock milliseconds of each of ``reps`` calls of ``fn``, each
    ended by a device synchronise."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _is_device_work(e) -> bool:
    """A kernel or copy on the device.  The learners' ``ppo.*`` and
    ``sac.*`` spans are mirrored onto the device timeline as user
    annotations; they are not work."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith(SPANS))


def _busy_ms(events) -> tuple[float, int]:
    """Union of the device-side intervals of ``events`` in ms, and their count."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events if _is_device_work(e))
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3, len(spans)


def _profile(name: str, fn, unprofiled_ms: float, groups: dict | None = None) -> None:
    """Profile one call of ``fn``; print its device busy time and idle
    share, and, for ``groups`` (label -> substring of kernel names), each
    group's busy share of the wall time and the host time in the
    learners' spans."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        wall = _wall_ms(fn, 1)[0]
    events = prof.events()
    busy, n = _busy_ms(events)
    if n == 0:
        raise RuntimeError(f"{name}: the profiler recorded no device activity")
    print(f"{name}: profiled wall {wall:.3f} ms, device busy {busy:.3f} ms over {n} device "
          f"events, idle share {1 - busy / wall:.3f} (profiled wall), "
          f"{1 - busy / unprofiled_ms:.3f} (unprofiled wall {unprofiled_ms:.3f} ms)")
    if groups:
        grouped_ms, grouped_n = 0.0, 0
        for label, key in groups.items():
            ms, count = _busy_ms(e for e in events if key in e.name)
            grouped_ms, grouped_n = grouped_ms + ms, grouped_n + count
            print(f"  {label} ({key}*): {count} device events, {ms:.3f} ms busy, "
                  f"{ms / wall:.3f} of the profiled wall")
        other = busy - grouped_ms
        print(f"  other device work (the eager glue): {n - grouped_n} device events, "
              f"{other:.3f} ms busy, {other / wall:.3f} of the profiled wall")
        spans = {}
        for e in events:
            if e.name.startswith(SPANS) and e.device_type == torch.autograd.DeviceType.CPU:
                spans[e.name] = spans.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        for span, ms in sorted(spans.items()):
            print(f"  host span {span}: {ms:.3f} ms, {ms / wall:.3f} of the profiled wall")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=8))


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"gpu: {gpu}")
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    gen = torch.Generator(device="cuda").manual_seed(0)
    big = env.vreset(gen, B_MAIN)
    small = env.vreset(gen, B_QUICK)

    def throughput():
        return reinmav_tpu_torch.throughput_rollout(env, big, gen, T_MAIN)

    def control(horizon, collect=True):
        return lambda: reinmav_tpu_torch.control_rollout(env, small, gen, horizon,
                                                         collect_trajectory=collect)

    from .rl import ppo

    def ppo_update(env=env, **overrides):
        cfg = ppo.PpoConfig(num_envs=B_PPO, rollout_len=T_PPO, **overrides)
        state = [ppo.init_train_state(env, cfg, seed=0, device="cuda")]

        def update():
            state[0], _ = ppo.train_step(env, cfg, state[0])

        return update

    hover = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    hover_big = hover.vreset(gen, B_MAIN)

    def hover_throughput():
        return reinmav_tpu_torch.throughput_rollout(hover, hover_big, gen, T_MAIN)

    from .rl import sac

    sac_cfg = sac.SacConfig(num_envs=B_SAC, batch_size=BATCH_SAC, buffer_capacity=RING_SAC,
                            hidden=(256, 256), grad_steps=1, warmup_steps=0)
    sac_state = [sac.init_state(hover, sac_cfg, seed=0, device="cuda")]

    def sac_iters():
        sac_state[0], _ = sac.train_iters(hover, sac_cfg, sac_state[0], SAC_ITERS)

    k4_update, loop_update = ppo_update(), ppo_update(fused_update="off")
    hover_update = ppo_update(hover)
    k4_name = f"ppo train_step {B_PPO}x{T_PPO} (K4)"
    loop_name = f"ppo train_step {B_PPO}x{T_PPO} fused_update=off (K3 loop)"
    hover_tp_name = f"hover throughput_rollout {B_MAIN}x{T_MAIN} (K5)"
    hover_name = f"hover ppo train_step {B_PPO}x{T_PPO} (K6-hover + K4)"
    sac_name = (f"hover sac train_iters {SAC_ITERS} iterations, {B_SAC} envs, batch {BATCH_SAC} "
                f"(K7 + autograd)")

    throughput()
    hover_throughput()
    control(5)()  # warm-up
    for _ in range(2):
        k4_update()  # warm-up
        loop_update()
        hover_update()
    sac_iters()
    walls = {
        f"throughput_rollout {B_MAIN}x{T_MAIN}": _wall_ms(throughput, 5),
        f"control_rollout {B_QUICK}x{T_QUICK}": _wall_ms(control(T_QUICK), 3),
        f"control_rollout {B_QUICK}x{T_QUICK} no trajectory":
            _wall_ms(control(T_QUICK, collect=False), 2),
        f"control_rollout {B_QUICK}x{T_PROFILED}": _wall_ms(control(T_PROFILED), 3),
        k4_name: _wall_ms(k4_update, 5),
        loop_name: _wall_ms(loop_update, 5),
        hover_tp_name: _wall_ms(hover_throughput, 5),
        hover_name: _wall_ms(hover_update, 5),
        sac_name: _wall_ms(sac_iters, 3),
    }
    for name, ms in walls.items():
        print(f"{name} wall ms: {[round(m, 3) for m in ms]}")

    def mean(name):
        return sum(walls[name]) / len(walls[name])

    _profile(f"throughput_rollout {B_MAIN}x{T_MAIN}", throughput,
             mean(f"throughput_rollout {B_MAIN}x{T_MAIN}"))
    _profile(f"control_rollout {B_QUICK}x{T_PROFILED}", control(T_PROFILED),
             mean(f"control_rollout {B_QUICK}x{T_PROFILED}"))
    _profile(k4_name, k4_update, mean(k4_name), KERNEL_GROUPS)
    _profile(loop_name, loop_update, mean(loop_name), KERNEL_GROUPS)
    _profile(hover_tp_name, hover_throughput, mean(hover_tp_name), KERNEL_GROUPS)
    _profile(hover_name, hover_update, mean(hover_name), KERNEL_GROUPS)
    _profile(sac_name, sac_iters, mean(sac_name), KERNEL_GROUPS)
    print(f"{sac_name}: {mean(sac_name) / SAC_ITERS:.3f} ms per iteration unprofiled, "
          f"{B_SAC * SAC_ITERS / mean(sac_name) * 1e3:.4e} env-steps/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
