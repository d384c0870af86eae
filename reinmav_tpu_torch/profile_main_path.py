"""Wall time and device idle share of the port's two main-path calls.

Run on a machine with one CUDA device, from the root of a checkout::

    python3 -m reinmav_tpu_torch.profile_main_path

Measures, after a warm-up:

- ``throughput_rollout`` of 2,097,152 envs x 1000 steps (``backend="auto"``,
  which runs the K1 kernel): host-clock wall time per call, ended by
  ``torch.cuda.synchronize()``, over 5 calls;
- ``control_rollout`` of 4096 envs x 400 steps, the eager loop, with and
  without the trajectory collected: wall time per call;
- each call once more under ``torch.profiler`` (the eager loop at 50
  steps): the device kernels launched, and the device idle share.

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


def _busy_ms(events) -> tuple[float, int]:
    """Union of the device-side intervals of ``events`` in ms, and their count."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3, len(spans)


def _profile(name: str, fn, unprofiled_ms: float) -> None:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        wall = _wall_ms(fn, 1)[0]
    busy, n = _busy_ms(prof.events())
    if n == 0:
        raise RuntimeError(f"{name}: the profiler recorded no device activity")
    print(f"{name}: profiled wall {wall:.3f} ms, device busy {busy:.3f} ms over {n} device "
          f"events, idle share {1 - busy / wall:.3f} (profiled wall), "
          f"{1 - busy / unprofiled_ms:.3f} (unprofiled wall {unprofiled_ms:.3f} ms)")
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

    throughput()
    control(5)()  # warm-up
    walls = {
        f"throughput_rollout {B_MAIN}x{T_MAIN}": _wall_ms(throughput, 5),
        f"control_rollout {B_QUICK}x{T_QUICK}": _wall_ms(control(T_QUICK), 3),
        f"control_rollout {B_QUICK}x{T_QUICK} no trajectory":
            _wall_ms(control(T_QUICK, collect=False), 2),
        f"control_rollout {B_QUICK}x{T_PROFILED}": _wall_ms(control(T_PROFILED), 3),
    }
    for name, ms in walls.items():
        print(f"{name} wall ms: {[round(m, 3) for m in ms]}")

    def mean(name):
        return sum(walls[name]) / len(walls[name])

    _profile(f"throughput_rollout {B_MAIN}x{T_MAIN}", throughput,
             mean(f"throughput_rollout {B_MAIN}x{T_MAIN}"))
    _profile(f"control_rollout {B_QUICK}x{T_PROFILED}", control(T_PROFILED),
             mean(f"control_rollout {B_QUICK}x{T_PROFILED}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
