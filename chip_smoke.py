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

The second-to-last line is a JSON object describing each kernel of the
path; the last is {"ok": true, "device": {...}}.  The script imports
nothing of JAX.
"""

from __future__ import annotations

import json
import logging
import statistics
import subprocess
import sys
import time

TOL = dict(rtol=2e-4, atol=2e-5)  # the JAX kernel tests' float32 tolerances
RTOL_REWARD = 1e-4
B_CHECK, T_NO_RESET, T_RESET = 65_536, 200, 1000
B_MAIN, T_MAIN = 2_097_152, 1000
B_QUICK, T_QUICK = 4096, 400
REF = (0.0, 0.0, 2.0)


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

    say(json.dumps({"kernels": [{
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
        "at": f"states {tuple(f_k.shape)}, horizon {T_MAIN}",
    }]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
