"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, at first use,
and loaded with ``ctypes``; ptxas's report of every kernel's registers,
spills and shared memory is kept beside it (:func:`ptxas_log_path`).
The library's name carries a hash of the
sources, the shared headers (``csrc/*.cuh``) and the flags (a source may
add its own, :data:`SOURCE_FLAGS`), so an edited
source or header builds anew and an unchanged tree is reused.
The build directory ``_build/`` sits in the package and is not
committed.  A missing ``nvcc`` or a failed build raises: there is no
fallback.

Importing this module builds nothing; ``load_library()`` does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
#: Diagnostic instances of the wide K3 body (its phase probe, its 1xTF32
#: control), each built into a library of its own by
#: :func:`load_probe_library` and never into the kernel library.
PROBE_DIR = SRC_DIR.parent / "csrc_probe"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: Flags of one source beyond NVCC_FLAGS.  K10 and K11 are built without FMA
#: contraction, so that their arithmetic is their twins', operation for
#: operation: both run dynamics where a last-bit difference grows (K10's
#: clamped, stiff rate loop; K11's contact knife edges).
SOURCE_FLAGS = {"reinmav_rollout.cu": ("-fmad=false",), "contact_rollout.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
#: C entry point -> argtypes.  Every launch entry point returns a CUDA error
#: code, 0 on success.
_SIGNATURES = {
    # (counters (n, 4) u32, keys (n, 2) u32, out (n, 4) u32, n, stream)
    "philox4x32_10_launch": (_P, _P, _P, ctypes.c_longlong, _P),
    # K5: (states_in, states_out, reward_out, batch, horizon, frame_skip,
    #  host params[17], host action[4], a_sq, 0.1 * a_sum, stream)
    "hover_rollout_launch": (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P,
                             ctypes.c_float, ctypes.c_float, _P),
    # K10: (states_in, states_out, substep counts or null, batch, horizon,
    #  host params, number of params, lanes per env, stream)
    "reinmav_rollout_launch": (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, ctypes.c_int,
                               ctypes.c_int, _P),
    # K10's Euler angles against atan2f: (a, b, cphi, psi out, library out,
    #  n, stream)
    "reinmav_euler_check_launch": (_P, _P, _P, _P, _P, ctypes.c_longlong, _P),
    # K11: (states_in, states_out, z_sum_out, tier counts or null, batch,
    #  horizon, frame_skip, pgs_iters, force48, host params, number of
    #  params, stream)
    "contact_rollout_launch": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P),
    # K1 / K8 / K9: (env kind, states_in, states_out, reward_out, counts or null,
    #  batch, horizon, seed, autoreset, host params, number of params, stream)
    "closed_loop_rollout_launch": (ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_uint, ctypes.c_int, _P, ctypes.c_int,
                                   _P),
    # K2 / K6: (env kind, states_in, returns_in, net, consts, batch,
    #  horizon, seed, env_base, normalize_obs, normalize_rewards, bf16, host
    #  params, number of params, obs, action, log_prob, value, reward, done,
    #  final_states, returns_out, partials, stats, taut counts or null, stream)
    "ppo_rollout_launch": (ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _P,
                           ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # K2/K6's bf16 probe: (env kind, states_in, returns_in, net, consts,
    #  batch, horizon, seed, env_base, host params, number of params, obs,
    #  action, log_prob, value, reward, done, final_states, returns_out,
    #  partials, stats, probe (6 u32), stream)
    "ppo_rollout_bf16_probe_launch": (ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_uint, ctypes.c_uint, _P,
                                      ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P),
    # K3: (obs dim, action dim, data, n, perm, m, tile, adv_stats, net,
    #  clip_eps, value_clip_eps, value_coef, kl_mode, bf16, blocks, partials,
    #  out, stream)
    "ppo_loss_launch": (ctypes.c_int, ctypes.c_int, _P, ctypes.c_longlong, _P, ctypes.c_longlong, ctypes.c_int,
                        _P, _P, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _P, _P, _P),
    # K3's bf16 forward probe: (obs dim, action dim, data, n, perm, m, tile,
    #  adv_stats, net, clip_eps, value_clip_eps, value_coef, blocks, partials,
    #  probe, stream)
    "ppo_loss_probe_launch": (ctypes.c_int, ctypes.c_int, _P, ctypes.c_longlong, _P,
                              ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_float,
                              ctypes.c_float, ctypes.c_float, ctypes.c_int, _P, _P, _P),
    # (minibatch samples) -> CTAs of the K3 launch, -1 on a CUDA error
    "ppo_loss_blocks": (ctypes.c_longlong,),
    # (obs dim, action dim) -> sums K3 writes, -1 for dims it is not built for
    "ppo_loss_out_size": (ctypes.c_int, ctypes.c_int),
    # K4: (obs dim, action dim, data, n, perm, tile, tiles per minibatch, passes,
    #  minibatches, adv_stats, kl_beta, count_in, count_out, params, mu, nu,
    #  clip_eps, value_clip_eps, value_coef, inv_n, ent_coef, lr,
    #  max_grad_norm, b1, b2, eps, has_floor, log_std_floor, kl_mode, bf16,
    #  blocks, partials, gbuf, slots, metrics, grad0, stream)
    "ppo_update_launch": (ctypes.c_int, ctypes.c_int, _P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                          ctypes.c_float, ctypes.c_float, ctypes.c_double, ctypes.c_float,
                          ctypes.c_float, ctypes.c_float, ctypes.c_double, ctypes.c_double,
                          ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P),
    "ppo_update_metrics_size": (),
    # K3 wide: (obs dim, action dim, hidden width, data, n, perm, m, tile,
    #  adv_stats, net, clip_eps, value_clip_eps, value_coef, kl_mode, bf16,
    #  blocks, plan (5 int64, host), partials, packed, panels, recompute
    #  counts or null, out, stream)
    "ppo_loss_wide_launch": (ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_longlong, _P,
                             ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_float,
                             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, _P, _P, _P, _P, _P, _P, _P),
    # (obs dim, action dim, hidden width, bf16, minibatch samples, CTAs,
    #  plan out (8 int64)) -> 0, or -1 for widths or a grid the wide body
    #  does not take
    "ppo_wide_plan": (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, _P),
    # (obs dim, action dim, hidden width, kl_mode, bf16, resident CTAs an SM
    #  out (int)) of K4 wide's instance
    "ppo_update_wide_occupancy": (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, _P),
    # (minibatch samples) -> CTAs of the K3/K4 wide grid, -1 on a CUDA error
    "ppo_loss_wide_blocks": (ctypes.c_longlong,),
    # (obs dim, action dim, hidden width) -> sums K3 wide writes, -1 for
    #  widths the wide body does not take
    "ppo_loss_wide_out_size": (ctypes.c_int, ctypes.c_int, ctypes.c_int),
    # (obs dim, action dim, hidden width, offsets out (11 int)) -> 0, or -1
    #  for widths the wide body does not take
    "ppo_wide_layout": (ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
    # K4 wide: ppo_update_launch's arguments with the hidden width, the plan
    #  (5 int64, host), the packed weights and the panels after the action dim
    "ppo_update_wide_launch": (ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                               ctypes.c_longlong,
                               _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
                               _P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float,
                               ctypes.c_float, ctypes.c_double, ctypes.c_float, ctypes.c_float,
                               ctypes.c_float, ctypes.c_double, ctypes.c_double, ctypes.c_float,
                               ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, _P, _P, _P, _P, _P, _P),
    # K7: (env kind, mode, bf16, host params, number of params, states_in,
    #  batch, hidden1, hidden2, w1, b1, w2, b2, w3, b3, consts, seed,
    #  states_out, block, taut counts or null, stream)
    "offpolicy_collect_launch": (ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P,
                                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                                 _P, _P, _P, ctypes.c_uint, _P, _P, _P, _P),
    # K7's bf16 probe: (env kind, mode, host params, number of params,
    #  states_in, batch, hidden1, hidden2, w1, b1, w2, b2, w3, b3, consts,
    #  seed, states_out, block, probe (6 u32), stream)
    "offpolicy_collect_bf16_probe_launch": (ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P,
                                            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
                                            _P, _P, _P, _P, _P, _P, ctypes.c_uint, _P, _P, _P,
                                            _P),
    # K7's main-path kernel: (env kind, mode, hidden1, hidden2, resident CTAs
    #  an SM out (int), dynamic shared memory out (long long))
    "offpolicy_collect_occupancy": (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
                                    _P),
    # K7 wide: offpolicy_collect_launch's arguments without the counts, with
    #  the bf16 instance's packed weights (scratch) after the block
    "offpolicy_collect_wide_launch": (ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                                      _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P,
                                      _P, _P, _P, _P, _P, ctypes.c_uint, _P, _P, _P, _P),
    # K7 wide bf16's probe: the bf16 probe's arguments with the scratch
    #  before the probe
    "offpolicy_collect_wide_bf16_probe_launch": (ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P,
                                                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                 _P, _P, _P, _P, _P, _P, _P, ctypes.c_uint,
                                                 _P, _P, _P, _P, _P),
    # K7 wide bf16's pack: (obs dim, hidden1, hidden2, head columns, w1, b1,
    #  w2, b2, w3, scratch, stream)
    "offpolicy_collect_wide_bf16_pack_launch": (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, _P, _P, _P, _P, _P, _P, _P),
    # (hidden1, hidden2, head columns) -> bytes of K7 wide bf16's scratch
    "offpolicy_collect_wide_scratch_bytes": (ctypes.c_int, ctypes.c_int, ctypes.c_int),
    # K7 wide: (env kind, mode, bf16, hidden1, hidden2, resident CTAs an SM
    #  out (int), dynamic shared memory out (long long), env tile out (int))
    "offpolicy_collect_wide_occupancy": (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, _P, _P, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return nvcc


def _sources() -> list[Path]:
    sources = sorted(SRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {SRC_DIR}")
    return sources


def _library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in [*_sources(), *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreinmav_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with the output of the first
    that failed, else return their outputs."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def ptxas_log_path() -> Path:
    """Where :func:`build` keeps ptxas's report (registers, spills, shared
    memory of every kernel) of the current library."""
    return _library_path().with_suffix(".ptxas.txt")


def ptxas_report(path: Path | None = None) -> list[str]:
    """One line per kernel of ptxas's report (the current library's when
    ``path`` is None): registers, spill stores and loads, shared memory,
    each kernel by its demangled name."""
    rows, name, spill = [], None, ""
    for line in Path(path or ptxas_log_path()).read_text().splitlines():
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
    from .sass_report import short_name

    return [f"ptxas: {short_name(n)}: {info}" for n, (_, info) in zip(names, rows)]


def build() -> Path:
    """Compile the sources unless the library for them exists; returns
    its path.  Builds in a temporary directory and renames the library
    into place, so that concurrent processes never load a half-written
    file."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", "-o", obj,
                          str(src)] for src, obj in zip(_sources(), objs)])
        lib = os.path.join(tmp, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        Path(tmp, "ptxas.txt").write_text("".join(logs))
        os.replace(Path(tmp, "ptxas.txt"), ptxas_log_path())
        os.replace(lib, out)
    return out


def _probe_path(name: str) -> Path:
    """Where the library of the probe source ``name`` for the current
    sources lives (it includes the kernel sources, so all of them are
    hashed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [PROBE_DIR / f"{name}.cu", *_sources(), *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@functools.cache
def load_probe_library(name: str = "ppo_loss_wide_probe") -> ctypes.CDLL:
    """Build (one ``nvcc``) and load the diagnostic library of
    ``csrc_probe/<name>.cu``: the wide K3 kernel, with the same C interface
    as the kernel library's ``ppo_loss_wide_launch``, with its phase probe
    on (``ppo_loss_wide_probe``, which adds ``ppo_wide_probe_set(buffer)``,
    ``ppo_wide_probe_miss(buffer)`` and ``ppo_wide_probe_phases()``) or
    with its float32 products as 1xTF32 (``ppo_loss_wide_1xtf32``).  No
    training path loads one."""
    out = _probe_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            lib = os.path.join(tmp, out.name)
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, str(PROBE_DIR / f"{name}.cu")]])
            os.replace(lib, out)
    lib = ctypes.CDLL(str(out))
    for fn_name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for fn_name in ("ppo_wide_probe_set", "ppo_wide_probe_miss"):
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes = (_P,)
            fn.restype = ctypes.c_int
    if hasattr(lib, "ppo_wide_probe_phases"):
        lib.ppo_wide_probe_phases.argtypes = ()
        lib.ppo_wide_probe_phases.restype = ctypes.c_int
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = (ctypes.c_int,)
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load_library().cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
