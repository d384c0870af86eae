"""Kernel K7: the fused off-policy collection step of SAC, TD3 and DDPG,
and its plain twin.

The counterpart of :mod:`reinmav_tpu.ops.pallas_offpolicy` (every kind of
:data:`reinmav_tpu_torch.ops.ppo_rollout.ENVS`: quadrotor3d-v0, the hover
task, quadrotor2d-v0 and the two slung-load envs).  :func:`collect_step` runs
one collection iteration in one CUDA kernel written by hand for Hopper
(``csrc/offpolicy_collect.cu``, a template on the env structs of
``csrc/env_kinds.cuh`` that K2/K6-hover share): the actor MLP (ReLU
hiddens, linear head), the action (SAC's tanh-Gaussian or TD3's tanh plus
clipped noise; the ``_det`` modes without noise), the warmup gate, the
per-dim affine into the env's physical action box, the env step with the
live params, the replay block in ring row order (obs, policy-space
action, raw reward, the TERMINAL next_obs, done), and the auto-reset of
the done envs after the block is written.
:func:`collect_step_reference` is its plain PyTorch twin: the same
float32 arithmetic and the same Philox4x32-10 draws (action noise on
stream 3, warmup uniforms on stream 4, the U(-1, 1)^D resets on stream 5
of :func:`reinmav_tpu_torch.ops.rollout.philox_words`; K2 uses streams 1
and 2), so the two agree on the card, and the CPU tests run the twin.

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .ppo_rollout import ENVS, _env_twin, normal_draws
from .rollout import mantissa_fill, philox_words

#: Sampling modes, by their id in the C entry point.  The ``_det`` modes
#: take eps = 0 (SAC) or noise = 0 (TD3).
MODES = {"sac": 0, "sac_det": 1, "td3": 2, "td3_det": 3}
#: Hidden widths the kernel is built for: multiples of 32 up to 256.
HIDDEN_STEP, MAX_HIDDEN = 32, 256
_EPS_STREAM, _WARM_STREAM, _RESET_STREAM = 3, 4, 5


def supported(env) -> bool:
    """Whether K7 covers ``env``: its name is a kind of :data:`ENVS` and
    its flat state IS the observation (the block stores obs = state rows)."""
    return env.name in ENVS and env.state_dim == env.obs_dim


def width_refusal(hidden) -> str | None:
    """Why the kernel cannot take an actor of these hidden widths (None =
    it can): two equal layers, a multiple of 32 up to 256."""
    hidden = tuple(hidden)
    if len(hidden) != 2 or hidden[0] != hidden[1]:
        return f"hidden {hidden} is not two equal layers"
    h = hidden[0]
    if h % HIDDEN_STEP or not HIDDEN_STEP <= h <= MAX_HIDDEN:
        return f"hidden width {h}: K7 is built for multiples of {HIDDEN_STEP} up to {MAX_HIDDEN}"
    return None


def actor_kernel_args(layers):
    """A 2-hidden-layer actor's layer list (``[{"w": (din, dout), "b":
    (dout,)}, ...]``, e.g. :meth:`reinmav_tpu_torch.rl.sac.MlpLayout.layers`)
    -> the kernel's six weight arguments ``(w1, b1, w2, b2, w3, b3)``."""
    if len(layers) != 3:
        raise ValueError(f"K7 needs a 2-hidden-layer actor, got {len(layers) - 1} hidden layers")
    return tuple(t for layer in layers for t in (layer["w"], layer["b"]))


def _check_args(env_kind, mode, states_t, seed, consts, params_vec, weights) -> torch.Tensor:
    """Validate what the kernel takes; returns the kind's params vector."""
    if env_kind not in ENVS:
        raise ValueError(f"env_kind {env_kind!r}: K7 takes {sorted(ENVS)}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: K7 takes {sorted(MODES)}")
    kind = ENVS[env_kind]
    d, a = kind.state_dim, kind.action_dim
    names = ("states_t", "consts", "w1", "b1", "w2", "b2", "w3", "b3")
    for name, t in zip(names, (states_t, consts, *weights)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != states_t.device:
            raise ValueError(f"{name} is on {t.device}, states_t on {states_t.device}")
    if states_t.dim() != 2 or states_t.shape[0] != d or states_t.shape[1] == 0:
        raise ValueError(f"states_t must be ({d}, B) with B > 0, got {tuple(states_t.shape)}")
    w1, b1, w2, b2, w3, b3 = weights
    h = w1.shape[1] if w1.dim() == 2 else -1
    out = 2 * a if mode.startswith("sac") else a
    shapes = ((w1, (d, h)), (b1, (h,)), (w2, (h, h)), (b2, (h,)), (w3, (h, out)), (b3, (out,)))
    for name, (t, shape) in zip(names[2:], shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for mode {mode!r}, got {tuple(t.shape)}")
    if consts.shape != (2 + 2 * a,):
        raise ValueError(f"consts must be ({2 + 2 * a},), got {tuple(consts.shape)}")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed must fit in uint32, got {seed}")
    params = kind.pack(None) if params_vec is None else params_vec
    n_params = kind.pack(None).shape[0]
    if params.shape != (n_params,):
        raise ValueError(f"params_vec must be ({n_params},), got {tuple(params.shape)}")
    return params.detach().to("cpu", torch.float32)


def _normal(env_idx: torch.Tensor, seed: int, a: int) -> torch.Tensor:
    """K7's N(0, 1) draws, ``(a, n)``: K2's Box-Muller on stream 3."""
    return normal_draws(env_idx, 0, seed, a, _EPS_STREAM)


def _uniform_pm1(env_idx: torch.Tensor, seed: int, a: int) -> torch.Tensor:
    """K7's warmup U(-1, 1) draws, ``(a, n)``: one Philox block on stream 4."""
    f12 = mantissa_fill(philox_words(env_idx, 0, seed, 1, _WARM_STREAM)[:a])
    return 2.0 * (f12 - 1.0) - 1.0


def collect_step_reference(env_kind: str, mode: str, states_t, seed: int, consts,
                           params_vec, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch twin of K7, on any device: the same float32
    arithmetic and the same Philox draws.  Its products are float32
    matmuls; on a CUDA device the caller keeps TF32 off.  Same arguments
    and returns as :func:`collect_step`."""
    params = _check_args(env_kind, mode, states_t, seed, consts, params_vec,
                         (w1, b1, w2, b2, w3, b3))
    kind = ENVS[env_kind]
    a = kind.action_dim
    seed = int(seed)
    env_step, env_reset = _env_twin(env_kind, params, reset_stream=_RESET_STREAM)
    env_idx = torch.arange(states_t.shape[1], device=states_t.device)

    x = states_t
    h = torch.relu(w1.T @ x + b1[:, None])
    h = torch.relu(w2.T @ h + b2[:, None])
    out = w3.T @ h + b3[:, None]
    if mode.startswith("sac"):
        u = out[:a]
        if mode == "sac":
            log_std = torch.clamp(out[a:2 * a], -20.0, 2.0)
            u = u + torch.exp(log_std) * _normal(env_idx, seed, a)
        a_pol = torch.tanh(u)
    else:
        a_pol = torch.tanh(out[:a])
        if mode == "td3":
            a_pol = torch.clamp(a_pol + consts[1] * _normal(env_idx, seed, a), -1.0, 1.0)
    a_t = torch.where(consts[0] > 0.5, _uniform_pm1(env_idx, seed, a), a_pol)
    lo, hi = consts[2:2 + a, None], consts[2 + a:2 + 2 * a, None]
    act = lo + (a_t + 1.0) * (0.5 * (hi - lo))

    new, raw, done = env_step(x, act)
    block = torch.cat([x, a_t, raw[None], new, done[None].to(torch.float32)])
    new = new.clone()
    env_reset(new, done, 0, seed)
    return new, block


def collect_step(env_kind: str, mode: str, states_t, seed: int, consts, params_vec,
                 w1, b1, w2, b2, w3, b3):
    """K7: one off-policy collection iteration in one CUDA launch.

    ``env_kind`` an :data:`ENVS` name; ``mode`` one of :data:`MODES`;
    ``states_t`` ``(D, B)`` float32 (D its state dim), any ``B > 0``; ``seed`` the uint32 Philox key of the noise, warmup and reset
    draws; ``consts`` ``[warm_gate, explore_noise, lo (A), hi (A)]``
    float32 on the same device (warm_gate > 0.5 takes the uniform draws);
    ``params_vec`` the env's live Params packed by the kind's ``pack``
    (default Params when None); the actor's weights ``w1 (D, H), b1 (H,),
    w2 (H, H), b2 (H,), w3 (H, OUT), b3 (OUT,)`` with OUT = 2A for the
    SAC modes (mean, log_std) and A for the TD3 modes
    (:func:`actor_kernel_args`).  Returns ``(new states (D, B), block
    (2D + A + 2, B))``, float32.  Launches on the current stream and does
    not synchronise.  A CPU tensor runs the plain twin; a CUDA tensor runs
    the kernel, which takes the widths :func:`width_refusal` accepts, or
    raises."""
    weights = (w1, b1, w2, b2, w3, b3)
    params = _check_args(env_kind, mode, states_t, seed, consts, params_vec, weights)
    if states_t.device.type == "cpu":
        return collect_step_reference(env_kind, mode, states_t, seed, consts, params, *weights)
    if states_t.device.type != "cuda":
        raise ValueError(f"unsupported device {states_t.device}")
    h = w1.shape[1]
    reason = width_refusal((h, h))
    if reason is not None:
        raise ValueError(reason)
    from .._build import check, load_library

    lib = load_library()
    kind = ENVS[env_kind]
    d, batch = kind.state_dim, states_t.shape[1]
    new = torch.empty_like(states_t)
    block = torch.empty((2 * d + kind.action_dim + 2, batch), dtype=torch.float32,
                        device=states_t.device)
    host_params = (ctypes.c_float * params.shape[0])(*params.tolist())
    with torch.cuda.device(states_t.device):
        rc = lib.offpolicy_collect_launch(
            kind.kind_id, MODES[mode], ctypes.addressof(host_params), params.shape[0],
            states_t.data_ptr(), batch, h, *(t.data_ptr() for t in weights), consts.data_ptr(),
            int(seed), new.data_ptr(), block.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(rc, "offpolicy_collect_launch")
    collect_step.launches += 1
    return new, block


#: Kernel launches so far (a run can show that its path went through K7).
collect_step.launches = 0
