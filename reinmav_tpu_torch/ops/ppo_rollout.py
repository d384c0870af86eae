"""Kernel K2: the fused PPO rollout of quadrotor3d-v0, and its plain twin.

The counterpart of :mod:`reinmav_tpu.ops.pallas_ppo_rollout` (kind
``quadrotor3d-v0``).  :func:`ppo_rollout` runs the whole rollout phase
of PPO in one CUDA kernel written by hand for Hopper
(``csrc/ppo_rollout.cu``): obs normalisation, the 2x64 tanh actor-critic,
the Gaussian action with logp from the rounded action, the env step,
auto-reset, the return-scaled reward, the raw moment sums and the
trajectory.  :func:`ppo_rollout_reference` is its plain PyTorch twin:
the same arithmetic and the same Philox4x32-10 draws (noise on stream 1,
resets on stream 2 of :func:`reinmav_tpu_torch.ops.rollout.philox_words`),
so the two agree on the card with noise and resets on, and the CPU tests
run the twin.

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..rl.networks import Layout
from .rollout import (_Q3_FIELDS, body_z, mantissa_fill, philox_words, quad3d_dynamics,
                      quad3d_params_vec, reset_draws)

#: The kernel's shapes: quadrotor3d-v0 (obs = state, 10; action 4) and the
#: 2x64 actor-critic (csrc/actor_critic.cuh).
D, A, HIDDEN = 10, 4, (64, 64)
LAYOUT = Layout(D, A, HIDDEN)
N_STATS = 2 * D + 3   # obs sum (D), obs sum of squares (D), return sum, return sq, raw reward
N_CONSTS = 2 * D + A + 3  # obs mean (D), obs 1/std (D), std (A), sum log_std, 1/ret std, gamma
_THREADS = 128  # CTA size of the kernel, for the partials scratch
_NOISE_STREAM, _RESET_STREAM = 1, 2
_TWO_PI = 2.0 * math.pi
_LOGP_CONST = float(np.float32(0.5 * A) * np.float32(math.log(2.0 * math.pi)))


class RolloutOut(NamedTuple):
    """K2's outputs: the trajectory in the port's ``Transition`` layout
    (``obs`` the normalised obs the policy saw, ``reward`` the scaled
    reward), the final states and running returns, and the moment sums
    ``[obs sum (D), obs sum of squares (D), return sum, return sum of
    squares, raw reward sum]``."""

    obs: torch.Tensor           # (T, D, B)
    action: torch.Tensor        # (T, A, B)
    log_prob: torch.Tensor      # (T, B)
    value: torch.Tensor         # (T, B)
    reward: torch.Tensor        # (T, B)
    done: torch.Tensor          # (T, B) bool
    final_states: torch.Tensor  # (D, B)
    returns: torch.Tensor       # (B,)
    stats: torch.Tensor         # (2D + 3,)


def _check_args(states_t, env_returns, seed, net, consts, horizon, params_vec) -> torch.Tensor:
    """Validate what the kernel takes; returns the (11,) env params vector."""
    for name, t in (("states_t", states_t), ("env_returns", env_returns), ("net", net),
                    ("consts", consts)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != states_t.device:
            raise ValueError(f"{name} is on {t.device}, states_t on {states_t.device}")
    if states_t.dim() != 2 or states_t.shape[0] != D or states_t.shape[1] == 0:
        raise ValueError(f"states_t must be ({D}, B) with B > 0, got {tuple(states_t.shape)}")
    if env_returns.shape != (states_t.shape[1],):
        raise ValueError(f"env_returns must be ({states_t.shape[1]},), got {tuple(env_returns.shape)}")
    if net.shape != (LAYOUT.size,):
        raise ValueError(f"net must be the ({LAYOUT.size},) flat 2x64 actor-critic, got "
                         f"{tuple(net.shape)}")
    if consts.shape != (N_CONSTS,):
        raise ValueError(f"consts must be ({N_CONSTS},), got {tuple(consts.shape)}")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed must fit in uint32, got {seed}")
    if not 0 <= int(horizon) < 2**31:
        raise ValueError(f"horizon must be in [0, 2**31), got {horizon}")
    params = quad3d_params_vec() if params_vec is None else params_vec
    if params.shape != (len(_Q3_FIELDS),):
        raise ValueError(f"params_vec must be ({len(_Q3_FIELDS)},), got {tuple(params.shape)}")
    return params.detach().to("cpu", torch.float32)


def normal_draws(env_idx: torch.Tensor, step: int, seed: int) -> torch.Tensor:
    """K2's N(0, 1) action noise of envs ``env_idx`` at ``step``: Box-Muller
    (cosine branch) over two Philox blocks on stream 1, U[0, 1) by
    mantissa fill.  Returns ``(A, n)`` float32."""
    words = philox_words(env_idx, step, seed, 2, _NOISE_STREAM)
    u = mantissa_fill(words[:A]) - 1.0
    v = mantissa_fill(words[A:]) - 1.0
    return torch.sqrt(-2.0 * torch.log(1.0 - u)) * torch.cos(_TWO_PI * v)


def _towers(net: torch.Tensor, x: torch.Tensor):
    """The actor-critic on ``x`` (D, B), tower by tower: ``(mean (A, B),
    value (B,))``."""
    p = LAYOUT.unflatten(net)
    heads = []
    for tower in ("pi", "vf"):
        h = x
        for layer in p[tower]:
            h = torch.tanh(layer["w"].T @ h + layer["b"][:, None])
        heads.append(p[f"{tower}_out"]["w"].T @ h + p[f"{tower}_out"]["b"][:, None])
    return heads[0], heads[1][0]


def ppo_rollout_reference(states_t, env_returns, seed: int, net, consts, horizon: int,
                          params_vec: torch.Tensor | None = None, normalize_obs: bool = True,
                          normalize_rewards: bool = True) -> RolloutOut:
    """Plain PyTorch twin of K2, on any device: the same float32
    arithmetic and the same Philox draws.  Its products are float32
    matmuls; on a CUDA device the caller keeps TF32 off."""
    params = _check_args(states_t, env_returns, seed, net, consts, horizon, params_vec)
    p = dict(zip(_Q3_FIELDS, params.numpy()))
    half_dt = float(np.float32(0.5) * p["dt"])
    pos_lim2 = float(p["pos_limit"] * p["pos_limit"])
    vel_lim2 = float(p["vel_limit"] * p["vel_limit"])
    dt, gz, mass = float(p["dt"]), float(p["gravity"]), float(p["mass"])
    seed, horizon = int(seed), int(horizon)
    batch = states_t.shape[1]
    dev = states_t.device

    obs_mean, obs_invstd = consts[:D, None], consts[D:2 * D, None]
    std = consts[2 * D:2 * D + A, None]
    ls_sum, inv_ret_std, gamma = consts[2 * D + A], consts[2 * D + A + 1], consts[2 * D + A + 2]
    env_idx = torch.arange(batch, device=dev)

    s, ret = states_t.clone(), env_returns.clone()
    stats = torch.zeros(N_STATS, dtype=torch.float32, device=dev)
    cols = {k: [] for k in ("obs", "action", "log_prob", "value", "reward", "done")}
    for t in range(horizon):
        if normalize_obs:
            stats[:D] += s.sum(dim=1)
            stats[D:2 * D] += (s * s).sum(dim=1)
            x = torch.clamp((s - obs_mean) * obs_invstd, -10.0, 10.0)
        else:
            x = s
        mean, value = _towers(net, x)
        act = mean + std * normal_draws(env_idx, t, seed)
        z = (act - mean) * (1.0 / std)
        logp = -0.5 * (z * z).sum(dim=0) - ls_sum - _LOGP_CONST

        s, raw, done = quad3d_dynamics(s, body_z(s), act[0] / mass, act[1], act[2], act[3],
                                       dt, gz, half_dt, pos_lim2, vel_lim2)
        reward = raw
        if normalize_rewards:
            ret = ret * gamma + raw
            stats[2 * D] += ret.sum()
            stats[2 * D + 1] += (ret * ret).sum()
            reward = torch.clamp(raw * inv_ret_std, -10.0, 10.0)
            ret = ret * (1.0 - done.to(ret.dtype))
        stats[2 * D + 2] += raw.sum()
        idx = torch.nonzero(done).squeeze(1)
        if idx.numel():
            s[:, idx] = reset_draws(idx, t, seed, _RESET_STREAM)
        for k, v in zip(cols, (x, act, logp, value, reward, done)):
            cols[k].append(v)

    def stacked(k, shape):
        if horizon == 0:
            return torch.empty(shape, dtype=torch.bool if k == "done" else torch.float32,
                               device=dev)
        return torch.stack(cols[k])

    return RolloutOut(stacked("obs", (0, D, batch)), stacked("action", (0, A, batch)),
                      stacked("log_prob", (0, batch)), stacked("value", (0, batch)),
                      stacked("reward", (0, batch)), stacked("done", (0, batch)),
                      s, ret, stats)


def ppo_rollout(states_t, env_returns, seed: int, net, consts, horizon: int,
                params_vec: torch.Tensor | None = None, normalize_obs: bool = True,
                normalize_rewards: bool = True) -> RolloutOut:
    """K2: ``horizon`` policy + env steps of quadrotor3d-v0 in one CUDA launch.

    ``states_t`` ``(10, B)`` and ``env_returns`` ``(B,)`` float32, any
    ``B > 0``; ``seed`` the uint32 Philox key of the noise and reset
    streams; ``net`` the flat ``(10057,)`` 2x64 actor-critic
    (:class:`reinmav_tpu_torch.rl.networks.Layout`); ``consts``
    ``[obs_mean (10), obs_invstd (10), exp(log_std) (4), sum(log_std),
    1/sqrt(ret_var + 1e-8), gamma]`` on the same device; ``params_vec``
    the env's live Params (:func:`quad3d_params_vec`; default Params when
    None).  Returns :class:`RolloutOut`.  Launches on the current stream
    and does not synchronise.  A CPU tensor runs the plain twin; a CUDA
    tensor runs the kernel or raises.
    """
    params = _check_args(states_t, env_returns, seed, net, consts, horizon, params_vec)
    if states_t.device.type == "cpu":
        return ppo_rollout_reference(states_t, env_returns, seed, net, consts, horizon, params,
                                     normalize_obs, normalize_rewards)
    if states_t.device.type != "cuda":
        raise ValueError(f"unsupported device {states_t.device}")
    from .._build import check, load_library

    lib = load_library()
    batch = states_t.shape[1]
    T = int(horizon)
    f32 = dict(dtype=torch.float32, device=states_t.device)
    out = RolloutOut(
        torch.empty((T, D, batch), **f32), torch.empty((T, A, batch), **f32),
        torch.empty((T, batch), **f32), torch.empty((T, batch), **f32),
        torch.empty((T, batch), **f32),
        torch.empty((T, batch), dtype=torch.bool, device=states_t.device),
        torch.empty_like(states_t), torch.empty_like(env_returns), torch.empty(N_STATS, **f32))
    partials = torch.empty((-(-batch // _THREADS), N_STATS), **f32)
    host_params = (ctypes.c_float * len(_Q3_FIELDS))(*params.tolist())
    with torch.cuda.device(states_t.device):
        rc = lib.ppo_rollout_launch(
            states_t.data_ptr(), env_returns.data_ptr(), net.data_ptr(), consts.data_ptr(),
            batch, T, int(seed), int(normalize_obs), int(normalize_rewards),
            ctypes.addressof(host_params), *(t.data_ptr() for t in out[:8]),
            partials.data_ptr(), out.stats.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(rc, "ppo_rollout_launch")
    ppo_rollout.launches += 1
    return out


#: Kernel launches so far (a run can show that its path went through K2).
ppo_rollout.launches = 0
