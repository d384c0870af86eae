"""Kernels K2 and K6: the fused PPO rollout of quadrotor3d-v0 (K2), of the
hover task (K6-hover) and of quadrotor2d-v0 and the slung-load envs
(K6-rest), and its plain twin.

The counterpart of :mod:`reinmav_tpu.ops.pallas_ppo_rollout` (every kind of
its ``_ENVS``).  :func:`ppo_rollout` runs
the whole rollout phase of PPO in one CUDA kernel written by hand for
Hopper (``csrc/ppo_rollout.cu``, a template on the env): obs
normalisation, the 2x64 tanh actor-critic, the Gaussian action with logp
from the rounded action, the env step, auto-reset, the return-scaled
reward, the raw moment sums and the trajectory.
:func:`ppo_rollout_reference` is its plain PyTorch twin: the same
arithmetic and the same Philox4x32-10 draws (noise on stream 1, the
U(-1, 1)^D resets on stream 2 of
:func:`reinmav_tpu_torch.ops.rollout.philox_words`; the hover task resets
deterministically), so the two agree on the card with noise and resets
on, and the CPU tests run the twin.  ``env_base`` is added to each env's
index in the Philox counters: a rank holding envs ``env_base`` onwards of
a global batch draws what those envs draw in the one-rank run (0, the
default, is every earlier call's draws).  :data:`ENVS` is the per-env table
(state and action dims, params pack) that the wrapper and the learner
read, as the JAX package's ``_ENVS``.

``compute_dtype="bfloat16"`` is the TPU kernel's bf16 mode: the operands
of every actor-critic product (the weights, the normalised obs, both
hidden layers) rounded to bf16, the exact products summed in float32;
the trajectory keeps the float32 normalised obs.  The twin then sums in
the kernel's order (:func:`_towers_bf16`), so that the two agree bit for
bit wherever their float32 operations do.

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel of the dtype asked for or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..rl.networks import Layout, bf16_round, is_bf16
from . import closed_loop_rollout as cl_ops
from . import hover_rollout as hover_ops
from .rollout import (_Q3_FIELDS, body_z, mantissa_fill, philox_words, quad3d_dynamics,
                      quad3d_params_vec, reset_draws)


class EnvKind(NamedTuple):
    """One env kind of the kernel: its id in the C entry point, the state
    (= obs) and action dims, and the pack of its live Params into the
    kernel's float32 params vector."""

    kind_id: int
    state_dim: int
    action_dim: int
    pack: Callable


#: env name -> :class:`EnvKind` (the JAX package's ``_ENVS``); the ids are
#: those of ``csrc/env_kinds.cuh``.
ENVS = {
    "quadrotor3d-v0": EnvKind(0, 10, 4, quad3d_params_vec),
    "MujocoQuadForce-v1": EnvKind(1, 13, 4, hover_ops.hover_params_vec),
    **{name: EnvKind(k.kind_id, k.state_dim, k.action_dim, k.pack)
       for name, k in cl_ops.KINDS.items()},
}

#: The kernel's 2x64 actor-critic (csrc/actor_critic.cuh).
HIDDEN = (64, 64)
_THREADS = 128  # CTA size of the kernel, for the partials scratch
_NOISE_STREAM, _RESET_STREAM = 1, 2
_TWO_PI = 2.0 * math.pi


def logp_const(adim: int) -> float:
    """``0.5 A log(2 pi)`` as the kernel forms it in float32."""
    return float(np.float32(0.5 * adim) * np.float32(math.log(2.0 * math.pi)))


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


def env_params_vec(env) -> torch.Tensor:
    """``env``'s LIVE Params -> the kernel's float32 params vector (the
    pack of its :data:`ENVS` entry)."""
    return ENVS[env.name].pack(env.params)


def n_stats(env_kind: str) -> int:
    """The number of moment sums of a kind: obs sum (D), obs sum of squares
    (D), return sum, return sum of squares, raw reward sum."""
    return 2 * ENVS[env_kind].state_dim + 3


def _check_args(states_t, env_returns, seed, net, consts, horizon, params_vec,
                env_kind, env_base: int = 0) -> torch.Tensor:
    """Validate what the kernel takes; returns the kind's params vector."""
    if env_kind not in ENVS:
        raise ValueError(f"env_kind {env_kind!r}: the kernel takes {sorted(ENVS)}")
    kind = ENVS[env_kind]
    d = kind.state_dim
    for name, t in (("states_t", states_t), ("env_returns", env_returns), ("net", net),
                    ("consts", consts)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != states_t.device:
            raise ValueError(f"{name} is on {t.device}, states_t on {states_t.device}")
    if states_t.dim() != 2 or states_t.shape[0] != d or states_t.shape[1] == 0:
        raise ValueError(f"states_t must be ({d}, B) with B > 0, got {tuple(states_t.shape)}")
    if env_returns.shape != (states_t.shape[1],):
        raise ValueError(f"env_returns must be ({states_t.shape[1]},), got {tuple(env_returns.shape)}")
    layout = Layout(d, kind.action_dim, HIDDEN)
    if net.shape != (layout.size,):
        raise ValueError(f"net must be the ({layout.size},) flat 2x64 actor-critic, got "
                         f"{tuple(net.shape)}")
    n_consts = 2 * d + kind.action_dim + 3
    if consts.shape != (n_consts,):
        raise ValueError(f"consts must be ({n_consts},), got {tuple(consts.shape)}")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed must fit in uint32, got {seed}")
    if not 0 <= int(horizon) < 2**31:
        raise ValueError(f"horizon must be in [0, 2**31), got {horizon}")
    if not (0 <= int(env_base) and int(env_base) + states_t.shape[1] <= 2**32):
        raise ValueError(f"env_base + B must fit in uint32, got {env_base} + {states_t.shape[1]}")
    params = kind.pack(None) if params_vec is None else params_vec
    n_params = kind.pack(None).shape[0]
    if params.shape != (n_params,):
        raise ValueError(f"params_vec must be ({n_params},), got {tuple(params.shape)}")
    return params.detach().to("cpu", torch.float32)


def normal_draws(env_idx: torch.Tensor, step: int, seed: int, adim: int = 4,
                 stream: int = _NOISE_STREAM) -> torch.Tensor:
    """The kernels' N(0, 1) action noise of envs ``env_idx`` at ``step``:
    Box-Muller (cosine branch) over two Philox blocks on ``stream`` (K2's
    1, K7's 3), U[0, 1) by mantissa fill; action ``a`` takes word ``a`` of
    each block.  Returns ``(adim, n)`` float32."""
    words = philox_words(env_idx, step, seed, 2, stream)
    u = mantissa_fill(words[:adim]) - 1.0
    v = mantissa_fill(words[4:4 + adim]) - 1.0
    return torch.sqrt(-2.0 * torch.log(1.0 - u)) * torch.cos(_TWO_PI * v)


def _towers(net: torch.Tensor, x: torch.Tensor, adim: int):
    """The actor-critic on ``x`` (D, B), tower by tower: ``(mean (A, B),
    value (B,))``."""
    p = Layout(x.shape[0], adim, HIDDEN).unflatten(net)
    heads = []
    for tower in ("pi", "vf"):
        h = x
        for layer in p[tower]:
            h = torch.tanh(layer["w"].T @ h + layer["b"][:, None])
        heads.append(p[f"{tower}_out"]["w"].T @ h + p[f"{tower}_out"]["b"][:, None])
    return heads[0], heads[1][0]


def _towers_bf16(net: torch.Tensor, x: torch.Tensor, adim: int):
    """:func:`_towers` with bf16 products, summed in the bf16 kernel's
    order: each first-layer unit from its bias over the obs dims in order;
    each second-layer unit from its bias, adding the partial sum of each
    run of 4 inputs (``((p0 + p1) + p2) + p3``); each head from its bias
    over the units in order.  Every product of two bf16 values is exact in
    float32, so each sum rounds as the kernel's FMA chain does."""
    p = Layout(x.shape[0], adim, HIDDEN).unflatten(net)
    r = bf16_round
    xr = r(x)
    heads = []
    for tower in ("pi", "vf"):
        (l1, l2), out = p[tower], p[f"{tower}_out"]
        w1, w2, wo = r(l1["w"]), r(l2["w"]), r(out["w"])
        z = l1["b"][:, None].expand(-1, x.shape[1])
        for d in range(x.shape[0]):
            z = z + w1[d][:, None] * xr[d]
        h1 = r(torch.tanh(z))
        z = l2["b"][:, None].expand(-1, x.shape[1])
        for q in range(0, h1.shape[0], 4):
            part = w2[q][:, None] * h1[q] + w2[q + 1][:, None] * h1[q + 1]
            part = part + w2[q + 2][:, None] * h1[q + 2]
            z = z + (part + w2[q + 3][:, None] * h1[q + 3])
        h2 = r(torch.tanh(z))
        head = out["b"][:, None].expand(-1, x.shape[1])
        for j in range(h2.shape[0]):
            head = head + wo[j][:, None] * h2[j]
        heads.append(head)
    return heads[0], heads[1][0]


def _env_twin(env_kind: str, params: torch.Tensor, reset_stream: int = _RESET_STREAM):
    """``(step, reset)`` of a kind in the kernel's arithmetic: ``step(s,
    act) -> (states, raw reward, done)`` on ``(D, B)`` states and ``(A,
    B)`` actions; ``reset(s, done, t, seed)`` resets the done envs of
    ``s`` in place (U(-1, 1)^D from Philox stream ``reset_stream``), env
    ``i`` of ``s`` drawing as env ``env_base + i``."""
    if env_kind == "MujocoQuadForce-v1":
        return _hover_twin(params)

    def uniform_reset(s, done, t, seed, env_base=0):
        idx = torch.nonzero(done).squeeze(1)
        if idx.numel():
            s[:, idx] = reset_draws(idx + env_base, t, seed, reset_stream, s.shape[0])

    if env_kind in cl_ops.KINDS:
        return cl_ops.env_twin(env_kind, params)[1], uniform_reset
    p = dict(zip(_Q3_FIELDS, params.numpy()))
    half_dt = float(np.float32(0.5) * p["dt"])
    pos_lim2 = float(p["pos_limit"] * p["pos_limit"])
    vel_lim2 = float(p["vel_limit"] * p["vel_limit"])
    dt, gz, mass = float(p["dt"]), float(p["gravity"]), float(p["mass"])

    def quad3d_step(s, act):
        return quad3d_dynamics(s, body_z(s), act[0] / mass, act[1], act[2], act[3], dt, gz,
                               half_dt, pos_lim2, vel_lim2)

    return quad3d_step, uniform_reset


def _hover_twin(params: torch.Tensor):
    """The hover task's ``(step, reset)`` for :func:`_env_twin`: two
    substeps of hover_rollout's arithmetic, the deterministic reset."""
    c = hover_ops.hover_consts(params)
    fresh = torch.tensor([0.0, 0.0, c["init_z"], 1.0] + [0.0] * 9, dtype=torch.float32)

    def hover_step(s, act):
        wrench = hover_ops.hover_wrench(act.unbind(0), c)
        rows = hover_ops.hover_substep(list(s.unbind(0)), c, wrench)
        rows = hover_ops.hover_substep(rows, c, wrench)
        terms, done = hover_ops.hover_reward_done(rows)
        a0, a1, a2, a3 = act.unbind(0)
        a_sq = a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3
        raw = terms - a_sq + 0.1 * (a0 + a1 + a2 + a3) + 100.0
        return torch.stack(rows), raw, done

    def hover_reset(s, done, t, seed, env_base=0):
        del t, seed, env_base
        s[:, done] = fresh.to(s.device)[:, None]

    return hover_step, hover_reset


def _check_counts(counts, states_t, env_kind, normalize_obs, normalize_rewards) -> None:
    """The taut counts are the slung-load kinds', both normalisers on."""
    if counts is not None and (env_kind not in cl_ops.TAUT_KINDS
                               or not (normalize_obs and normalize_rewards)):
        raise ValueError("taut counts are kept for the slung-load kinds with both normalisers "
                         f"on, not {env_kind!r} ({normalize_obs}, {normalize_rewards})")
    cl_ops.check_counts(counts, states_t)


def ppo_rollout_reference(states_t, env_returns, seed: int, net, consts, horizon: int,
                          params_vec: torch.Tensor | None = None, normalize_obs: bool = True,
                          normalize_rewards: bool = True,
                          env_kind: str = "quadrotor3d-v0",
                          counts: torch.Tensor | None = None,
                          compute_dtype=None, env_base: int = 0) -> RolloutOut:
    """Plain PyTorch twin of K2 / K6, on any device: the same float32
    arithmetic and the same Philox draws (env ``i`` as env ``env_base +
    i``).  Its products are float32
    matmuls (on a CUDA device the caller keeps TF32 off), or with
    ``compute_dtype`` "bfloat16" the bf16 products of :func:`_towers_bf16`."""
    towers = _towers_bf16 if is_bf16(compute_dtype) else _towers
    params = _check_args(states_t, env_returns, seed, net, consts, horizon, params_vec, env_kind,
                         env_base)
    _check_counts(counts, states_t, env_kind, normalize_obs, normalize_rewards)
    env_step, env_reset = _env_twin(env_kind, params)
    taut = cl_ops.taut_twin(env_kind, params) if counts is not None else None
    D, A = ENVS[env_kind].state_dim, ENVS[env_kind].action_dim
    seed, horizon = int(seed), int(horizon)
    batch = states_t.shape[1]
    dev = states_t.device

    obs_mean, obs_invstd = consts[:D, None], consts[D:2 * D, None]
    std = consts[2 * D:2 * D + A, None]
    ls_sum, inv_ret_std, gamma = consts[2 * D + A], consts[2 * D + A + 1], consts[2 * D + A + 2]
    env_idx = torch.arange(batch, device=dev) + int(env_base)

    s, ret = states_t.clone(), env_returns.clone()
    count = torch.zeros(batch, dtype=torch.int32, device=dev)
    stats = torch.zeros(n_stats(env_kind), dtype=torch.float32, device=dev)
    cols = {k: [] for k in ("obs", "action", "log_prob", "value", "reward", "done")}
    for t in range(horizon):
        if normalize_obs:
            stats[:D] += s.sum(dim=1)
            stats[D:2 * D] += (s * s).sum(dim=1)
            x = torch.clamp((s - obs_mean) * obs_invstd, -10.0, 10.0)
        else:
            x = s
        mean, value = towers(net, x, A)
        act = mean + std * normal_draws(env_idx, t, seed, A)
        z = (act - mean) * (1.0 / std)
        logp = -0.5 * (z * z).sum(dim=0) - ls_sum - logp_const(A)

        if taut is not None:
            count += taut(s)
        s, raw, done = env_step(s, act)
        reward = raw
        if normalize_rewards:
            ret = ret * gamma + raw
            stats[2 * D] += ret.sum()
            stats[2 * D + 1] += (ret * ret).sum()
            reward = torch.clamp(raw * inv_ret_std, -10.0, 10.0)
            ret = ret * (1.0 - done.to(ret.dtype))
        stats[2 * D + 2] += raw.sum()
        env_reset(s, done, t, seed, int(env_base))
        for k, v in zip(cols, (x, act, logp, value, reward, done)):
            cols[k].append(v)

    if counts is not None:
        counts.copy_(count)

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
                normalize_rewards: bool = True, env_kind: str = "quadrotor3d-v0",
                counts: torch.Tensor | None = None, compute_dtype=None,
                env_base: int = 0) -> RolloutOut:
    """K2 (quadrotor3d-v0) or K6 (the other kinds of :data:`ENVS`):
    ``horizon`` policy + env steps in one CUDA launch.

    ``env_kind`` an :data:`ENVS` name; ``states_t`` ``(D, B)`` (D its
    state dim) and ``env_returns`` ``(B,)`` float32, any ``B > 0``;
    ``seed`` the uint32 Philox key of the noise and reset streams; ``net``
    the flat 2x64 actor-critic of the kind's obs dim D and action dim A
    (:class:`reinmav_tpu_torch.rl.networks.Layout`); ``consts``
    ``[obs_mean (D), obs_invstd (D), exp(log_std) (A), sum(log_std),
    1/sqrt(ret_var + 1e-8), gamma]`` on the same device; ``params_vec``
    the env's live Params packed by the kind's ``pack`` (default Params
    when None).  ``counts``: None (every training path), or a ``(B,)``
    int32 tensor on the states' device that receives each env's taut
    env-steps, the tether taut at the start of the step (the slung-load
    kinds with both normalisers on: a counting instance of the kernel,
    bitwise the main path's otherwise).  ``compute_dtype`` None or
    "float32", or "bfloat16" (the kernel's bf16 instance, the twin's
    :func:`_towers_bf16`).  ``env_base``: the global index of env 0 of
    ``states_t`` in the Philox counters (a rank's first env when the batch
    is split over ranks; 0 on one rank).  Returns :class:`RolloutOut`.
    Launches on the current stream and does not synchronise.  A CPU tensor
    runs the plain twin; a CUDA tensor runs the kernel or raises.
    """
    bf16 = is_bf16(compute_dtype)
    params = _check_args(states_t, env_returns, seed, net, consts, horizon, params_vec, env_kind,
                         env_base)
    _check_counts(counts, states_t, env_kind, normalize_obs, normalize_rewards)
    if states_t.device.type == "cpu":
        return ppo_rollout_reference(states_t, env_returns, seed, net, consts, horizon, params,
                                     normalize_obs, normalize_rewards, env_kind, counts,
                                     compute_dtype, env_base)
    if states_t.device.type != "cuda":
        raise ValueError(f"unsupported device {states_t.device}")
    from .._build import check, load_library

    lib = load_library()
    kind = ENVS[env_kind]
    D, A, batch, T = kind.state_dim, kind.action_dim, states_t.shape[1], int(horizon)
    f32 = dict(dtype=torch.float32, device=states_t.device)
    out = RolloutOut(
        torch.empty((T, D, batch), **f32), torch.empty((T, A, batch), **f32),
        torch.empty((T, batch), **f32), torch.empty((T, batch), **f32),
        torch.empty((T, batch), **f32),
        torch.empty((T, batch), dtype=torch.bool, device=states_t.device),
        torch.empty_like(states_t), torch.empty_like(env_returns),
        torch.empty(n_stats(env_kind), **f32))
    partials = torch.empty((-(-batch // _THREADS), n_stats(env_kind)), **f32)
    host_params = (ctypes.c_float * params.shape[0])(*params.tolist())
    with torch.cuda.device(states_t.device):
        rc = lib.ppo_rollout_launch(
            kind.kind_id, states_t.data_ptr(), env_returns.data_ptr(), net.data_ptr(),
            consts.data_ptr(), batch, T, int(seed), int(env_base), int(normalize_obs),
            int(normalize_rewards),
            int(bf16),
            ctypes.addressof(host_params), params.shape[0], *(t.data_ptr() for t in out[:8]),
            partials.data_ptr(), out.stats.data_ptr(),
            None if counts is None else counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "ppo_rollout_launch")
    ppo_rollout.launches += 1
    return out


#: Kernel launches so far (a run can show that its path went through K2 or
#: K6).
ppo_rollout.launches = 0
