"""PPO learner of the PyTorch port.

The counterpart of :mod:`reinmav_tpu.rl.ppo`: clipped surrogate (or the
adaptive-KL penalty), GAE(lambda), minibatch epochs, value clipping, an
entropy bonus, with the reference's defaults (ppo2's: lr 3e-4, gamma
0.99, lambda 0.95, clip 0.2, 4 epochs, 4 minibatches), and the optimiser
optax's ``chain(clip_by_global_norm(0.5), adam(lr, eps=1e-5))``.

One update (:func:`train_step`) is the rollout followed by
:func:`update_phase`.  The rollout runs in the fused CUDA kernel
(:mod:`reinmav_tpu_torch.ops.ppo_rollout`: K2 for quadrotor3d-v0,
K6-hover for MujocoQuadForce-v1, K6 for quadrotor2d-v0 and the slung-load
envs) when the states lie on the card and the env is the registry's, else
as the eager loop :func:`collect_rollout`.  The update runs on the card as ONE launch
of the K4 CUDA kernel (:mod:`reinmav_tpu_torch.ops.ppo_update`: every
epoch x minibatch pass of the loss gradient, clip + Adam and the floor),
as the JAX package's ``fused_update`` does on its accelerator; with
``fused_update="off"`` it is a loop over the minibatches whose loss
gradient runs in the K3 CUDA kernel (:mod:`reinmav_tpu_torch.ops.ppo_loss`)
on the card, else through ``torch.autograd`` of :func:`ppo_loss`.  K3
and K4 are built for the (obs, action) dims of the envs that K2/K6 take
(``ops/ppo_loss.py::KERNEL_DIMS``); an env of other dims takes the loop
through autograd on the card.  ``train_step`` logs which paths ran and why.

Across ranks (:mod:`reinmav_tpu_torch.parallel`), as the JAX package's two
mesh paths: :func:`make_train_step` with a mesh runs the one-rank update
on a batch split over the ranks (each rank rolls out its envs with the
one-rank run's draws, the trajectory is gathered and every rank runs the
same whole update, K4 included), and :func:`make_train_step_shardmap` the
MPI data-parallel recipe (each rank its own rollout stream and
minibatches, each minibatch's gradient all-reduced, K4 off).

State is functional as in the JAX package (each update returns a new
:class:`TrainState`), with one exception: ``TrainState.generator``, a
CPU ``torch.Generator`` in place of the PRNG key, advances in place.
It draws only host integers (the rollout's seed, the shuffle), so an
update never waits on the device for its random numbers.  Parameters,
gradients and Adam moments are flat vectors in
:class:`reinmav_tpu_torch.rl.networks.Layout` order.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..envs.core import EnvDef, episode_boundary, fused_kernel_mismatch
from ..ops import ppo_loss as loss_ops
from ..ops import ppo_rollout as rollout_ops
from ..ops import ppo_update as update_ops
from ..parallel.mesh import Mesh, fold_in
from . import networks
from .networks import Layout

log = logging.getLogger(__name__)


class PpoConfig(NamedTuple):
    """The JAX package's ``PpoConfig``: the same fields and defaults (see
    there for each).  ``compute_dtype="bfloat16"`` rounds the operands of
    every policy/value product to bf16 and sums in float32, on every path
    (the eager loops, and the bf16 instances of K2/K6, K3 and K4); the
    master params and the Adam state stay float32.  As in the JAX package
    the two update paths are then not gradient-identical: K3/K4
    back-propagate tanh through the float32 activation, autograd through
    the bf16 residual (:class:`.networks.TanhBf16Residual`), so toggling
    ``fused_loss`` shifts the gradients at bf16 rounding magnitude."""

    num_envs: int = 1024
    rollout_len: int = 128
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_clip_eps: float = 0.2
    kl_target: float | None = None
    entropy_coef: float = 0.0
    log_std_floor: float | None = None
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_epochs: int = 4
    num_minibatches: int = 4
    hidden: tuple = (64, 64)
    normalize_obs: bool = True
    normalize_rewards: bool = True
    normalize_advantages: bool = True
    compute_dtype: str = "float32"
    shuffle_tile: int = 128
    fused_loss: str = "auto"
    fused_update: str = "auto"
    fused_rollout: str = "auto"


class ObsNorm(NamedTuple):
    """Running observation normalisation (the VecNormalize role)."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


class RetNorm(NamedTuple):
    """Running discounted-return scale for reward normalisation."""

    var: torch.Tensor  # scalar
    count: torch.Tensor  # scalar


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState`` on the flat parameter vector."""

    count: torch.Tensor  # int32 scalar
    mu: torch.Tensor
    nu: torch.Tensor


class TrainState(NamedTuple):
    params: torch.Tensor  # flat, networks.Layout order
    opt_state: AdamState
    env_states: torch.Tensor  # (B, D)
    obs_norm: ObsNorm
    ret_norm: RetNorm
    env_returns: torch.Tensor  # (B,) running discounted returns
    generator: torch.Generator  # CPU; host draws only (see the module docstring)
    update_step: int
    kl_beta: torch.Tensor  # adaptive-KL coefficient (used only with cfg.kl_target)


class Transition(NamedTuple):
    """One batched transition, feature axis first: ``obs``/``action``
    ``(T, D|A, B)`` stacked, ``(D|A, n)`` flattened; scalars ``(T, B)`` /
    ``(n,)``."""

    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


class RawObsMoments(NamedTuple):
    """Streaming raw moments gathered during a rollout."""

    total: torch.Tensor
    total_sq: torch.Tensor
    count: torch.Tensor


class Rollout(NamedTuple):
    """What a rollout gives the update: ``final_states`` ``(B, D)``, the
    carried ``env_returns``, the trajectory (``obs`` the normalised obs
    the policy saw, ``reward`` the scaled reward), the RAW obs and return
    moments, and the mean RAW reward."""

    final_states: torch.Tensor
    env_returns: torch.Tensor
    traj: Transition
    obs_moments: RawObsMoments
    ret_moments: RawObsMoments
    raw_reward_mean: torch.Tensor


def check_compute_dtype(cfg) -> None:
    """Raise ``ValueError`` unless a config's (PPO's, SAC's or TD3's)
    ``compute_dtype`` is "float32" or "bfloat16"."""
    networks.is_bf16(cfg.compute_dtype)


def _normalize_t(obs_t, norm: ObsNorm):
    """Transposed normalisation: ``obs_t`` is ``(D, *batch)``."""
    shape = norm.mean.shape + (1,) * (obs_t.dim() - 1)
    std = torch.sqrt(norm.var + 1e-8).reshape(shape)
    return torch.clamp((obs_t - norm.mean.reshape(shape)) / std, -10.0, 10.0)


def _update_obs_norm(norm: ObsNorm, moments: RawObsMoments) -> ObsNorm:
    """Welford-style parallel update from the rollout's raw moments."""
    b_count = moments.count
    b_mean = moments.total / b_count
    b_var = torch.clamp(moments.total_sq / b_count - torch.square(b_mean), min=0.0)
    delta = b_mean - norm.mean
    tot = norm.count + b_count
    new_mean = norm.mean + delta * (b_count / tot)
    m2 = torch.clamp(norm.var * norm.count + b_var * b_count
                     + torch.square(delta) * norm.count * b_count / tot, min=0.0)
    return ObsNorm(new_mean, m2 / tot, tot)


def _update_ret_norm(norm: RetNorm, moments: RawObsMoments) -> RetNorm:
    """Running variance of the discounted return (mean NOT subtracted)."""
    b_count = moments.count
    b_var = moments.total_sq / b_count
    tot = norm.count + b_count
    return RetNorm((norm.var * norm.count + b_var * b_count) / tot, tot)


class ClipAdam(NamedTuple):
    """optax ``chain(clip_by_global_norm(max_norm), adam(lr, eps))`` on flat
    vectors, written as optax computes it: the gradient is scaled by
    ``max_norm / norm`` only when its global norm is at least ``max_norm``
    (``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
    1e-6)`` whenever it is called), then bias-corrected Adam with ``eps``
    outside the square root.  ``max_norm`` None is optax's plain
    ``adam(lr, eps)`` (the off-policy learners' optimiser without
    ``max_grad_norm``)."""

    max_norm: float | None
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-5

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(torch.zeros((), dtype=torch.int32, device=params.device),
                         torch.zeros_like(params), torch.zeros_like(params))

    def update(self, grads: torch.Tensor, state: AdamState, params: torch.Tensor):
        """One step (:func:`reinmav_tpu_torch.ops.ppo_update.clip_adam`, the
        arithmetic K4 runs): returns ``(new params, new state)``."""
        count = state.count + 1
        params, mu, nu = update_ops.clip_adam(grads, count, state.mu, state.nu, params,
                                              max_norm=self.max_norm, lr=self.lr, b1=self.b1,
                                              b2=self.b2, eps=self.eps)
        return params, AdamState(count, mu, nu)


def make_optimizer(cfg: PpoConfig) -> ClipAdam:
    return ClipAdam(cfg.max_grad_norm, cfg.learning_rate)


def _adam_leaf(opt_state):
    """The ``ScaleByAdamState`` inside an optax state tree (``adam``'s, or
    ``chain(clip_by_global_norm, adam)``'s)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for child in opt_state:
            found = _adam_leaf(child)
            if found is not None:
                return found
    return None


def adam_from_jax(opt_state, flatten, device=None, dtype=torch.float32) -> AdamState:
    """An optax Adam state (leaves as NumPy or JAX arrays) -> the port's
    :class:`AdamState`, ``flatten(tree)`` mapping ``mu``/``nu`` to flat
    vectors."""
    adam = _adam_leaf(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optimiser state")
    return AdamState(torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=device),
                     flatten(adam.mu).to(device=device, dtype=dtype),
                     flatten(adam.nu).to(device=device, dtype=dtype))


def adam_state_from_jax(opt_state, device=None, dtype=torch.float32) -> AdamState:
    """optax's ``(EmptyState, (ScaleByAdamState(count, mu, nu),
    EmptyState))`` for ``chain(clip_by_global_norm, adam)``, leaves as
    NumPy or JAX arrays -> the port's :class:`AdamState` (the actor-critic's
    moments flattened by :func:`networks.params_from_jax`)."""
    return adam_from_jax(opt_state, lambda t: networks.params_from_jax(t, dtype=dtype),
                         device, dtype)


def _device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _draw_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator))


def init_train_state(env: EnvDef, cfg: PpoConfig, seed: int = 0, device="cuda") -> TrainState:
    """Fresh params (orthogonal init), optimiser, env states, normalisers;
    on ``device`` (the card unless the caller asks for the CPU)."""
    check_compute_dtype(cfg)
    generator = torch.Generator().manual_seed(seed)
    layout = Layout(env.obs_dim, env.action_dim, cfg.hidden)
    params = networks.init_params(layout, generator).to(device)
    env_states = env.vreset(_device_generator(_draw_seed(generator), device), cfg.num_envs)
    f32 = dict(dtype=torch.float32, device=device)
    return TrainState(
        params, make_optimizer(cfg).init(params), env_states,
        ObsNorm(torch.zeros(env.obs_dim, **f32), torch.ones(env.obs_dim, **f32),
                torch.tensor(1e-4, **f32)),
        RetNorm(torch.tensor(1.0, **f32), torch.tensor(1e-4, **f32)),
        torch.zeros(cfg.num_envs, **f32), generator, 0, torch.tensor(1.0, **f32))


def _sliced_step(env: EnvDef, tree, norm_obs, states_t, generator, compute_dtype, rows: slice,
                 global_batch: int):
    """One policy + env step of the envs ``rows`` of a ``global_batch``:
    :func:`networks.sample_action_t` and ``env.autoreset_step_t`` with the
    noise and the reset states drawn for the whole batch and cut to
    ``rows``, so that each env draws what it draws in the one-rank loop."""
    mean, log_std, value = networks.apply_t(tree, norm_obs, compute_dtype)
    std = torch.exp(log_std).reshape(log_std.shape + (1,))
    noise = torch.randn((mean.shape[0], global_batch), generator=generator, device=mean.device,
                        dtype=mean.dtype)[:, rows]
    action = mean + std * noise
    out = env.vstep(states_t.T, action.T)
    fresh = env.vreset(generator, global_batch, device=states_t.device,
                       dtype=out.state.dtype)[rows]
    out = out._replace(state=torch.where(episode_boundary(out)[:, None], fresh, out.state))
    return (action, networks.gaussian_log_prob_t(mean, log_std, action), value,
            out._replace(state=out.state.T, obs=out.obs.T))


@torch.no_grad()
def collect_rollout(env: EnvDef, cfg: PpoConfig, params, obs_norm: ObsNorm, ret_norm: RetNorm,
                    env_states, env_returns, generator: torch.Generator, env_base: int = 0,
                    global_batch: int | None = None) -> Rollout:
    """``cfg.rollout_len`` policy + env steps as an eager loop in the
    ``(D, B)`` layout (the JAX package's ``collect_rollout`` with
    ``dense8=False``).  Noise and resets come from ``generator``, which
    lives on the device of the states.  The states are the envs
    ``env_base`` onwards of a batch of ``global_batch`` envs (by default
    their own count; a rank's shard in the mesh mode): each step draws the
    noise and reset states of the whole batch and keeps its envs'
    (:func:`_sliced_step`)."""
    tree = Layout(env.obs_dim, env.action_dim, cfg.hidden).unflatten(params)
    batch = env_states.shape[0]
    rows = slice(env_base, env_base + batch)
    global_batch = batch if global_batch is None else global_batch
    dtype, dev = env_states.dtype, env_states.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    omom = RawObsMoments(torch.zeros(env.obs_dim, dtype=dtype, device=dev),
                         torch.zeros(env.obs_dim, dtype=dtype, device=dev), zero)
    rmom = RawObsMoments(zero, zero, zero)
    raw_rew_sum = zero
    states_t, ret = env_states.T, env_returns
    steps = []
    for _ in range(cfg.rollout_len):
        obs_t = states_t[:env.obs_dim]
        if cfg.normalize_obs:
            omom = RawObsMoments(omom.total + obs_t.sum(dim=1),
                                 omom.total_sq + torch.square(obs_t).sum(dim=1),
                                 omom.count + batch)
        norm_obs = _normalize_t(obs_t, obs_norm) if cfg.normalize_obs else obs_t
        action, log_prob, value, out = _sliced_step(env, tree, norm_obs, states_t, generator,
                                                    cfg.compute_dtype, rows, global_batch)
        done = episode_boundary(out)
        reward = out.reward
        if cfg.normalize_rewards:
            ret = ret * cfg.gamma + reward
            rmom = RawObsMoments(rmom.total + ret.sum(), rmom.total_sq + torch.square(ret).sum(),
                                 rmom.count + batch)
            reward = torch.clamp(reward / torch.sqrt(ret_norm.var + 1e-8), -10.0, 10.0)
            ret = ret * (1.0 - done.to(ret.dtype))
        raw_rew_sum = raw_rew_sum + out.reward.sum()
        steps.append(Transition(norm_obs, action, log_prob, value, reward, done))
        states_t = out.state
    traj = Transition(*(torch.stack(field) for field in zip(*steps)))
    return Rollout(states_t.T, ret, traj, omom, rmom,
                   raw_rew_sum / (cfg.rollout_len * batch))


def _rollout_consts(params, layout: Layout, obs_norm: ObsNorm, ret_norm: RetNorm,
                    gamma: float) -> torch.Tensor:
    """K2's constants ``[obs_mean, obs_invstd, exp(log_std), sum(log_std),
    1/sqrt(ret_var + 1e-8), gamma]`` as one float32 vector on the device."""
    ls = params[layout.slices[("log_std",)]].to(torch.float32)
    f32 = lambda t: t.to(torch.float32).reshape(-1)  # noqa: E731
    return torch.cat([
        f32(obs_norm.mean), f32(1.0 / torch.sqrt(obs_norm.var + 1e-8)), torch.exp(ls),
        ls.sum().reshape(1), f32(1.0 / torch.sqrt(ret_norm.var + 1e-8)),
        torch.full((1,), gamma, dtype=torch.float32, device=params.device)])


@torch.no_grad()
def collect_rollout_kernel(env: EnvDef, cfg: PpoConfig, params, obs_norm: ObsNorm,
                           ret_norm: RetNorm, env_states, env_returns, seed: int,
                           env_base: int = 0) -> Rollout:
    """The rollout through the fused kernel of ``env``'s kind, K2 or
    K6-hover (:func:`reinmav_tpu_torch.ops.ppo_rollout.ppo_rollout`, with
    the env's live Params packed by the kind's entry of its ``ENVS``
    table): the kernel on a CUDA tensor, its plain twin on a CPU one.  Same
    return contract as :func:`collect_rollout`; the noise and
    quadrotor3d's resets come from the kernel's Philox streams keyed by
    ``seed``, env ``i`` of the states counted as env ``env_base + i``."""
    layout = Layout(env.obs_dim, env.action_dim, cfg.hidden)
    out = rollout_ops.ppo_rollout(
        env_states.T.to(torch.float32).contiguous(), env_returns.to(torch.float32).contiguous(),
        seed, params.to(torch.float32).contiguous(),
        _rollout_consts(params, layout, obs_norm, ret_norm, cfg.gamma), cfg.rollout_len,
        params_vec=rollout_ops.env_params_vec(env), normalize_obs=cfg.normalize_obs,
        normalize_rewards=cfg.normalize_rewards, env_kind=env.name,
        compute_dtype=cfg.compute_dtype, env_base=env_base)
    d = env.obs_dim
    n = torch.tensor(float(cfg.rollout_len * env_states.shape[0]), device=env_states.device)
    s = out.stats
    traj = Transition(out.obs, out.action, out.log_prob, out.value, out.reward, out.done)
    return Rollout(out.final_states.T, out.returns, traj,
                   RawObsMoments(s[:d], s[d:2 * d], n), RawObsMoments(s[2 * d], s[2 * d + 1], n),
                   s[2 * d + 2] / n)


def compute_gae(cfg: PpoConfig, traj: Transition, last_value):
    """GAE(lambda) with done-masked bootstrapping, a reverse loop over T."""
    dtype = torch.promote_types(traj.value.dtype, traj.reward.dtype)
    advantages = torch.empty(traj.value.shape, dtype=dtype, device=traj.value.device)
    gae = torch.zeros_like(last_value, dtype=dtype)
    next_value = last_value.to(dtype)
    for t in range(traj.value.shape[0] - 1, -1, -1):
        not_done = 1.0 - traj.done[t].to(dtype)
        delta = traj.reward[t] + cfg.gamma * next_value * not_done - traj.value[t]
        gae = delta + (cfg.gamma * cfg.gae_lambda) * not_done * gae
        advantages[t] = gae
        next_value = traj.value[t].to(dtype)
    return advantages, advantages + traj.value


def ppo_loss(params, cfg: PpoConfig, batch: Transition, advantages, returns,
             compute_dtype=None, kl_beta=None):
    """PPO loss on a transposed minibatch (``batch.obs`` ``(D, n)``),
    ``params`` the pytree (:meth:`Layout.unflatten`).  Clipped surrogate,
    or the adaptive-KL penalty when ``cfg.kl_target`` is set.  Returns
    ``(total, metrics)``."""
    mean, log_std, value = networks.apply_t(params, batch.obs, compute_dtype)
    log_prob = networks.gaussian_log_prob_t(mean, log_std, batch.action)
    ratio = torch.exp(log_prob - batch.log_prob)
    if cfg.kl_target is not None:
        kl = torch.mean(batch.log_prob - log_prob)
        pg_loss = -torch.mean(ratio * advantages) + kl_beta * kl
    else:
        pg1 = ratio * advantages
        pg2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * advantages
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    v_clipped = batch.value + torch.clamp(value - batch.value, -cfg.value_clip_eps,
                                          cfg.value_clip_eps)
    v_loss = 0.5 * torch.mean(torch.maximum(torch.square(value - returns),
                                            torch.square(v_clipped - returns)))
    ent = networks.entropy(log_std)
    total = pg_loss + cfg.value_coef * v_loss - cfg.entropy_coef * ent
    metrics = {
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": ent,
        "approx_kl": torch.mean(batch.log_prob - log_prob),
        "clip_frac": torch.mean(((ratio - 1.0).abs() > cfg.clip_eps).to(ratio.dtype)),
    }
    return total, metrics


def shuffle_draws(generator: torch.Generator, n: int):
    """The five integers ``(a1, b1, a2, b2, m)`` of the shuffle bijection
    of ``[0, n)``, from the ranges the JAX package draws them from (``a1``
    and ``a2`` odd in ``[1, n)``, the others in ``[0, n)``)."""

    def draw(hi):
        return int(torch.randint(0, hi, (1,), generator=generator))

    return draw(n // 2) * 2 + 1, draw(n), draw(n // 2) * 2 + 1, draw(n), draw(n)


def shuffle_from_draws(n: int, draws, device=None) -> torch.Tensor:
    """The composed mul-odd / add / xor bijection mod ``n`` (a power of two)
    given its five integers: ``((i*a1 + b1) & mask) ^ m``, then ``(j*a2 +
    b2) & mask``.  Exact in int64, since ``i``, ``a`` < 2**31."""
    a1, b1, a2, b2, m = (int(v) for v in draws)
    mask = n - 1
    i = torch.arange(n, dtype=torch.int64, device=device)
    j = ((i * a1 + b1) & mask) ^ m
    return (j * a2 + b2) & mask


def _shuffle_indices(generator: torch.Generator, n: int, device=None) -> torch.Tensor:
    """A random permutation of ``[0, n)``: the bijection for a power of two
    ``n > 1``, else ``torch.randperm``."""
    if n > 1 and n & (n - 1) == 0:
        return shuffle_from_draws(n, shuffle_draws(generator, n), device)
    return torch.randperm(n, generator=generator).to(device)


def _tiling(cfg: PpoConfig, n: int):
    """The shuffle tile, halved until it divides the batch into the
    minibatches and each minibatch draws from >= 64 tiles (the JAX
    package's rule); returns ``(tile, n_tiles)``."""
    tile = max(1, cfg.shuffle_tile)
    while tile > 1 and (n % (cfg.num_minibatches * tile) != 0
                        or n // tile < 64 * cfg.num_minibatches):
        tile //= 2
    return tile, n // tile


def _rollout_kernel_name(env: EnvDef) -> str:
    return {"quadrotor3d-v0": "K2", "MujocoQuadForce-v1": "K6-hover"}.get(env.name, "K6")


def kind_refusal(env: EnvDef, what: str = "fused PPO rollout kernel"):
    """Why the policy-driven kernels on the env kinds of
    ``ops/ppo_rollout.py::ENVS`` (K2, K6-hover, K7) cannot run ``env``
    (None = they can): a kind of the table with its dims, the registry's
    functions and Params type (the live values are kernel arguments), and
    hover's two substeps.  ``what`` names the kernel in the reason."""
    kind = rollout_ops.ENVS.get(env.name)
    if kind is None:
        return f"no {what} for {env.name} (built for {sorted(rollout_ops.ENVS)})"
    if (env.obs_dim, env.action_dim) != (kind.state_dim, kind.action_dim):
        return (f"obs/action dims ({env.obs_dim}, {env.action_dim}), the kernel's are "
                f"({kind.state_dim}, {kind.action_dim})")
    reason = fused_kernel_mismatch(env, require_control=False, packed_params=True)
    if reason is None and env.name == "MujocoQuadForce-v1" and env.params.frame_skip != 2:
        return "frame_skip != 2 (the kernel runs two substeps)"
    return reason


def _rollout_refusal(cfg: PpoConfig, env: EnvDef):
    """Why the fused PPO rollout kernel (K2, K6-hover) cannot run this
    config and env (None = it can)."""
    if env.name in rollout_ops.ENVS and tuple(cfg.hidden) != rollout_ops.HIDDEN:
        return f"hidden {tuple(cfg.hidden)} != {rollout_ops.HIDDEN}"
    return kind_refusal(env)


def _loss_refusal(cfg: PpoConfig, env: EnvDef, device: torch.device):
    """Why K3 cannot run this config and env on ``device`` (None = it can):
    its plain twin takes any two equal hidden layers; the kernel, on a
    CUDA device, only the (obs, action) dims and widths it is built for
    (:data:`reinmav_tpu_torch.ops.ppo_loss.KERNEL_DIMS`)."""
    if len(cfg.hidden) != 2 or cfg.hidden[0] != cfg.hidden[1]:
        return f"hidden {tuple(cfg.hidden)} is not two equal layers"
    if device.type == "cuda":
        return loss_ops.kernel_dims_refusal(env.obs_dim, env.action_dim, cfg.hidden)
    return None


def _update_refusal(cfg: PpoConfig, env: EnvDef, fused_loss, device: torch.device):
    """Why K4 cannot run this config and env on ``device`` (None = it can):
    K3's preconditions, and the loss path not switched off (``fused_loss``
    the caller's True/False/None), as the JAX package requires
    ``fused_loss`` for its ``fused_update``."""
    if fused_loss is False or (fused_loss is None and cfg.fused_loss == "off"):
        return "fused_loss is off"
    return _loss_refusal(cfg, env, device)


def _choose(name: str, forced, mode: str, refusal, device: torch.device):
    """(use the kernel path, how to log it) for one of K2/K3/K4.  ``forced``:
    the caller's True/False/None; ``mode``: the config's "auto"/"on"/"off".
    "on" or True takes the kernel's wrapper (the plain twin on the CPU) and
    raises where it cannot; "auto" takes it on a CUDA device only."""
    if forced is None:
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"{name}={mode!r}: expected 'auto', 'on' or 'off'")
        forced = {"on": True, "off": False}.get(mode)
    if forced is False:
        return False, f"off ({name} disabled)"
    if refusal is not None:
        if forced:
            raise ValueError(f"{name} refused: {refusal}")
        return False, f"off ({refusal})"
    if device.type == "cuda":
        return True, "CUDA kernel"
    if forced:
        return True, f"plain twin (tensors on {device})"
    return False, f"off (tensors on {device}, the kernel needs a CUDA device)"


def pass_adv_stats(flat_adv, perm_all, tile: int, n_passes: int, normalize: bool):
    """Each pass's advantage ``[shift, inv_scale]`` as K4 takes it, ``(n_passes,
    2)`` float32: the mean and ``1 / (std + 1e-8)`` of the raw advantages
    of the minibatch (pass ``p`` reads the ``p``-th slice of ``perm_all``),
    from one batched gather on the device; ``[0, 1]`` when ``normalize``
    is off."""
    if not normalize:
        return torch.tensor([[0.0, 1.0]], device=flat_adv.device).repeat(n_passes, 1)
    adv_mb = flat_adv.reshape(-1, tile)[perm_all.reshape(n_passes, -1).long()]
    return torch.stack([adv_mb.mean(dim=(1, 2)),
                        1.0 / (adv_mb.std(dim=(1, 2), unbiased=False) + 1e-8)],
                       dim=1).to(torch.float32).contiguous()


def _reduce_rollout(axis: Mesh, rollout: Rollout) -> Rollout:
    """The rollout's moment sums added over the ranks and its mean raw
    reward averaged, in one all-reduce (the JAX package's ``psum`` of the
    moments and ``pmean`` of the reward)."""
    om, rm = rollout.obs_moments, rollout.ret_moments
    d = om.total.shape[0]
    vec = torch.cat([om.total, om.total_sq, *(x.reshape(1).to(om.total.dtype) for x in (
        om.count, rm.total, rm.total_sq, rm.count, rollout.raw_reward_mean))])
    vec = axis.all_reduce_sum(vec)
    cut = lambda i, like: vec[i].to(like.dtype)  # noqa: E731
    return rollout._replace(
        obs_moments=RawObsMoments(vec[:d].to(om.total.dtype), vec[d:2 * d].to(om.total.dtype),
                                  cut(2 * d, om.count)),
        ret_moments=RawObsMoments(cut(2 * d + 1, rm.total), cut(2 * d + 2, rm.total_sq),
                                  cut(2 * d + 3, rm.count)),
        raw_reward_mean=(vec[2 * d + 4] / axis.world_size).to(rollout.raw_reward_mean.dtype))


def update_phase(env: EnvDef, cfg: PpoConfig, state: TrainState, rollout: Rollout, perms,
                 fused_loss: bool, fused_update: bool = False, axis: Mesh | None = None):
    """The update after a rollout: GAE, then ``len(perms)`` epochs of
    ``cfg.num_minibatches`` minibatches of clip + Adam, the normaliser
    updates and the adaptive-KL coefficient.  ``perms``: one permutation
    of the shuffle tiles per epoch.  ``fused_update``: every pass in one
    call of K4 (:func:`reinmav_tpu_torch.ops.ppo_update.ppo_update`, the
    kernel on the card, its twin on the CPU).  Else a loop over the
    minibatches, and ``fused_loss``: each minibatch's gradient through K3
    (:func:`reinmav_tpu_torch.ops.ppo_loss.ppo_loss_grads_gather`, the
    kernel on the card, its twin on the CPU), else through
    ``torch.autograd`` of :func:`ppo_loss`.  Returns ``(new state,
    summary)``; the summary's values are 0-d tensors on the device.

    ``axis``: the mesh of a shard_map update (the JAX package's
    ``axis_name``): ``rollout`` is this rank's, its moment sums are added
    over the ranks and its mean reward and done share averaged; each
    minibatch's gradient and metrics are averaged over the ranks in one
    all-reduce before the optimiser step, so the params stay bitwise
    replicated; advantages are normalised per rank.  K4 cannot run there
    (its passes never leave the launch)."""
    if axis is not None and fused_update:
        raise ValueError("fused_update (K4) under shard_map: each minibatch's gradient must be "
                         "all-reduced between its passes")
    if axis is not None:
        rollout = _reduce_rollout(axis, rollout)
    layout = Layout(env.obs_dim, env.action_dim, cfg.hidden)
    traj = rollout.traj
    T, d, batch = traj.obs.shape
    adim = traj.action.shape[1]
    n = T * batch

    last_obs_t = rollout.final_states.T[:env.obs_dim]
    last_norm = _normalize_t(last_obs_t, state.obs_norm) if cfg.normalize_obs else last_obs_t
    with torch.no_grad(), record_function("ppo.gae"):
        _, _, last_value = networks.apply_t(layout.unflatten(state.params), last_norm,
                                            cfg.compute_dtype)
        advantages, returns = compute_gae(cfg, traj, last_value)

    # Flatten to the transposed sample axis, sample t * B + b.
    def flat_d(x):  # (T, D, B) -> (D, n)
        return x.permute(1, 0, 2).reshape(x.shape[1], n)

    flat = Transition(flat_d(traj.obs), flat_d(traj.action), traj.log_prob.reshape(n),
                      traj.value.reshape(n), traj.reward.reshape(n), traj.done.reshape(n))
    flat_adv, flat_ret = advantages.reshape(n), returns.reshape(n)
    tile, n_tiles = _tiling(cfg, n)
    for perm in perms:
        if perm.shape != (n_tiles,):
            raise ValueError(f"a permutation of the {n_tiles} tiles expected, got "
                             f"{tuple(perm.shape)}")
    if fused_loss or fused_update:
        data_full = loss_ops.stack_batch(flat.obs, flat.action, flat.log_prob, flat.value,
                                         flat_adv, flat_ret)
    kl_mode = cfg.kl_target is not None
    zero = torch.zeros((), dtype=torch.float32, device=state.params.device)
    beta = state.kl_beta.to(torch.float32) if kl_mode else zero
    ls_slice = layout.slices[("log_std",)]

    def loss_grads(tidx, params):
        """One minibatch's loss gradient and metrics (0-d tensors)."""
        cols = loss_ops._gather_columns(tidx, tile)
        if fused_loss:
            if cfg.normalize_advantages:
                adv_mb = flat_adv[cols]
                adv_stats = torch.stack([adv_mb.mean(), 1.0 / (adv_mb.std(unbiased=False) + 1e-8),
                                         beta, zero]).to(torch.float32)
            else:
                adv_stats = torch.stack([zero, zero + 1.0, beta, zero])
            grads, metrics = loss_ops.ppo_loss_grads_gather(
                data_full, adv_stats, tidx.to(torch.int32), params.to(torch.float32),
                d=d, adim=adim, clip_eps=cfg.clip_eps, value_clip_eps=cfg.value_clip_eps,
                value_coef=cfg.value_coef, ent_coef=cfg.entropy_coef, tile=tile,
                kl_mode=kl_mode, hidden=cfg.hidden[0], compute_dtype=cfg.compute_dtype)
            return grads, {**metrics, "entropy": networks.entropy(params[ls_slice])}
        mb = Transition(flat.obs[:, cols], flat.action[:, cols], flat.log_prob[cols],
                        flat.value[cols], flat.reward[cols], flat.done[cols])
        adv = flat_adv[cols]
        if cfg.normalize_advantages:
            adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
        p = params.detach().requires_grad_(True)
        loss, metrics = ppo_loss(layout.unflatten(p), cfg, mb, adv, flat_ret[cols],
                                 cfg.compute_dtype, state.kl_beta)
        (grads,) = torch.autograd.grad(loss, p)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def fused(perms):
        """Every pass in one K4 call; the advantage moments of every
        minibatch of every epoch from one batched gather."""
        perm_all = torch.cat(list(perms)).to(torch.int32)
        adv_stats = pass_adv_stats(flat_adv, perm_all, tile, len(perms) * cfg.num_minibatches,
                                   cfg.normalize_advantages)
        out = update_ops.ppo_update(
            data_full, adv_stats, perm_all,
            state.params.to(torch.float32).contiguous(), state.opt_state, beta if kl_mode else None,
            d=d, adim=adim, tile=tile, n_minibatches=cfg.num_minibatches, n_epochs=len(perms),
            clip_eps=cfg.clip_eps, value_clip_eps=cfg.value_clip_eps, value_coef=cfg.value_coef,
            ent_coef=cfg.entropy_coef, lr=cfg.learning_rate, max_grad_norm=cfg.max_grad_norm,
            log_std_floor=cfg.log_std_floor, kl_mode=kl_mode, hidden=cfg.hidden[0],
            compute_dtype=cfg.compute_dtype)
        metrics = dict(out.metrics)
        measured = metrics.pop("approx_kl_last", None)
        return out.params, out.opt_state, metrics, measured

    def loop(perms):
        """A loop over the minibatches of each epoch: gradient, then clip +
        Adam and the floor; metrics stacked (epochs, minibatches)."""
        optimizer = make_optimizer(cfg)
        params, opt_state = state.params, state.opt_state
        epochs = []
        for perm in perms:
            minibatches = []
            for tidx in perm.reshape(cfg.num_minibatches, n_tiles // cfg.num_minibatches):
                with record_function("ppo.loss_grads"):
                    grads, metrics = loss_grads(tidx, params)
                if axis is not None:
                    with record_function("ppo.all_reduce"):
                        grads, metrics = _average_grads(axis, grads, metrics)
                with record_function("ppo.optimizer"):
                    params, opt_state = optimizer.update(grads, opt_state, params)
                    params = update_ops.floor_log_std(params, layout, cfg.log_std_floor)
                minibatches.append(metrics)
            epochs.append(minibatches)
        stacked = {k: torch.stack([torch.stack([m[k] for m in mbs]) for mbs in epochs])
                   for k in epochs[0][0]} if epochs else {}
        # The last epoch's KL (baselines ppo1), for the adaptive-KL rule.
        measured = stacked["approx_kl"][-1].mean() if stacked else None
        return params, opt_state, {k: v.mean() for k, v in stacked.items()}, measured

    if fused_update and perms:
        with record_function("ppo.update_k4"):
            params, opt_state, metrics, measured = fused(perms)
    else:
        params, opt_state, metrics, measured = loop(perms)

    obs_norm = (_update_obs_norm(state.obs_norm, rollout.obs_moments) if cfg.normalize_obs
                else state.obs_norm)
    ret_norm = (_update_ret_norm(state.ret_norm, rollout.ret_moments) if cfg.normalize_rewards
                else state.ret_norm)
    kl_beta = state.kl_beta
    if kl_mode and measured is not None:
        kl_beta = torch.where(measured > 1.5 * cfg.kl_target, kl_beta * 2.0,
                              torch.where(measured < cfg.kl_target / 1.5, kl_beta * 0.5, kl_beta))
        kl_beta = torch.clamp(kl_beta, 1e-4, 64.0)
    new_state = state._replace(params=params, opt_state=opt_state,
                               env_states=rollout.final_states, obs_norm=obs_norm,
                               ret_norm=ret_norm, env_returns=rollout.env_returns,
                               update_step=state.update_step + 1, kl_beta=kl_beta)
    done_frac = traj.done.to(torch.float32).mean()
    if axis is not None:
        done_frac = axis.all_reduce_mean(done_frac)
    summary = {"mean_reward": rollout.raw_reward_mean, "mean_episode_done_frac": done_frac,
               **metrics}
    return new_state, summary


def _average_grads(axis: Mesh, grads, metrics: dict):
    """A minibatch's gradient and metrics averaged over the ranks, in one
    all-reduce (the JAX package's ``pmean`` of both)."""
    names = list(metrics)
    vec = axis.all_reduce_mean(torch.cat([grads.reshape(-1), torch.stack(
        [metrics[k].reshape(()).to(grads.dtype) for k in names])]))
    n = grads.numel()
    return (vec[:n].reshape(grads.shape),
            {k: vec[n + i].to(metrics[k].dtype) for i, k in enumerate(names)})


def _paths(env: EnvDef, cfg: PpoConfig, state: TrainState, fused_rollout, fused_loss,
           fused_update, axis: Mesh | None = None, label: str = "train_step"):
    """Choose the rollout and update paths of one update and log them:
    ``(use K2/K6, use K3, use K4)``.  Under shard_map (``axis``) K4 is
    off: each minibatch's gradient is all-reduced between K3 and the
    optimiser step, and K4 runs every pass inside one launch."""
    check_compute_dtype(cfg)
    device = state.env_states.device
    use_k2, rollout_how = _choose("fused_rollout", fused_rollout, cfg.fused_rollout,
                                  _rollout_refusal(cfg, env), device)
    if axis is not None:
        if fused_update:
            raise ValueError("fused_update refused: under shard_map each minibatch's gradient is "
                             "all-reduced between its passes")
        use_k4, update_how = False, ("off under shard_map (each minibatch's gradient is "
                                     "all-reduced between K3 and the optimiser step; K4 keeps "
                                     "every pass inside one launch)")
    else:
        use_k4, update_how = _choose("fused_update", fused_update, cfg.fused_update,
                                     _update_refusal(cfg, env, fused_loss, device), device)
    passes = cfg.num_epochs * cfg.num_minibatches
    if use_k4:
        use_k3 = False
        update = f"K4 {update_how}, 1 launch for {passes} passes of loss gradient + clip + Adam"
    else:
        use_k3, loss_how = _choose("fused_loss", fused_loss, cfg.fused_loss,
                                   _loss_refusal(cfg, env, device), device)
        update = (f"K4 {update_how}; {passes} minibatch steps of clip + Adam, loss gradient "
                  + (f"K3 {loss_how}, {passes} launches" if use_k3 else f"autograd, K3 {loss_how}"))
    if axis is not None:
        update += f"; {passes} gradient all-reduces over {axis.world_size} ranks"
    k2 = _rollout_kernel_name(env)
    log.info("%s(%s, B=%d, T=%d, %s): rollout: %s; update: %s", label, env.name,
             state.env_states.shape[0], cfg.rollout_len, cfg.compute_dtype,
             f"{k2} {rollout_how}" if use_k2 else f"eager loop, {k2} {rollout_how}", update)
    return use_k2, use_k3, use_k4


def _rollout(env: EnvDef, cfg: PpoConfig, state: TrainState, use_k2: bool, seed: int,
             env_base: int = 0, global_batch: int | None = None) -> Rollout:
    """The rollout of ``state``'s envs keyed by ``seed``: K2/K6, or the
    eager loop with a device generator seeded with it."""
    with record_function("ppo.rollout"):
        if use_k2:
            return collect_rollout_kernel(env, cfg, state.params, state.obs_norm, state.ret_norm,
                                          state.env_states, state.env_returns, seed, env_base)
        return collect_rollout(env, cfg, state.params, state.obs_norm, state.ret_norm,
                               state.env_states, state.env_returns,
                               _device_generator(seed, state.env_states.device), env_base,
                               global_batch)


def _perms(cfg: PpoConfig, state: TrainState, batch: int):
    """Each epoch's permutation of the shuffle tiles of ``batch`` envs,
    from ``state.generator`` (replicated: every rank draws the same)."""
    with record_function("ppo.shuffle"):
        _, n_tiles = _tiling(cfg, cfg.rollout_len * batch)
        return [_shuffle_indices(state.generator, n_tiles, state.env_states.device)
                for _ in range(cfg.num_epochs)]


def train_step(env: EnvDef, cfg: PpoConfig, state: TrainState, fused_rollout: bool | None = None,
               fused_loss: bool | None = None, fused_update: bool | None = None,
               axis: Mesh | None = None):
    """One PPO update: the rollout (K2 / K6-hover or the eager loop), then
    :func:`update_phase` (every pass in one K4 launch, or a loop over the
    minibatches with each gradient through K3 or autograd).

    ``fused_rollout`` / ``fused_loss`` / ``fused_update``: None follows
    ``cfg.fused_rollout`` / ``cfg.fused_loss`` / ``cfg.fused_update``
    ("auto" takes the CUDA kernel where the states lie on the card and the
    config is supported, "on" the kernel's wrapper, which runs its plain
    twin on the CPU, "off" the eager path or the loop); True / False
    force.  K4 needs K3's preconditions and a loss path that is not
    switched off.  Logs which paths ran and why, and the compute dtype.

    ``axis``: the mesh of a shard_map step (:func:`make_train_step_shardmap`,
    the JAX package's ``axis_name``): ``state`` holds this rank's envs, the
    rollout seed is folded with the rank, the permutations come from the
    replicated generator, and :func:`update_phase` averages over the ranks;
    K4 is off."""
    use_k2, use_k3, use_k4 = _paths(env, cfg, state, fused_rollout, fused_loss, fused_update,
                                    axis)
    seed = _draw_seed(state.generator)
    if axis is not None:
        seed = fold_in(seed, axis.rank)
    rollout = _rollout(env, cfg, state, use_k2, seed)
    perms = _perms(cfg, state, state.env_states.shape[0])
    return update_phase(env, cfg, state, rollout, perms, use_k3, use_k4, axis)


def mesh_train_step(env: EnvDef, cfg: PpoConfig, state: TrainState, mesh: Mesh,
                    fused_rollout: bool | None = None, fused_loss: bool | None = None,
                    fused_update: bool | None = None):
    """One PPO update of the mesh mode (the JAX package's
    ``make_train_step(env, cfg, mesh)``): the one-rank update on a batch
    split over the ranks.  ``state`` holds this rank's envs (rank ``r`` the
    envs ``r * B_local`` onwards); every rank draws the same seed, and its
    rollout (K2/K6 with ``env_base``, or the eager loop cutting the whole
    batch's draws) gives its envs what they get in the one-rank run.  The
    trajectory and the final states are gathered, the moment sums added,
    and every rank runs the same whole update on the whole batch, K4
    included.  Returns this rank's new state (its envs) and the summary."""
    use_k2, use_k3, use_k4 = _paths(env, cfg, state, fused_rollout, fused_loss, fused_update,
                                    label=f"mesh_train_step[rank {mesh.rank} of "
                                          f"{mesh.world_size}]")
    b_local = state.env_states.shape[0]
    global_batch = b_local * mesh.world_size
    seed = _draw_seed(state.generator)
    local = _rollout(env, cfg, state, use_k2, seed, mesh.rank * b_local, global_batch)
    with record_function("ppo.gather"):
        final_states, traj = _gather_rollout(mesh, local)
        rollout = _reduce_rollout(mesh, local)._replace(final_states=final_states, traj=traj)
    perms = _perms(cfg, state, global_batch)
    new_state, summary = update_phase(env, cfg, state, rollout, perms, use_k3, use_k4)
    return new_state._replace(env_states=local.final_states), summary


def _gather_rollout(mesh: Mesh, local: Rollout):
    """The ranks' final states ``(B, D)`` and trajectories ``(T, *, B)``
    in rank order (env order), in one gather: every field packed as rows
    of one ``(rows, B_local)`` tensor of the trajectory's dtype (``done``
    as 0 / 1, exact)."""
    traj = local.traj
    dtype = traj.value.dtype
    T, b = traj.value.shape
    fields = [local.final_states.T, *(x.reshape(-1, b) for x in traj)]
    rows = [f.shape[0] for f in fields]
    packed = mesh.all_gather(torch.cat([f.to(dtype) for f in fields]), dim=1)
    parts = packed.split(rows)
    out = [p.reshape((T, -1, packed.shape[1]) if x.dim() == 3 else (T, packed.shape[1]))
           .to(x.dtype) for p, x in zip(parts[1:], traj)]
    return parts[0].T.to(local.final_states.dtype), Transition(*out)


def _mean_summaries(summaries: list) -> dict:
    if not summaries:
        return {}
    return {k: torch.stack([s[k] for s in summaries]).mean() for k in summaries[0]}


def train_many(env: EnvDef, cfg: PpoConfig, state: TrainState, num_updates: int,
               fused_rollout: bool | None = None, fused_loss: bool | None = None,
               fused_update: bool | None = None, axis: Mesh | None = None,
               mesh: Mesh | None = None):
    """``num_updates`` :func:`train_step` calls in a plain loop (each a
    shard_map step with ``axis``, a :func:`mesh_train_step` with
    ``mesh``).  Returns the final state and the per-update metrics
    averaged over the updates (0-d tensors on the device)."""
    kw = dict(fused_rollout=fused_rollout, fused_loss=fused_loss, fused_update=fused_update)
    summaries = []
    for _ in range(num_updates):
        if mesh is not None:
            state, summary = mesh_train_step(env, cfg, state, mesh, **kw)
        else:
            state, summary = train_step(env, cfg, state, axis=axis, **kw)
        summaries.append(summary)
    return state, _mean_summaries(summaries)


def _check_divides(cfg: PpoConfig, mesh: Mesh) -> None:
    if cfg.num_envs % mesh.world_size != 0:
        raise ValueError(f"num_envs {cfg.num_envs} not divisible by mesh size {mesh.world_size}")


def make_train_step(env: EnvDef, cfg: PpoConfig, mesh: Mesh | None = None):
    """``step(state) -> (state, summary)``: :func:`train_step`, or with a
    mesh :func:`mesh_train_step` (the one-rank update on a batch split
    over the ranks).  ``cfg.num_envs`` is the global batch; the state is
    the rank's shard (:func:`reinmav_tpu_torch.parallel.shard_state`)."""
    if mesh is None:
        return lambda state: train_step(env, cfg, state)
    _check_divides(cfg, mesh)
    return lambda state: mesh_train_step(env, cfg, state, mesh)


def make_train_many(env: EnvDef, cfg: PpoConfig, num_updates: int, mesh: Mesh | None = None):
    """``num_updates`` steps of :func:`make_train_step` a call, the metrics
    averaged over them."""
    if mesh is not None:
        _check_divides(cfg, mesh)
    return lambda state: train_many(env, cfg, state, num_updates, mesh=mesh)


def make_train_step_shardmap(env: EnvDef, cfg: PpoConfig, mesh: Mesh):
    """The shard_map step, the fast mesh path: the MPI data-parallel recipe
    (baselines PPO2 under mpirun).  Each rank rolls out its shard with its
    own stream, draws the same permutations, normalises advantages on its
    own minibatches, and all-reduces each minibatch's gradient, the moment
    sums and the metrics: not bitwise a one-rank run, but the same
    algorithm at N times the batch.  ``cfg.num_envs`` (the global batch)
    must divide by the world size."""
    _check_divides(cfg, mesh)
    return lambda state: train_step(env, cfg, state, axis=mesh)


def make_train_many_shardmap(env: EnvDef, cfg: PpoConfig, num_updates: int, mesh: Mesh):
    """``num_updates`` shard_map steps a call, the metrics averaged."""
    _check_divides(cfg, mesh)
    return lambda state: train_many(env, cfg, state, num_updates, axis=mesh)
