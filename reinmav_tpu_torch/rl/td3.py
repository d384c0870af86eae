"""TD3 and DDPG learners of the PyTorch port.

The counterpart of :mod:`reinmav_tpu.rl.td3`, on the machinery of
:mod:`.sac` (the feature-major replay ring, the flat parameter vectors,
the collection through K7 or eagerly, the gated Adam step): a
deterministic tanh actor with clipped Gaussian exploration noise at
collection, target policy smoothing, twin critics with min-clipping, and
delayed policy updates (the actor, its optimiser and every target move
on each ``policy_delay``-th gate-open critic update).

Classic DDPG is ``single_critic=True`` with ``policy_noise=0``,
``noise_clip=0`` and ``policy_delay=1`` (the CLI's ``--alg=ddpg``): the
critic vector then holds ``q1`` alone, so DDPG has no ``q2`` entry in its
params, optimiser state or checkpoint.

Sharded over ranks (``axis``; :func:`make_train_iters` with a mesh) as
:mod:`.sac` is: rank-local envs, rings and streams, the critic and actor
gradients averaged over the ranks before their gated steps.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..envs.core import EnvDef
from ..parallel.mesh import Mesh
from ..utils.metrics import to_host
from . import sac
from .ppo import (AdamState, ClipAdam, _device_generator, _draw_seed, adam_from_jax,
                  check_compute_dtype)
from .sac import (MlpLayout, actor_layout, average_grads, buffer_insert, buffer_sample, collect,
                  critic_layout, finish_metrics, gated_step, init_mlp, iteration_metrics,
                  iteration_seeds, mlp_t, polyak, q_value_t, resolve_sample_tile,
                  scale_action_t, sharding, split_rows, twin_q_value_t)

log = logging.getLogger(__name__)


class Td3Config(NamedTuple):
    """The JAX package's ``Td3Config``: the same fields and defaults (see
    there and :class:`.sac.SacConfig` for each)."""

    num_envs: int = 256
    buffer_capacity: int = 1 << 20
    batch_size: int = 2048
    learning_rate: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    hidden: tuple = (256, 256)
    grad_steps: int = 1
    warmup_steps: int = 10_000
    reward_scale: float = 1.0
    max_grad_norm: float | None = None
    explore_noise: float = 0.1
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    policy_delay: int = 2
    fused_collect: str = "auto"
    sample_tile: int | str = "auto"
    single_critic: bool = False
    compute_dtype: str = "float32"


class Td3State(NamedTuple):
    actor: torch.Tensor           # flat, actor_layout (head A)
    actor_target: torch.Tensor
    critics: torch.Tensor         # flat [q1 | q2], or [q1] with single_critic
    critics_target: torch.Tensor
    opt_actor: AdamState
    opt_q: AdamState
    buffer: torch.Tensor          # (R, C) float32 ring (see .sac)
    ptr: torch.Tensor
    filled: torch.Tensor
    env_states: torch.Tensor      # (B, D)
    generator: torch.Generator    # CPU; host draws only
    total_steps: torch.Tensor
    updates: torch.Tensor         # 0-d int64 gate-open critic-update counter
    ever_done: torch.Tensor


def actor_action_t(actor, obs_t, compute_dtype=None):
    """Deterministic policy: tanh(MLP(obs)) in [-1, 1], ``(A, batch)``."""
    return torch.tanh(mlp_t(actor, obs_t, compute_dtype))


def layouts(env: EnvDef, cfg: Td3Config):
    """``(actor, critics)`` layouts; the critics one copy under
    ``single_critic``."""
    return (actor_layout(env, cfg.hidden, env.action_dim),
            critic_layout(env, cfg.hidden, 1 if cfg.single_critic else 2))


def qdict(cfg: Td3Config, lq: MlpLayout, flat) -> dict:
    """The critics' layer lists by name: ``q2`` is absent (not None) under
    ``single_critic``."""
    out = {"q1": lq.layers(flat, 0)}
    if not cfg.single_critic:
        out["q2"] = lq.layers(flat, 1)
    return out


def make_optimizers(cfg: Td3Config):
    """optax's ``adam(lr)`` (after ``clip_by_global_norm`` when set) for the
    actor and for the critics."""
    return (ClipAdam(cfg.max_grad_norm, cfg.learning_rate, eps=sac.ADAM_EPS),
            ClipAdam(cfg.max_grad_norm, cfg.learning_rate, eps=sac.ADAM_EPS))


def init_state(env: EnvDef, cfg: Td3Config, seed: int = 0, device="cuda") -> Td3State:
    """Fresh params (orthogonal init), optimisers, ring and env states, on
    ``device`` (the card unless the caller asks for the CPU)."""
    check_compute_dtype(cfg)
    generator = torch.Generator().manual_seed(seed)
    la, lq = layouts(env, cfg)
    actor = init_mlp(la, generator).to(device)
    critics = init_mlp(lq, generator).to(device)
    opt_a, opt_q = make_optimizers(cfg)
    env_states = env.vreset(_device_generator(_draw_seed(generator), device), cfg.num_envs)
    buffer, ptr, filled = sac._ring(env, cfg, device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return Td3State(actor, actor.clone(), critics, critics.clone(), opt_a.init(actor),
                    opt_q.init(critics), buffer, ptr, filled, env_states, generator, zero,
                    zero.clone(), torch.zeros(cfg.num_envs, dtype=torch.float32, device=device))


def state_from_jax(env: EnvDef, cfg: Td3Config, jstate, seed: int = 0, device=None,
                   dtype=torch.float32) -> Td3State:
    """A JAX ``Td3State`` (leaves as NumPy or JAX arrays) -> the port's (see
    :func:`.sac.state_from_jax`); under ``single_critic`` the JAX state's
    ``q2`` slots are None and the critic vector holds ``q1`` alone."""
    la, lq = layouts(env, cfg)
    kw = dict(device=device, dtype=dtype)
    names = ("q1",) if cfg.single_critic else ("q1", "q2")
    q_flat = lambda tree: lq.flatten(*(tree[n] for n in names), dtype=dtype)  # noqa: E731
    pick = lambda *qs: qs[:lq.copies]  # noqa: E731
    t = sac._tensor
    return Td3State(
        la.flatten(jstate.actor, **kw), la.flatten(jstate.actor_target, **kw),
        lq.flatten(*pick(jstate.q1, jstate.q2), **kw),
        lq.flatten(*pick(jstate.q1_target, jstate.q2_target), **kw),
        adam_from_jax(jstate.opt_actor, lambda tr: la.flatten(tr, dtype=dtype), **kw),
        adam_from_jax(jstate.opt_q, q_flat, **kw),
        t(jstate.buffer, device, torch.float32), t(jstate.ptr, device, torch.int64),
        t(jstate.filled, device, torch.int64), t(jstate.env_states, device, dtype),
        torch.Generator().manual_seed(seed), t(jstate.total_steps, device, torch.int64),
        t(jstate.updates, device, torch.int64), t(jstate.ever_done, device, torch.float32))


def _critic_loss_noise(q_params, cfg: Td3Config, env: EnvDef, batch_rows, targets, noise,
                       actor_target, compute_dtype=None):
    """MSE of the critic(s) against the smoothed Bellman target, with the
    smoothing noise's standard normals given as ``noise`` ``(A, batch)``
    (the JAX package draws them inside ``critic_loss``): the target
    action is ``clip(tanh(actor_target) + clip(policy_noise * noise,
    +-noise_clip), -1, 1)``.  ``q_params`` / ``targets``: ``{"q1": layers[,
    "q2": layers]}``.  Returns ``(loss, (mean q1, mean target))``."""
    cd = compute_dtype
    obs, act, rew, nobs, done = split_rows(env, batch_rows)
    with torch.no_grad():
        na = actor_action_t(actor_target, nobs, cd)
        smooth = torch.clamp(cfg.policy_noise * noise, -cfg.noise_clip, cfg.noise_clip)
        na = torch.clamp(na + smooth, -1.0, 1.0)
        if cfg.single_critic:
            tq = q_value_t(targets["q1"], nobs, na, cd)
        else:
            tq = torch.minimum(*twin_q_value_t(targets["q1"], targets["q2"], nobs, na, cd))
        target = rew * cfg.reward_scale + cfg.gamma * (1.0 - done) * tq
    if cfg.single_critic:
        q1v = q_value_t(q_params["q1"], obs, act, cd)
        loss = torch.mean(torch.square(q1v - target))
    else:
        q1v, q2v = twin_q_value_t(q_params["q1"], q_params["q2"], obs, act, cd)
        loss = torch.mean(torch.square(q1v - target)) + torch.mean(torch.square(q2v - target))
    return loss, (torch.mean(q1v.detach()), torch.mean(target))


def critic_loss(q_params, cfg: Td3Config, env: EnvDef, batch_rows, targets, generator,
                actor_target, compute_dtype=None):
    """:func:`_critic_loss_noise` with the noise drawn from ``generator``."""
    noise = sac._randn(generator, (env.action_dim, batch_rows.shape[-1]), batch_rows)
    return _critic_loss_noise(q_params, cfg, env, batch_rows, targets, noise, actor_target,
                              compute_dtype)


def actor_loss(actor, env: EnvDef, batch_rows, q1, compute_dtype=None):
    """Deterministic policy gradient: minus the mean of ``q1`` along the
    actor's action."""
    obs = batch_rows[:env.obs_dim]
    return -torch.mean(q_value_t(q1, obs, actor_action_t(actor, obs, compute_dtype),
                                 compute_dtype))


class Draws(NamedTuple):
    """One update's draws: the replay uniforms (float32) and the target
    smoothing's standard normals ``(A, batch)``."""

    u: torch.Tensor
    noise: torch.Tensor


def draw_update(generator: torch.Generator, cfg: Td3Config, env: EnvDef, tile: int,
                like) -> Draws:
    u = torch.rand(cfg.batch_size // tile, generator=generator, device=like.device,
                   dtype=torch.float32)
    return Draws(u, sac._randn(generator, (env.action_dim, cfg.batch_size), like))


class Nets(NamedTuple):
    """What one TD3 update changes."""

    actor: torch.Tensor
    actor_target: torch.Tensor
    critics: torch.Tensor
    critics_target: torch.Tensor
    opt_actor: AdamState
    opt_q: AdamState
    updates: torch.Tensor


def update_step(env: EnvDef, cfg: Td3Config, nets: Nets, buffer, filled, ready, draws: Draws,
                tile: int = 1, axis: Mesh | None = None):
    """One TD3 update (the JAX package's ``one_update``): the critics' step
    with the gradient times the gate and the optimiser frozen while the
    gate is closed; the counter of gate-open updates; then, with ``slow =
    gate`` on every ``policy_delay``-th of them and 0 otherwise, the
    actor's step on the gradient times ``slow`` (its optimiser state kept
    unless ``slow``) and the polyak blend ``tau * slow`` of the actor and
    critic targets.  With ``axis`` each gradient is first averaged over the
    ranks.  Returns ``(nets, metrics)``."""
    la, lq = layouts(env, cfg)
    opt_a, opt_q = make_optimizers(cfg)
    dtype = nets.actor.dtype
    gate = ready.to(torch.float32)  # float32 as the JAX package's, tau * gate too
    with record_function("sac.sample"):
        rows = buffer_sample(buffer, torch.clamp(filled, min=1), draws.u, cfg.batch_size,
                             tile).to(dtype)
    with record_function("sac.update"):
        q = nets.critics.detach().requires_grad_(True)
        qloss, (q_mean, tgt_mean) = _critic_loss_noise(
            qdict(cfg, lq, q), cfg, env, rows, qdict(cfg, lq, nets.critics_target), draws.noise,
            la.layers(nets.actor_target), cfg.compute_dtype)
        (qg,) = torch.autograd.grad(qloss, q)
        qg = average_grads(axis, qg)
        critics, opt_q_state = gated_step(opt_q, qg * gate, nets.opt_q, nets.critics, ready)
        updates = nets.updates + ready.to(nets.updates.dtype)

        slow = gate * (updates % cfg.policy_delay == 0).to(torch.float32)
        a = nets.actor.detach().requires_grad_(True)
        ploss = actor_loss(la.layers(a), env, rows, lq.layers(critics, 0), cfg.compute_dtype)
        (ag,) = torch.autograd.grad(ploss, a)
        ag = average_grads(axis, ag)
        actor, opt_a_state = gated_step(opt_a, ag * slow, nets.opt_actor, nets.actor, slow > 0.5)
        with torch.no_grad():
            blend = cfg.tau * slow
            actor_target = polyak(nets.actor_target, actor, blend)
            critics_target = polyak(nets.critics_target, critics, blend)
    metrics = {"q_loss": qloss.detach(), "pi_loss": ploss.detach(), "q_mean": q_mean,
               "target_mean": tgt_mean}
    return Nets(actor, actor_target, critics, critics_target, opt_a_state, opt_q_state,
                updates), metrics


def train_iters(env: EnvDef, cfg: Td3Config, state: Td3State, num_iters: int,
                fused_collect=None, axis: Mesh | None = None):
    """Run ``num_iters`` TD3 (or DDPG) iterations: one batched env step
    (K7 in ``td3`` mode, or eagerly), the ring insert, ``cfg.grad_steps``
    updates.  Returns ``(state, metrics)`` as :func:`.sac.train_iters`
    does, reading the host once at the end.  Logs which collection ran and
    why, and the compute dtype.  ``axis``: sharded as
    :func:`.sac.train_iters`."""
    check_compute_dtype(cfg)
    device = state.env_states.device
    use_k7, how = sac.choose_collect(cfg, env, device, fused_collect)
    tile = resolve_sample_tile(cfg, state.env_states.shape[0])
    la, _ = layouts(env, cfg)
    alg = "ddpg" if cfg.single_critic else "td3"
    log.info("%s.train_iters(%s, B=%d, %d iterations, %s): collection: %s; %d updates per "
             "iteration through autograd%s", alg, env.name, state.env_states.shape[0], num_iters,
             cfg.compute_dtype,
             f"K7 {how}, 1 launch per iteration" if use_k7 else f"eager, K7 {how}",
             cfg.grad_steps, sharding(axis))
    tail = sac.consts_tail(env, cfg.explore_noise, device) if use_k7 else None
    per_iter = []
    for _ in range(num_iters):
        seed, gen = iteration_seeds(state.generator, device, axis)
        warm = state.total_steps < cfg.warmup_steps
        with record_function("sac.collect"), torch.no_grad():
            new_t, block, reward, done = collect(env, cfg, la.layers(state.actor),
                                                 state.env_states, warm, use_k7, "td3",
                                                 cfg.explore_noise, seed, gen, tail)
        with record_function("sac.insert"):
            buffer, ptr, filled = buffer_insert(state.buffer, state.ptr, state.filled, block)
        total = state.total_steps + cfg.num_envs
        ready = (filled >= cfg.batch_size) & (total >= cfg.warmup_steps)
        nets = Nets(state.actor, state.actor_target, state.critics, state.critics_target,
                    state.opt_actor, state.opt_q, state.updates)
        step_metrics = []
        for _ in range(cfg.grad_steps):
            nets, m = update_step(env, cfg, nets, buffer, filled, ready,
                                  draw_update(gen, cfg, env, tile, state.actor), tile, axis)
            step_metrics.append(m)
        ever_done = torch.maximum(state.ever_done, done.to(state.ever_done.dtype))
        per_iter.append(iteration_metrics(step_metrics, ready.to(torch.float32), reward,
                                          done, filled, ever_done, axis))
        state = Td3State(nets.actor, nets.actor_target, nets.critics, nets.critics_target,
                         nets.opt_actor, nets.opt_q, buffer, ptr, filled, new_t.T,
                         state.generator, total, nets.updates, ever_done)
    return state, (to_host(finish_metrics(per_iter)) if per_iter else {})


def make_train_iters(env: EnvDef, cfg: Td3Config, num_iters: int, mesh: Mesh | None = None):
    """``run(state) -> (state, metrics)``: ``num_iters`` iterations of
    :func:`train_iters`, sharded over ``mesh`` when given (see
    :func:`.sac.make_train_iters`)."""
    if mesh is not None:
        sac.check_divides(cfg, mesh)
    return lambda state: train_iters(env, cfg, state, num_iters, axis=mesh)


@torch.no_grad()
def greedy_action(env: EnvDef, actor, obs, hidden):
    """Deterministic (noise-free) action for evaluation, row layout:
    ``actor`` the flat vector of widths ``hidden``, ``obs`` ``(B, D)`` or
    ``(D,)``."""
    layers = actor_layout(env, hidden, env.action_dim).layers(actor)
    obs_t = obs.T if obs.dim() == 2 else obs[:, None]
    scaled = scale_action_t(env, actor_action_t(layers, obs_t.to(actor.dtype)))
    return scaled.T if obs.dim() == 2 else scaled[:, 0]
