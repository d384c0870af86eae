"""Recurrent (GRU) PPO of the PyTorch port.

The counterpart of :mod:`reinmav_tpu.rl.recurrent` (``--network=gru`` in
the CLI): a GRU actor-critic trained with the clipped surrogate, GAE and
an entropy bonus, with the JAX module's layouts and order of operations:

* feature-major everywhere: the GRU state is ``(H, B)``, the trajectory
  ``(T, D, B)`` and ``(T, B)``;
* collection is a loop over the horizon carrying ``(env_state, h)``; the
  hidden is zeroed on episode boundaries (``h <- h * (1 - done_prev)``);
* the learner keeps the rollout's initial hidden per env, minibatches over
  the ENV axis (sequences stay whole) and recomputes the forward pass
  through the stored trajectory with the same done masking (truncated BPTT
  over the window).

Training masks the hidden on ``done`` only, not on truncation, as the JAX
module does; the CLI's play loop masks on either (``rl/run.py``).

Like the JAX module this is no throughput path: there is no fused kernel,
every step is a few eager PyTorch operations (launch-bound on the card).
The parameters are ONE flat vector in :class:`GruLayout` order (the JAX
pytree's leaves in ``jax.tree.leaves`` order), so that the optimiser
(:class:`reinmav_tpu_torch.rl.ppo.ClipAdam`, with optax ``adam``'s eps of
1e-8) updates one tensor and the checkpoint takes the state as it is.
Randomness: ``RecurrentTrainState.generator`` is a CPU generator; each
update draws from it one seed for a generator on the state's device (the
action noise and the reset draws) and the epochs' permutations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..envs.core import EnvDef
from . import networks
from .ppo import AdamState, ClipAdam, _draw_seed, adam_from_jax

#: The action log-density, action axis leading (the JAX module's ``_logp_t``).
_logp_t = networks.gaussian_log_prob_t


class RecurrentPpoConfig(NamedTuple):
    """The JAX package's ``RecurrentPpoConfig``: the same fields and
    defaults."""

    num_envs: int = 256
    rollout_len: int = 64
    hidden: int = 64          # GRU state size
    embed: int = 64           # obs embedding width (tanh dense)
    learning_rate: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    epochs: int = 4
    num_minibatches: int = 4  # over the ENV axis (sequences stay whole)
    vf_coef: float = 0.5
    entropy_coef: float = 0.0
    max_grad_norm: float = 0.5
    init_log_std: float = 0.0


class RecurrentTrainState(NamedTuple):
    params: torch.Tensor        # flat, GruLayout order
    opt_state: AdamState
    env_states: torch.Tensor    # (B, state_dim)
    h: torch.Tensor             # (H, B) GRU state
    prev_done: torch.Tensor     # (B,) masks h at the next step
    generator: torch.Generator  # CPU; host draws only
    update_step: int


class RecurrentTraj(NamedTuple):
    obs: torch.Tensor        # (T, D, B)
    action: torch.Tensor     # (T, A, B)
    log_prob: torch.Tensor   # (T, B)
    value: torch.Tensor      # (T, B)
    reward: torch.Tensor     # (T, B)
    done: torch.Tensor       # (T, B) done AFTER this step
    done_prev: torch.Tensor  # (T, B) boundary BEFORE this step


class GruLayout:
    """Where each leaf of the JAX params pytree lies in the flat vector:
    ``entries`` lists ``(path, shape)`` in ``jax.tree.leaves`` order (dict
    keys sorted), ``w`` as ``(in, out)``."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: int, embed: int):
        self.obs_dim, self.action_dim, self.hidden, self.embed = obs_dim, action_dim, hidden, embed
        h3 = 3 * hidden
        self.entries = [
            (("embed", "b"), (embed,)), (("embed", "w"), (obs_dim, embed)),
            (("gru", "bh"), (h3,)), (("gru", "bi"), (h3,)),
            (("gru", "wh"), (hidden, h3)), (("gru", "wi"), (embed, h3)),
            (("log_std",), (action_dim,)),
            (("pi_out", "b"), (action_dim,)), (("pi_out", "w"), (hidden, action_dim)),
            (("vf_out", "b"), (1,)), (("vf_out", "w"), (hidden, 1)),
        ]
        self.slices, off = {}, 0
        for path, shape in self.entries:
            size = math.prod(shape)
            self.slices[path] = slice(off, off + size)
            off += size
        self.size = off

    @classmethod
    def of(cls, env: EnvDef, cfg: RecurrentPpoConfig) -> "GruLayout":
        return cls(env.obs_dim, env.action_dim, cfg.hidden, cfg.embed)

    @classmethod
    def of_tree(cls, tree) -> "GruLayout":
        """The layout of a params pytree (JAX's or :meth:`unflatten`'s)."""
        obs_dim, embed = tree["embed"]["w"].shape
        return cls(obs_dim, tree["log_std"].shape[0], tree["gru"]["wh"].shape[0], embed)

    def unflatten(self, flat: torch.Tensor) -> dict:
        """The params pytree as views of ``flat`` (gradients flow through)."""
        if flat.shape != (self.size,):
            raise ValueError(f"flat params must be ({self.size},), got {tuple(flat.shape)}")
        tree = {"embed": {}, "gru": {}, "pi_out": {}, "vf_out": {}}
        for path, shape in self.entries:
            leaf = flat[self.slices[path]].view(shape)
            if len(path) == 1:
                tree[path[0]] = leaf
            else:
                tree[path[0]][path[1]] = leaf
        return tree

    def flatten(self, tree, device=None, dtype=torch.float32) -> torch.Tensor:
        """A params pytree (leaves as NumPy arrays or tensors) -> the flat
        vector.  Raises ``ValueError`` on a leaf of the wrong shape."""
        leaves = []
        for path, shape in self.entries:
            node = tree
            for key in path:
                node = node[key]
            leaf = node if isinstance(node, torch.Tensor) else torch.from_numpy(np.array(node))
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf {path} has shape {tuple(leaf.shape)}, expected {shape}")
            leaves.append(leaf.reshape(-1).to(device=device, dtype=dtype))
        return torch.cat(leaves)


def params_from_jax(tree, device=None, dtype=torch.float32) -> torch.Tensor:
    """The JAX module's params pytree (NumPy or JAX arrays) -> the port's
    flat parameter vector."""
    return GruLayout.of_tree(tree).flatten(tree, device=device, dtype=dtype)


def adam_state_from_jax(opt_state, device=None, dtype=torch.float32) -> AdamState:
    """optax's state of ``chain(clip_by_global_norm, adam)`` over the GRU
    params (leaves as NumPy or JAX arrays) -> the port's
    :class:`~reinmav_tpu_torch.rl.ppo.AdamState`."""
    return adam_from_jax(opt_state, lambda t: params_from_jax(t, dtype=dtype), device, dtype)


#: Orthogonal-init gains of the weight leaves (the JAX module's init_params).
_GAINS = {("embed", "w"): math.sqrt(2.0), ("gru", "wi"): 1.0, ("gru", "wh"): 1.0,
          ("pi_out", "w"): 0.01, ("vf_out", "w"): 1.0}


def init_params(layout: GruLayout, generator: torch.Generator, init_log_std: float = 0.0,
                dtype=torch.float32) -> torch.Tensor:
    """Orthogonal weights at the JAX module's gains (sqrt 2 on the
    embedding, 1 on both GRU matrices and the value head, 0.01 on the
    policy head), zero biases, ``log_std = init_log_std``; drawn on the
    generator's device (the streams differ from JAX's)."""
    flat = torch.zeros(layout.size, dtype=dtype, device=generator.device)
    for path, shape in layout.entries:
        if path in _GAINS:
            w = torch.empty(shape, dtype=dtype, device=generator.device)
            nn.init.orthogonal_(w, gain=_GAINS[path], generator=generator)
            flat[layout.slices[path]] = w.reshape(-1)
    flat[layout.slices[("log_std",)]] = init_log_std
    return flat


def _dot_t(w, x_t):
    """(din, dout)^T (..., din, B) -> (..., dout, B)."""
    return w.T @ x_t


def _gru_recur(g, h, gi):
    """The GRU's recurrent half, given the input projection ``gi`` (3H, B):
    r and z gates sigmoid, the candidate n takes the reset-gated recurrent
    term, h' = (1 - z) n + z h."""
    hd = h.shape[0]
    gh = _dot_t(g["wh"], h) + g["bh"][:, None]
    rz = torch.sigmoid(gi[:2 * hd] + gh[:2 * hd])  # both gates in one launch
    r, z = rz[:hd], rz[hd:]
    n = torch.tanh(gi[2 * hd:] + r * gh[2 * hd:])
    return (1.0 - z) * n + z * h


def gru_cell(params, h, x_t):
    """One GRU step in the transposed layout: ``h`` (H, B), ``x_t`` (E, B)."""
    g = params["gru"]
    return _gru_recur(g, h, _dot_t(g["wi"], x_t) + g["bi"][:, None])


def policy_step(params, h, obs_t, done_prev):
    """One policy step: mask the carried hidden on episode boundaries,
    embed, recurse, heads.  Returns ``(h', mean_t, log_std, value)``."""
    h = h * (1.0 - done_prev)[None, :]
    e = torch.tanh(_dot_t(params["embed"]["w"], obs_t) + params["embed"]["b"][:, None])
    h = gru_cell(params, h, e)
    mean = _dot_t(params["pi_out"]["w"], h) + params["pi_out"]["b"][:, None]
    value = (_dot_t(params["vf_out"]["w"], h) + params["vf_out"]["b"][:, None])[0]
    return h, mean, params["log_std"], value


@torch.no_grad()
def collect(env: EnvDef, cfg: RecurrentPpoConfig, params, state: RecurrentTrainState,
            generator: torch.Generator, noise=None):
    """One rollout window from ``state`` with the params pytree ``params``.
    ``generator`` (on the states' device) draws the action noise and the
    resets; ``noise``, if given, is the ``(T, A, B)`` standard normals of
    the actions.  Returns ``((states_t, h, done_prev), traj)``."""
    d = env.obs_dim
    s_t, h, dprev = state.env_states.T, state.h, state.prev_done
    steps = []
    for t in range(cfg.rollout_len):
        obs_t = s_t[:d]
        h_new, mean, log_std, value = policy_step(params, h, obs_t, dprev)
        eps = (torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
               if noise is None else noise[t].to(mean))
        action = mean + torch.exp(log_std)[:, None] * eps
        logp = _logp_t(mean, log_std, action)
        out = env.autoreset_step_t(s_t, action, generator)
        done = out.done.to(dprev.dtype)
        steps.append(RecurrentTraj(obs_t, action, logp, value, out.reward, done, dprev))
        s_t, h, dprev = out.state, h_new, done
    traj = RecurrentTraj(*(torch.stack(field) for field in zip(*steps)))
    return (s_t, h, dprev), traj


def compute_gae(cfg: RecurrentPpoConfig, traj: RecurrentTraj, last_value):
    """GAE over the window, the terminal bootstrap masked by done; a
    reverse loop over T.  Returns ``(advantages, returns)``."""
    adv = torch.empty_like(traj.value)
    gae, next_value = torch.zeros_like(last_value), last_value
    for t in range(traj.value.shape[0] - 1, -1, -1):
        nd = 1.0 - traj.done[t]
        delta = traj.reward[t] + cfg.gamma * next_value * nd - traj.value[t]
        gae = delta + cfg.gamma * cfg.lam * nd * gae
        adv[t] = gae
        next_value = traj.value[t]
    return adv, adv + traj.value


def forward_window(params, h0, obs, done_prev):
    """:func:`policy_step` over a stored window, ``obs`` (T, D, B) and
    ``done_prev`` (T, B) from ``h0``: ``(means (T, A, B), values (T, B))``.
    What does not depend on the hidden (the embedding, the GRU's input
    projection, the heads) runs once over the window; only the recurrent
    half steps through time.  The same arithmetic as the steps, fewer
    launches."""
    g = params["gru"]
    e = torch.tanh(_dot_t(params["embed"]["w"], obs) + params["embed"]["b"][:, None])
    gi = _dot_t(g["wi"], e) + g["bi"][:, None]
    h, hs = h0, []
    for t in range(obs.shape[0]):
        h = _gru_recur(g, h * (1.0 - done_prev[t])[None, :], gi[t])
        hs.append(h)
    hs = torch.stack(hs)
    means = _dot_t(params["pi_out"]["w"], hs) + params["pi_out"]["b"][:, None]
    values = (_dot_t(params["vf_out"]["w"], hs) + params["vf_out"]["b"][:, None])[:, 0]
    return means, values


def _loss(params, cfg: RecurrentPpoConfig, mb, h0):
    """Clipped PPO loss on one env-axis minibatch ``mb = (obs, action,
    logp_old, adv, ret, done_prev)``, the forward recomputed through time
    with the stored boundary masking.  Returns ``(loss, (pg, v_loss,
    mean |ratio - 1|))``."""
    obs, action, logp_old, adv, ret, done_prev = mb
    means, values = forward_window(params, h0, obs, done_prev)
    # The action axis leading (the JAX module's vmap of _logp_t over time).
    logp = _logp_t(means.transpose(0, 1), params["log_std"], action.transpose(0, 1))

    ratio = torch.exp(logp - logp_old)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)  # population std, as jnp.std
    pg = -torch.minimum(ratio * adv_n,
                        torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv_n).mean()
    v_loss = 0.5 * torch.mean(torch.square(values - ret))
    entropy = torch.sum(params["log_std"] + 0.5 * math.log(2.0 * math.pi * math.e))
    loss = pg + cfg.vf_coef * v_loss - cfg.entropy_coef * entropy
    return loss, (pg, v_loss, torch.mean(torch.abs(ratio - 1.0)))


def minibatch_grads(layout: GruLayout, params, cfg: RecurrentPpoConfig, mb, h0):
    """The gradient of :func:`_loss` with respect to the flat ``params``
    (autograd through the recomputed forward), and the detached
    ``(loss, pg, v_loss, ratio_dev)``."""
    p = params.detach().requires_grad_(True)
    loss, aux = _loss(layout.unflatten(p), cfg, mb, h0)
    (grads,) = torch.autograd.grad(loss, p)
    return grads, tuple(x.detach() for x in (loss, *aux))


def make_optimizer(cfg: RecurrentPpoConfig) -> ClipAdam:
    """optax's ``chain(clip_by_global_norm(max_grad_norm), adam(lr))``:
    adam's default eps of 1e-8 (not PPO's 1e-5)."""
    return ClipAdam(cfg.max_grad_norm, cfg.learning_rate, eps=1e-8)


def init_train_state(env: EnvDef, cfg: RecurrentPpoConfig, seed: int = 0, device="cuda",
                     dtype=torch.float32) -> RecurrentTrainState:
    """Fresh params, optimiser, env states, a zero hidden; on ``device``
    (the card unless the caller asks for the CPU)."""
    generator = torch.Generator().manual_seed(seed)
    params = init_params(GruLayout.of(env, cfg), generator, cfg.init_log_std, dtype).to(device)
    env_gen = torch.Generator(device=device).manual_seed(_draw_seed(generator))
    env_states = env.vreset(env_gen, cfg.num_envs, dtype=dtype)
    kw = dict(dtype=dtype, device=device)
    return RecurrentTrainState(params, make_optimizer(cfg).init(params), env_states,
                               torch.zeros((cfg.hidden, cfg.num_envs), **kw),
                               torch.zeros(cfg.num_envs, **kw), generator, 0)


def train_step(env: EnvDef, cfg: RecurrentPpoConfig, state: RecurrentTrainState, noise=None,
               perms=None):
    """One PPO update: collect a window, GAE, ``cfg.epochs`` passes of
    env-axis minibatch steps with whole sequences.  ``noise`` (the
    ``(T, A, B)`` action normals) and ``perms`` (one permutation of the
    envs per epoch), if given, replace the draws from ``state.generator``.
    Returns ``(new state, metrics)``, the metrics 0-d tensors on the
    device."""
    if cfg.num_envs % cfg.num_minibatches:
        raise ValueError("num_envs must divide into num_minibatches")
    layout = GruLayout.of(env, cfg)
    opt = make_optimizer(cfg)
    d, device = env.obs_dim, state.env_states.device

    h0 = state.h * (1.0 - state.prev_done)[None, :]  # the learner's start state
    rollout_gen = torch.Generator(device=device).manual_seed(_draw_seed(state.generator))
    tree = layout.unflatten(state.params)
    (s_t, h, dprev), traj = collect(env, cfg, tree, state, rollout_gen, noise)
    with torch.no_grad():
        _, _, _, last_value = policy_step(tree, h, s_t[:d], dprev)
        adv, ret = compute_gae(cfg, traj, last_value)

    if perms is None:
        perms = [torch.randperm(cfg.num_envs, generator=state.generator)
                 for _ in range(cfg.epochs)]
    mb_envs = cfg.num_envs // cfg.num_minibatches
    params, opt_state, metrics = state.params, state.opt_state, []
    for perm in perms:
        for idx in perm.to(device).reshape(cfg.num_minibatches, mb_envs):
            mb = tuple(x.index_select(-1, idx) for x in (traj.obs, traj.action, traj.log_prob,
                                                         adv, ret, traj.done_prev))
            grads, m = minibatch_grads(layout, params, cfg, mb, h0.index_select(-1, idx))
            params, opt_state = opt.update(grads, opt_state, params)
            metrics.append(torch.stack(m))
    loss, pg, v_loss, ratio_dev = torch.stack(metrics).mean(dim=0)
    new = RecurrentTrainState(params, opt_state, s_t.T, h, dprev, state.generator,
                              state.update_step + 1)
    return new, {"loss": loss, "pg_loss": pg, "v_loss": v_loss, "ratio_dev": ratio_dev,
                 "mean_reward": traj.reward.mean(), "mean_episode_done_frac": traj.done.mean()}


def train_many(env: EnvDef, cfg: RecurrentPpoConfig, state: RecurrentTrainState,
               num_updates: int):
    """``num_updates`` :func:`train_step` calls; the metrics averaged over
    them (the JAX module's ``make_train_many``)."""
    summaries = []
    for _ in range(num_updates):
        state, summary = train_step(env, cfg, state)
        summaries.append(summary)
    if not summaries:
        return state, {}
    return state, {k: torch.stack([s[k] for s in summaries]).mean() for k in summaries[0]}


@torch.no_grad()
def greedy_action(env: EnvDef, params, h, obs, done_prev):
    """The mean action for evaluation, ``params`` the pytree
    (:meth:`GruLayout.unflatten`); ``obs`` in the row layout, ``(B, D)`` or
    ``(D,)``.  Returns ``(action, h')``."""
    del env
    obs_t = obs.T if obs.dim() == 2 else obs[:, None]
    h, mean, _, _ = policy_step(params, h, obs_t, done_prev)
    return (mean.T if obs.dim() == 2 else mean[:, 0]), h
