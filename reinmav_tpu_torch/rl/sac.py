"""Soft Actor-Critic learner of the PyTorch port.

The counterpart of :mod:`reinmav_tpu.rl.sac`: twin Q networks with
min-clipping, a tanh-squashed state-dependent Gaussian policy, the
entropy temperature alpha tuned towards ``target_entropy`` (default
``-action_dim``), uniform-random warmup actions, and the replay ring on
the device as ONE feature-major ``(R, C)`` float32 tensor (rows: obs,
policy-space action, reward, next_obs, done; :func:`_row_dims`), with the
JAX package's defaults.  Actions are stored and fed to the critics in
policy space [-1, 1]; the env boundary maps them onto the env's physical
action box (:func:`scale_action_t`).

One iteration is one batched env step with auto-reset (the collection),
the insert of its replay block into the ring, and ``grad_steps``
updates; :func:`train_iters` runs ``num_iters`` of them.  The collection
runs in the fused CUDA kernel K7 (:mod:`reinmav_tpu_torch.ops.offpolicy`)
when the states lie on the card and the env, its kind and the actor's
widths are the kernel's, else eagerly (``fused_collect``, logged).  The
updates are ``torch.autograd``, with FP32 matmuls, or with
``compute_dtype="bfloat16"`` the JAX package's bf16 products (operands
rounded to bf16, float32 sums: :func:`.networks.bf16_mm`) and bf16 ReLU
residuals (:class:`ReluBf16Residual`); the collection then runs K7's bf16
instance or its eager counterpart.  The TD3/DDPG learner
(:mod:`.td3`) shares the ring, the collection and the optimiser.

Differences from the JAX package, by design:

- Parameters are flat vectors (:class:`MlpLayout`, the layer list's
  leaves in ``jax.tree.leaves`` order, with views for the matmuls): the
  actor, and the two critics as ONE vector ``[q1 | q2]`` (the order of
  the JAX package's ``{"q1", "q2"}`` optimiser tree), so that each Adam
  step and each polyak blend is a few fused ops.
- The PRNG key becomes a CPU ``torch.Generator`` (host draws only): each
  iteration draws K7's Philox seed and the seed of a device generator for
  the eager draws (action noise, warmup uniforms, resets, replay samples).
- The ring is updated in place (the JAX package donates it): a state's
  ``buffer`` is shared with the state it was made from.
- The gate, the counters and the metrics stay on the device; an
  iteration reads nothing from it, and :func:`train_iters` reads the
  metrics once at its end.

Sharded over ranks (``axis``, the JAX package's ``axis_name`` under
``shard_map``; :func:`make_train_iters` with a mesh): each rank steps its
own envs into its own ring (its share of the columns; ``ptr`` and
``filled`` stay replicated, since the inserts are symmetric), draws its
collection, reset and sampling streams from the replicated generator
folded with its rank, and averages the critic gradient and the actor and
alpha gradient over the ranks before their gated steps, so the params
stay bitwise replicated; ``batch_size`` is per rank.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..envs.core import EnvDef
from ..ops import offpolicy as collect_ops
from ..parallel.mesh import Mesh, fold_in
from ..ops import ppo_rollout as rollout_ops
from ..utils.metrics import to_host
from .networks import bf16_mm, bf16_round, is_bf16
from .ppo import (AdamState, ClipAdam, _choose, _device_generator, _draw_seed, adam_from_jax,
                  check_compute_dtype, kind_refusal)

log = logging.getLogger(__name__)

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)
ADAM_EPS = 1e-8  # optax.adam's default
#: Per-iteration metrics averaged over every iteration; the others (the
#: updates') over the iterations whose gate is open.
UNGATED = ("mean_reward", "done_frac", "buffer_filled", "desync_frac")


class SacConfig(NamedTuple):
    """The JAX package's ``SacConfig``: the same fields and defaults (see
    there for each).  ``fused_collect``: "auto" takes K7 on a CUDA device
    where it can, "on" forces K7's wrapper (its plain twin on the CPU) and
    raises where it cannot, "off" collects eagerly.  ``sample_tile``
    "auto" is exact uniform sampling (tile 1).  ``compute_dtype=
    "bfloat16"``: bf16 products with float32 sums in the updates and the
    collection (K7's bf16 instance on the card)."""

    num_envs: int = 256
    buffer_capacity: int = 1 << 20
    batch_size: int = 2048
    learning_rate: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    target_entropy: float | None = None
    init_log_alpha: float = 0.0
    hidden: tuple = (256, 256)
    grad_steps: int = 1
    warmup_steps: int = 10_000
    reward_scale: float = 1.0
    max_grad_norm: float | None = None
    compute_dtype: str = "float32"
    fused_collect: str = "auto"
    sample_tile: int | str = "auto"


# ---------------------------------------------------------------------------
# networks: flat vectors, transposed (features, batch) activations
# ---------------------------------------------------------------------------


class MlpLayout:
    """Where each leaf of a ``sac._mlp_init`` layer list (``[{"b": (dout,),
    "w": (din, dout)}, ...]``) lies in a flat vector: layer by layer, ``b``
    before ``w`` (``jax.tree.leaves`` order), each raveled row-major;
    ``copies`` such lists back to back (2 for the twin critics, in the
    order of the JAX package's ``{"q1", "q2"}`` tree)."""

    def __init__(self, dims: Sequence[int], copies: int = 1):
        self.dims, self.copies = tuple(int(d) for d in dims), copies
        self.shapes = list(zip(self.dims[:-1], self.dims[1:]))
        self.size_one = sum(dout + din * dout for din, dout in self.shapes)
        self.size = copies * self.size_one

    def layers(self, flat: torch.Tensor, copy: int = 0) -> list:
        """Copy ``copy``'s layer list as views of ``flat`` (gradients flow
        through)."""
        if flat.shape != (self.size,):
            raise ValueError(f"flat params must be ({self.size},), got {tuple(flat.shape)}")
        off, out = copy * self.size_one, []
        for din, dout in self.shapes:
            b = flat[off:off + dout]
            w = flat[off + dout:off + dout + din * dout].view(din, dout)
            out.append({"w": w, "b": b})
            off += dout + din * dout
        return out

    def flatten(self, *trees, device=None, dtype=torch.float32) -> torch.Tensor:
        """``copies`` layer lists (leaves as NumPy or JAX arrays or tensors)
        -> the flat vector.  Raises ``ValueError`` on a leaf of the wrong
        shape."""
        if len(trees) != self.copies:
            raise ValueError(f"{self.copies} layer lists expected, got {len(trees)}")
        leaves = []
        for tree in trees:
            if len(tree) != len(self.shapes):
                raise ValueError(f"{len(self.shapes)} layers expected, got {len(tree)}")
            for layer, (din, dout) in zip(tree, self.shapes):
                for key, shape in (("b", (dout,)), ("w", (din, dout))):
                    leaf = layer[key]
                    leaf = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
                    if tuple(leaf.shape) != shape:
                        raise ValueError(f"leaf {key} has shape {tuple(leaf.shape)}, expected {shape}")
                    leaves.append(leaf.reshape(-1).to(device=device, dtype=dtype))
        return torch.cat(leaves)


def init_mlp(layout: MlpLayout, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Orthogonal init as the JAX package's ``_mlp_init``: gain sqrt(2) on
    the hidden layers, 0.01 on the head, zero biases; each copy drawn in
    turn on the generator's device."""
    flat = torch.zeros(layout.size, dtype=dtype, device=generator.device)
    for copy in range(layout.copies):
        layers = layout.layers(flat, copy)
        for i, layer in enumerate(layers):
            gain = 1e-2 if i == len(layers) - 1 else math.sqrt(2.0)
            w = torch.empty(layer["w"].shape, dtype=dtype, device=generator.device)
            nn.init.orthogonal_(w, gain=gain, generator=generator)
            layer["w"].copy_(w)
    return flat


class ReluBf16Residual(torch.autograd.Function):
    """ReLU whose saved backward residual is its output rounded to bf16:
    ``g * (h16 > 0)`` (the JAX package's ``sac._relu_bf16_residual``)."""

    @staticmethod
    def forward(ctx, x):
        h = torch.relu(x)
        ctx.save_for_backward(h.to(torch.bfloat16))
        return h

    @staticmethod
    def backward(ctx, g):
        (h16,) = ctx.saved_tensors
        return g * (h16 > 0).to(g.dtype)


def _relu(x, bf16: bool):
    return ReluBf16Residual.apply(x) if bf16 else torch.relu(x)


def _dot_t(w, x_t, bf16: bool):
    """``w^T x_t`` for ``w`` ``(din, dout)`` and ``x_t`` ``(din, batch)``:
    a float32 matmul, or with ``bf16`` the bf16 product."""
    return bf16_mm(w.T, x_t) if bf16 else w.T @ x_t


def mlp_t(layers, x_t, compute_dtype=None):
    """ReLU MLP on ``(features, batch)``; linear final layer.
    ``compute_dtype`` "bfloat16": bf16 products and ReLU residuals; the
    bias adds and the ReLUs in float32."""
    bf16 = is_bf16(compute_dtype)
    for i, layer in enumerate(layers):
        x_t = _dot_t(layer["w"], x_t, bf16) + layer["b"][:, None]
        if i < len(layers) - 1:
            x_t = _relu(x_t, bf16)
    return x_t


def twin_mlp_t(la, lb, x_t, compute_dtype=None):
    """BOTH critics on one shared input in one stacked pass -> ``(ya, yb)``:
    layer 0 as ONE ``(din, 2H)`` product, every later layer as one batched
    ``(2, H, H)`` product (``torch.bmm``, with ``compute_dtype``
    "bfloat16" on bf16-rounded operands, the sums in float32), as the JAX
    package stacks them."""
    bf16 = is_bf16(compute_dtype)
    w0 = torch.cat([la[0]["w"], lb[0]["w"]], dim=1)
    b0 = torch.cat([la[0]["b"], lb[0]["b"]])
    h = la[0]["b"].shape[0]
    x = _relu(_dot_t(w0, x_t, bf16) + b0[:, None], bf16).reshape(2, h, x_t.shape[-1])
    for i in range(1, len(la)):
        w = torch.stack([la[i]["w"], lb[i]["w"]]).transpose(1, 2)
        b = torch.stack([la[i]["b"], lb[i]["b"]])
        x = (torch.bmm(bf16_round(w), bf16_round(x)) if bf16 else torch.bmm(w, x)) + b[:, :, None]
        if i < len(la) - 1:
            x = _relu(x, bf16)
    return x[0, 0], x[1, 0]


def twin_q_value_t(qa, qb, obs_t, act_t, compute_dtype=None):
    """Stacked twin-critic values -> ``((batch,), (batch,))``."""
    return twin_mlp_t(qa, qb, torch.cat([obs_t, act_t], dim=0), compute_dtype)


def q_value_t(q, obs_t, act_t, compute_dtype=None):
    """Single-critic values -> ``(batch,)``."""
    return mlp_t(q, torch.cat([obs_t, act_t], dim=0), compute_dtype)[0]


def actor_dist_t(actor, obs_t, action_dim: int, compute_dtype=None):
    """-> ``(mean_t, log_std_t)``, each ``(A, batch)``; log_std clamped to
    [-20, 2]."""
    out = mlp_t(actor, obs_t, compute_dtype)
    return out[:action_dim], torch.clamp(out[action_dim:], LOG_STD_MIN, LOG_STD_MAX)


def sample_squashed_eps_t(actor, obs_t, eps, action_dim: int, compute_dtype=None):
    """Reparameterised tanh-Gaussian sample from given standard-normal
    draws ``eps`` ``(A, batch)`` -> ``(action_t in [-1, 1], log_prob
    (batch,))``.  The squash correction uses log(1 - tanh(u)^2) = 2 (log 2
    - u - softplus(-2u)), with softplus as ``logaddexp(x, 0)``."""
    mean, log_std = actor_dist_t(actor, obs_t, action_dim, compute_dtype)
    std = torch.exp(log_std)
    u = mean + std * eps
    logp_u = torch.sum(-0.5 * torch.square((u - mean) / std) - log_std - 0.5 * _LOG_2PI, dim=0)
    softplus = torch.logaddexp(-2.0 * u, torch.zeros_like(u))
    squash = torch.sum(2.0 * (_LOG_2 - u - softplus), dim=0)
    return torch.tanh(u), logp_u - squash


def sample_squashed_t(actor, obs_t, generator: torch.Generator, action_dim: int,
                      compute_dtype=None):
    """:func:`sample_squashed_eps_t` with ``eps`` drawn from ``generator``
    (on the device of ``obs_t``)."""
    return sample_squashed_eps_t(actor, obs_t, _randn(generator, (action_dim, obs_t.shape[-1]),
                                                      obs_t), action_dim, compute_dtype)


def _randn(generator, shape, like):
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


# ---------------------------------------------------------------------------
# replay ring
# ---------------------------------------------------------------------------


def _row_dims(env: EnvDef) -> int:
    d, a = env.obs_dim, env.action_dim
    return d + a + 1 + d + 1  # obs, action, reward, next_obs, done


def _capacity(cfg, env: EnvDef) -> int:
    """Ring capacity rounded DOWN to a multiple of the insert width, so that
    a block never straddles the edge."""
    c = (cfg.buffer_capacity // cfg.num_envs) * cfg.num_envs
    if c < max(cfg.batch_size, cfg.num_envs):
        raise ValueError(f"buffer_capacity {cfg.buffer_capacity} too small for num_envs "
                         f"{cfg.num_envs} / batch {cfg.batch_size}")
    return c


def buffer_insert(buffer, ptr, filled, block):
    """Insert the ``(R, n)`` column block at column ``ptr`` of the ``(R,
    C)`` ring, in place (one copy into the ring's columns ``ptr .. ptr +
    n``; the capacity is a multiple of n, so it never straddles the edge).
    ``ptr`` and ``filled`` are 0-d int64 tensors on the ring's device; no
    host read.  Returns ``(buffer, ptr, filled)``."""
    n, cap = block.shape[1], buffer.shape[1]
    cols = ptr + torch.arange(n, device=buffer.device)
    buffer.index_copy_(1, cols, block.to(buffer.dtype))
    ptr = torch.where(ptr + n >= cap, torch.zeros_like(ptr), ptr + n)
    filled = torch.clamp(filled + n, max=cap)
    return buffer, ptr, filled


def buffer_sample(buffer, filled, u, batch: int, tile: int = 1):
    """``(R, batch)`` columns of the ring's filled prefix from the float32
    uniforms ``u``: tile 1 (``u`` of ``batch``) column ``min(floor(u *
    filled), filled - 1)``; tile > 1 (``u`` of ``batch / tile``) the
    contiguous ``(R, tile)`` blocks ``min(floor(u * n), n - 1)`` of ``n =
    max(filled // tile, 1)`` (same-iteration env cohorts, NOT i.i.d.; see
    the JAX package's ``SacConfig.sample_tile``)."""
    if tile <= 1:
        idx = torch.minimum((u * filled.to(torch.float32)).to(torch.int64), filled - 1)
        return buffer.index_select(1, idx)
    n_filled = torch.clamp(filled // tile, min=1)
    idx = torch.minimum((u * n_filled.to(torch.float32)).to(torch.int64), n_filled - 1)
    cols = (idx[:, None] * tile + torch.arange(tile, device=buffer.device)).reshape(batch)
    return buffer.index_select(1, cols)


def resolve_sample_tile(cfg, b_local: int) -> int:
    """``sample_tile`` -> the tile width: "auto" is exact uniform tile 1."""
    tile = cfg.sample_tile
    if tile == "auto":
        return 1
    if not isinstance(tile, int) or isinstance(tile, bool):
        raise ValueError(f"sample_tile must be an int or 'auto', got {tile}")
    if tile > 1 and (cfg.batch_size % tile or b_local % tile):
        raise ValueError(f"sample_tile {tile} must divide batch_size {cfg.batch_size} and the "
                         f"env batch {b_local}")
    return tile


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def split_rows(env: EnvDef, rows):
    """``(obs, action, reward, next_obs, done)`` of a sampled ``(R, batch)``
    block."""
    d, a = env.obs_dim, env.action_dim
    return (rows[:d], rows[d:d + a], rows[d + a], rows[d + a + 1:2 * d + a + 1],
            rows[2 * d + a + 1])


def _critic_loss_eps(q_params, cfg, env: EnvDef, batch_rows, target_q, eps, actor, log_alpha,
                     compute_dtype=None):
    """MSE of both critics against the soft Bellman target, with the
    target action's standard-normal draw given as ``eps`` ``(A, batch)``.
    ``q_params`` ``{"q1": layers, "q2": layers}``, ``target_q`` the target
    critics' ``(layers, layers)``.  Returns ``(loss, (mean q1, mean
    target))``; the target carries no gradient."""
    cd = compute_dtype
    obs, act, rew, nobs, done = split_rows(env, batch_rows)
    with torch.no_grad():
        q1t, q2t = target_q
        na, nlogp = sample_squashed_eps_t(actor, nobs, eps, env.action_dim, cd)
        tq = torch.minimum(*twin_q_value_t(q1t, q2t, nobs, na, cd))
        alpha = torch.exp(log_alpha)
        target = rew * cfg.reward_scale + cfg.gamma * (1.0 - done) * (tq - alpha * nlogp)
    q1v, q2v = twin_q_value_t(q_params["q1"], q_params["q2"], obs, act, cd)
    loss = torch.mean(torch.square(q1v - target) + torch.square(q2v - target))
    return loss, (torch.mean(q1v.detach()), torch.mean(target))


def critic_loss(q_params, cfg, env: EnvDef, batch_rows, target_q, generator, actor, log_alpha,
                compute_dtype=None):
    """:func:`_critic_loss_eps` with ``eps`` drawn from ``generator``."""
    eps = _randn(generator, (env.action_dim, batch_rows.shape[-1]), batch_rows)
    return _critic_loss_eps(q_params, cfg, env, batch_rows, target_q, eps, actor, log_alpha,
                            compute_dtype)


def _actor_alpha_loss_eps(aa_params, cfg, env: EnvDef, batch_rows, q1, q2, eps,
                          target_entropy: float, compute_dtype=None):
    """Actor + temperature loss with the resample draw given as ``eps``
    ``(A, batch)``.  ``aa_params`` ``{"actor": layers, "log_alpha": 0-d}``;
    the critics ``q1``, ``q2`` are held fixed.  The alpha term is
    ``-log_alpha * mean(logp + target_entropy)`` with logp detached.
    Returns ``(loss, (pi_loss, entropy, alpha))``."""
    obs = batch_rows[:env.obs_dim]
    act_s, logp = sample_squashed_eps_t(aa_params["actor"], obs, eps, env.action_dim,
                                        compute_dtype)
    qmin = torch.minimum(*twin_q_value_t(q1, q2, obs, act_s, compute_dtype))
    alpha = torch.exp(aa_params["log_alpha"].detach())
    pi_loss = torch.mean(alpha * logp - qmin)
    a_loss = -aa_params["log_alpha"] * torch.mean(logp.detach() + target_entropy)
    return pi_loss + a_loss, (pi_loss.detach(), -torch.mean(logp.detach()), alpha)


def actor_alpha_loss(aa_params, cfg, env: EnvDef, batch_rows, q1, q2, generator,
                     target_entropy: float, compute_dtype=None):
    """:func:`_actor_alpha_loss_eps` with ``eps`` drawn from ``generator``."""
    eps = _randn(generator, (env.action_dim, batch_rows.shape[-1]), batch_rows)
    return _actor_alpha_loss_eps(aa_params, cfg, env, batch_rows, q1, q2, eps, target_entropy,
                                 compute_dtype)


# ---------------------------------------------------------------------------
# actions, optimiser
# ---------------------------------------------------------------------------


def _action_bounds(env: EnvDef):
    """``(lo, hi, half_span)``: the env's physical per-dim action box when
    declared (float32 arrays, ``0.5 * (hi - lo)`` taken in float32 as NumPy
    does in the JAX package), else its scalar gym-space bounds."""
    if env.action_low_phys is None:
        lo, hi = float(env.action_low), float(env.action_high)
        return lo, hi, 0.5 * (hi - lo)
    lo = np.asarray(env.action_low_phys, np.float32)
    hi = np.asarray(env.action_high_phys, np.float32)
    return lo, hi, np.float32(0.5) * (hi - lo)


def scale_action_t(env: EnvDef, a_t):
    """[-1, 1] policy space -> the env's action box, ``(A, B)`` layout
    (the JAX package's ``_scale_action_t``)."""
    lo, _, half = _action_bounds(env)
    if isinstance(lo, np.ndarray):
        lo = torch.from_numpy(lo).to(a_t)[:, None]
        half = torch.from_numpy(half).to(a_t)[:, None]
    return lo + (a_t + 1.0) * half


def consts_tail(env: EnvDef, explore_noise: float, device) -> torch.Tensor:
    """The constant part of K7's consts, ``[explore_noise, lo (A), hi
    (A)]`` float32 on ``device``: one host-to-device copy, so made once per
    :func:`train_iters` call."""
    a = env.action_dim
    lo, hi, _ = _action_bounds(env)
    vals = np.concatenate([[explore_noise], np.broadcast_to(np.float32(lo), (a,)),
                           np.broadcast_to(np.float32(hi), (a,))]).astype(np.float32)
    return torch.from_numpy(vals).to(device)


def collect_consts(env: EnvDef, warm, explore_noise: float, tail=None) -> torch.Tensor:
    """K7's float32 consts ``[warm_gate, explore_noise, lo (A), hi (A)]`` on
    the device of the 0-d bool ``warm``; ``tail`` the constant part
    (:func:`consts_tail`, made here when None)."""
    if tail is None:
        tail = consts_tail(env, explore_noise, warm.device)
    return torch.cat([warm.to(torch.float32).reshape(1), tail])


def make_optimizers(cfg: SacConfig):
    """optax's ``adam(lr)`` (with ``clip_by_global_norm(max_grad_norm)``
    first when set) for the actor and for the critics, and plain
    ``adam(alpha_lr)`` for log_alpha."""
    return (ClipAdam(cfg.max_grad_norm, cfg.learning_rate, eps=ADAM_EPS),
            ClipAdam(cfg.max_grad_norm, cfg.learning_rate, eps=ADAM_EPS),
            ClipAdam(None, cfg.alpha_lr, eps=ADAM_EPS))


@torch.no_grad()
def gated_step(opt: ClipAdam, grads, opt_state: AdamState, params, ready):
    """One optimiser step on ``grads`` (already multiplied by the gate),
    with the optimiser state kept where ``ready`` (a 0-d bool) is False:
    Adam's count and moments do not advance while the gate is closed."""
    params, new = opt.update(grads, opt_state, params)
    return params, AdamState(*(torch.where(ready, n, o) for n, o in zip(new, opt_state)))


def polyak(target, online, blend):
    """``(1 - blend) * target + blend * online``."""
    return (1 - blend) * target + blend * online


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


class SacState(NamedTuple):
    actor: torch.Tensor           # flat, actor_layout
    critics: torch.Tensor         # flat [q1 | q2], critic_layout
    critics_target: torch.Tensor
    log_alpha: torch.Tensor       # 0-d
    opt_actor: AdamState
    opt_q: AdamState
    opt_alpha: AdamState
    buffer: torch.Tensor          # (R, C) float32 feature-major ring
    ptr: torch.Tensor             # 0-d int64: next insert column
    filled: torch.Tensor          # 0-d int64: valid columns (<= C)
    env_states: torch.Tensor      # (B, D)
    generator: torch.Generator    # CPU; host draws only
    total_steps: torch.Tensor     # 0-d int64 env-step counter
    ever_done: torch.Tensor       # (B,): 1 once the env has terminated


def actor_layout(env: EnvDef, hidden, head: int) -> MlpLayout:
    return MlpLayout((env.obs_dim, *hidden, head))


def critic_layout(env: EnvDef, hidden, copies: int = 2) -> MlpLayout:
    return MlpLayout((env.obs_dim + env.action_dim, *hidden, 1), copies)


def _sac_layouts(env: EnvDef, cfg):
    return actor_layout(env, cfg.hidden, 2 * env.action_dim), critic_layout(env, cfg.hidden)


def _ring(env: EnvDef, cfg, device):
    i64 = dict(dtype=torch.int64, device=device)
    return (torch.zeros((_row_dims(env), _capacity(cfg, env)), dtype=torch.float32, device=device),
            torch.zeros((), **i64), torch.zeros((), **i64))


def init_state(env: EnvDef, cfg: SacConfig, seed: int = 0, device="cuda") -> SacState:
    """Fresh params (orthogonal init), optimisers, ring and env states, on
    ``device`` (the card unless the caller asks for the CPU)."""
    check_compute_dtype(cfg)
    generator = torch.Generator().manual_seed(seed)
    la, lq = _sac_layouts(env, cfg)
    actor = init_mlp(la, generator).to(device)
    critics = init_mlp(lq, generator).to(device)
    opt_a, opt_q, opt_al = make_optimizers(cfg)
    log_alpha = torch.tensor(cfg.init_log_alpha, dtype=torch.float32, device=device)
    env_states = env.vreset(_device_generator(_draw_seed(generator), device), cfg.num_envs)
    buffer, ptr, filled = _ring(env, cfg, device)
    return SacState(actor, critics, critics.clone(), log_alpha, opt_a.init(actor),
                    opt_q.init(critics), opt_al.init(log_alpha), buffer, ptr, filled, env_states,
                    generator, torch.zeros((), dtype=torch.int64, device=device),
                    torch.zeros(cfg.num_envs, dtype=torch.float32, device=device))


def _tensor(x, device, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def state_from_jax(env: EnvDef, cfg: SacConfig, jstate, seed: int = 0, device=None,
                   dtype=torch.float32) -> SacState:
    """A JAX ``SacState`` (leaves as NumPy or JAX arrays) -> the port's, on
    ``device``: the layer lists, the targets, ``log_alpha``, each optax
    Adam state's count and moments, the ring, ``ptr``, ``filled``, the env
    states, ``total_steps`` and ``ever_done``.  Params, moments and env
    states take ``dtype``; the ring stays float32.  The key is not
    carried: the port's generator is seeded with ``seed``."""
    la, lq = _sac_layouts(env, cfg)
    kw = dict(device=device, dtype=dtype)
    q_flat = lambda tree: lq.flatten(tree["q1"], tree["q2"], dtype=dtype)  # noqa: E731
    return SacState(
        la.flatten(jstate.actor, **kw), lq.flatten(jstate.q1, jstate.q2, **kw),
        lq.flatten(jstate.q1_target, jstate.q2_target, **kw),
        _tensor(jstate.log_alpha, device, dtype),
        adam_from_jax(jstate.opt_actor, lambda t: la.flatten(t, dtype=dtype), **kw),
        adam_from_jax(jstate.opt_q, q_flat, **kw),
        adam_from_jax(jstate.opt_alpha, lambda t: _tensor(t, None, dtype), **kw),
        _tensor(jstate.buffer, device, torch.float32), _tensor(jstate.ptr, device, torch.int64),
        _tensor(jstate.filled, device, torch.int64), _tensor(jstate.env_states, device, dtype),
        torch.Generator().manual_seed(seed), _tensor(jstate.total_steps, device, torch.int64),
        _tensor(jstate.ever_done, device, torch.float32))


# ---------------------------------------------------------------------------
# one update, one iteration
# ---------------------------------------------------------------------------


class Draws(NamedTuple):
    """One update's draws: the replay uniforms (float32), the target
    action's and the actor resample's standard normals ``(A, batch)``."""

    u: torch.Tensor
    eps_target: torch.Tensor
    eps_pi: torch.Tensor


def draw_update(generator: torch.Generator, cfg, env: EnvDef, tile: int, like) -> Draws:
    """One update's :class:`Draws` from ``generator`` (on the device and in
    the dtype of ``like``)."""
    u = torch.rand(cfg.batch_size // tile, generator=generator, device=like.device,
                   dtype=torch.float32)
    shape = (env.action_dim, cfg.batch_size)
    return Draws(u, _randn(generator, shape, like), _randn(generator, shape, like))


class Nets(NamedTuple):
    """What one SAC update changes."""

    actor: torch.Tensor
    critics: torch.Tensor
    critics_target: torch.Tensor
    log_alpha: torch.Tensor
    opt_actor: AdamState
    opt_q: AdamState
    opt_alpha: AdamState


def average_grads(axis: Mesh | None, *grads):
    """The gradients averaged over the ranks in one all-reduce (the JAX
    package's ``pmean``); as they are without ``axis``."""
    if axis is None:
        return grads if len(grads) > 1 else grads[0]
    with record_function("sac.all_reduce"):
        vec = axis.all_reduce_mean(torch.cat([g.reshape(-1) for g in grads]))
    out, at = [], 0
    for g in grads:
        out.append(vec[at:at + g.numel()].reshape(g.shape))
        at += g.numel()
    return tuple(out) if len(out) > 1 else out[0]


def update_step(env: EnvDef, cfg: SacConfig, nets: Nets, buffer, filled, ready, draws: Draws,
                tile: int = 1, axis: Mesh | None = None):
    """One SAC update from the ring (the JAX package's ``one_update``): the
    critics' step, then the actor's and alpha's against the new critics,
    each with the gradient times the gate and the optimiser state frozen
    while ``ready`` is False, then the polyak blend ``tau * gate``.  With
    ``axis`` each gradient is first averaged over the ranks.  Returns
    ``(nets, metrics)``, the metrics 0-d tensors (this rank's)."""
    la, lq = _sac_layouts(env, cfg)
    opt_a, opt_q, opt_al = make_optimizers(cfg)
    target_entropy = (-float(env.action_dim) if cfg.target_entropy is None
                      else float(cfg.target_entropy))
    dtype = nets.actor.dtype
    gate = ready.to(torch.float32)  # float32 as the JAX package's, tau * gate too
    with record_function("sac.sample"):
        rows = buffer_sample(buffer, torch.clamp(filled, min=1), draws.u, cfg.batch_size,
                             tile).to(dtype)
    with record_function("sac.update"):
        q = nets.critics.detach().requires_grad_(True)
        qloss, (q_mean, tgt_mean) = _critic_loss_eps(
            {"q1": lq.layers(q, 0), "q2": lq.layers(q, 1)}, cfg, env, rows,
            (lq.layers(nets.critics_target, 0), lq.layers(nets.critics_target, 1)),
            draws.eps_target, la.layers(nets.actor), nets.log_alpha, cfg.compute_dtype)
        (qg,) = torch.autograd.grad(qloss, q)
        qg = average_grads(axis, qg)
        critics, opt_q_state = gated_step(opt_q, qg * gate, nets.opt_q, nets.critics, ready)

        a = nets.actor.detach().requires_grad_(True)
        log_alpha = nets.log_alpha.detach().requires_grad_(True)
        ploss, (pi_loss, ent, alpha) = _actor_alpha_loss_eps(
            {"actor": la.layers(a), "log_alpha": log_alpha}, cfg, env, rows,
            lq.layers(critics, 0), lq.layers(critics, 1), draws.eps_pi, target_entropy,
            cfg.compute_dtype)
        ag, alg = average_grads(axis, *torch.autograd.grad(ploss, (a, log_alpha)))
        actor, opt_a_state = gated_step(opt_a, ag * gate, nets.opt_actor, nets.actor, ready)
        new_log_alpha, opt_al_state = gated_step(opt_al, alg * gate, nets.opt_alpha,
                                                 nets.log_alpha, ready)
        with torch.no_grad():
            critics_target = polyak(nets.critics_target, critics, cfg.tau * gate)
    metrics = {"q_loss": qloss.detach(), "pi_loss": pi_loss, "entropy": ent, "alpha": alpha,
               "q_mean": q_mean, "target_mean": tgt_mean}
    return Nets(actor, critics, critics_target, new_log_alpha, opt_a_state, opt_q_state,
                opt_al_state), metrics


def collect_refusal(cfg, env: EnvDef, device: torch.device):
    """Why K7 cannot collect for this config and env on ``device`` (None =
    it can): its twin takes two hidden layers of any widths; the kernel,
    on a CUDA device, each from 1 to 256 wide; and the env must be a kind
    of the kernel's table with the registry's functions and Params type."""
    hidden = tuple(cfg.hidden)
    if len(hidden) != 2:
        return f"hidden {hidden} is not two layers"
    if device.type == "cuda":
        reason = collect_ops.width_refusal(hidden)
        if reason is not None:
            return reason
    if not collect_ops.supported(env):
        return f"no K7 for {env.name} (built for {sorted(rollout_ops.ENVS)})"
    return kind_refusal(env, "K7")


def choose_collect(cfg, env: EnvDef, device: torch.device, fused_collect=None):
    """(use K7, how to log it), as the PPO learner chooses its kernels:
    "auto" takes K7 on a CUDA device where it can and logs why not
    otherwise; "on" (or True) takes K7's wrapper, its twin on the CPU, and
    raises where it cannot; "off" collects eagerly."""
    return _choose("fused_collect", fused_collect, cfg.fused_collect,
                   collect_refusal(cfg, env, device), device)


def collect(env: EnvDef, cfg, actor_layers, env_states, warm, use_k7: bool, mode: str,
            explore_noise: float, seed: int, generator: torch.Generator, tail=None):
    """One batched env step with auto-reset for the off-policy learners:
    ``mode`` "sac" (tanh-Gaussian) or "td3" (tanh + clipped noise of std
    ``explore_noise``), uniform [-1, 1] actions while the 0-d bool ``warm``
    is set.  ``use_k7``: one K7 launch keyed by ``seed`` (its twin on the
    CPU), ``tail`` the constant part of its consts (:func:`consts_tail`);
    else eagerly with ``generator``.  Both take ``cfg.compute_dtype``.  Returns ``(new states (D, B),
    replay block (R, B), reward (B,), done (B,) float)``; the block's
    next_obs rows are the TERMINAL observations."""
    d, a = env.obs_dim, env.action_dim
    states_t = env_states.T
    if use_k7:
        consts = collect_consts(env, warm, explore_noise, tail)
        weights = collect_ops.actor_kernel_args(
            [{k: v.to(torch.float32).contiguous() for k, v in layer.items()}
             for layer in actor_layers])
        new_t, block = collect_ops.collect_step(
            env.name, mode, states_t.to(torch.float32).contiguous(), seed, consts,
            rollout_ops.env_params_vec(env), *weights, compute_dtype=cfg.compute_dtype)
        return new_t.to(env_states.dtype), block, block[d + a], block[2 * d + a + 1]
    obs_t = states_t[:d]
    if mode == "sac":
        a_pol, _ = sample_squashed_t(actor_layers, obs_t, generator, a, cfg.compute_dtype)
    else:
        a_pol = torch.clamp(torch.tanh(mlp_t(actor_layers, obs_t, cfg.compute_dtype))
                            + explore_noise * _randn(generator, (a, obs_t.shape[1]), obs_t),
                            -1.0, 1.0)
    a_rand = torch.rand(a_pol.shape, generator=generator, device=obs_t.device,
                        dtype=obs_t.dtype) * 2.0 - 1.0
    a_t = torch.where(warm, a_rand, a_pol)
    out = env.autoreset_step_t(states_t, scale_action_t(env, a_t), generator)
    done = out.done.to(obs_t.dtype)
    # out.obs is the TERMINAL observation (the auto-reset replaces only
    # .state), so the stored next_obs is the true successor.
    block = torch.cat([obs_t, a_t, out.reward[None], out.obs[:d], done[None]])
    return out.state, block, out.reward, done


def iteration_metrics(update_metrics: list, gate, reward, done, filled, ever_done,
                      axis: Mesh | None = None) -> dict:
    """One iteration's metrics on the device: the updates' means masked by
    the gate, and the collection's; with ``axis`` averaged over the ranks
    in one all-reduce."""
    out = {k: torch.stack([m[k] for m in update_metrics]).mean() * gate
           for k in update_metrics[0]}
    out.update(update_gate=gate, mean_reward=reward.mean(), done_frac=done.mean(),
               buffer_filled=filled.to(gate.dtype), desync_frac=ever_done.mean())
    return out if axis is None else axis.mean_dict(out)


def finish_metrics(per_iter: list) -> dict:
    """Per-iteration metrics -> one value each (the JAX package's
    ``_finish_metrics``): the updates' averaged over the gate-open
    iterations, the collection's over all; 0-d tensors on the device."""
    stacked = {k: torch.stack([m[k] for m in per_iter]) for k in per_iter[0]}
    gate = stacked.pop("update_gate")
    denom = torch.clamp(gate.sum(), min=1.0)
    return {k: (v.mean() if k in UNGATED else v.sum() / denom) for k, v in stacked.items()}


def sharding(axis: Mesh | None) -> str:
    """How the learners' logs name the sharding of an iteration."""
    if axis is None:
        return ""
    return (f"; sharded over {axis.world_size} ranks (rank {axis.rank}): rank-local streams, "
            "gradients and metrics all-reduced")


def iteration_seeds(generator: torch.Generator, device, axis: Mesh | None):
    """One iteration's K7 seed and device generator for the eager draws,
    from the replicated ``generator``; with ``axis`` each folded with the
    rank (the JAX package's ``fold_in(key, axis_index)``)."""
    seed, gseed = _draw_seed(generator), _draw_seed(generator)
    if axis is not None:
        seed, gseed = fold_in(seed, axis.rank), fold_in(gseed, axis.rank)
    return seed, _device_generator(gseed, device)


def train_iters(env: EnvDef, cfg: SacConfig, state: SacState, num_iters: int,
                fused_collect=None, axis: Mesh | None = None):
    """Run ``num_iters`` SAC iterations (each: one batched env step, the
    ring insert, ``cfg.grad_steps`` updates).  Returns ``(state,
    metrics)``: the metrics averaged as the JAX package does, read to the
    host once at the end (floats).  ``fused_collect`` None follows
    ``cfg.fused_collect``; True / False force.  Logs which collection ran
    and why, and the compute dtype.  ``axis``: the mesh of a sharded run
    (see the module docstring); ``state`` then holds this rank's envs and
    ring columns, and the warm-up counter still advances by the global
    ``cfg.num_envs`` an iteration, as the JAX package counts it."""
    check_compute_dtype(cfg)
    device = state.env_states.device
    use_k7, how = choose_collect(cfg, env, device, fused_collect)
    tile = resolve_sample_tile(cfg, state.env_states.shape[0])
    la, _ = _sac_layouts(env, cfg)
    log.info("sac.train_iters(%s, B=%d, %d iterations, %s): collection: %s; %d updates per "
             "iteration through autograd%s", env.name, state.env_states.shape[0], num_iters,
             cfg.compute_dtype,
             f"K7 {how}, 1 launch per iteration" if use_k7 else f"eager, K7 {how}",
             cfg.grad_steps, sharding(axis))
    tail = consts_tail(env, 0.0, device) if use_k7 else None
    per_iter = []
    for _ in range(num_iters):
        seed, gen = iteration_seeds(state.generator, device, axis)
        warm = state.total_steps < cfg.warmup_steps
        with record_function("sac.collect"), torch.no_grad():
            new_t, block, reward, done = collect(env, cfg, la.layers(state.actor),
                                                 state.env_states, warm, use_k7, "sac", 0.0,
                                                 seed, gen, tail)
        with record_function("sac.insert"):
            buffer, ptr, filled = buffer_insert(state.buffer, state.ptr, state.filled, block)
        total = state.total_steps + cfg.num_envs
        ready = (filled >= cfg.batch_size) & (total >= cfg.warmup_steps)
        nets = Nets(state.actor, state.critics, state.critics_target, state.log_alpha,
                    state.opt_actor, state.opt_q, state.opt_alpha)
        step_metrics = []
        for _ in range(cfg.grad_steps):
            nets, m = update_step(env, cfg, nets, buffer, filled, ready,
                                  draw_update(gen, cfg, env, tile, state.actor), tile, axis)
            step_metrics.append(m)
        ever_done = torch.maximum(state.ever_done, done.to(state.ever_done.dtype))
        per_iter.append(iteration_metrics(step_metrics, ready.to(torch.float32), reward,
                                          done, filled, ever_done, axis))
        state = SacState(*nets[:4], nets.opt_actor, nets.opt_q, nets.opt_alpha, buffer, ptr,
                         filled, new_t.T, state.generator, total, ever_done)
    return state, (to_host(finish_metrics(per_iter)) if per_iter else {})


def check_divides(cfg, mesh: Mesh) -> None:
    """``cfg.num_envs`` (global) must divide by the world size."""
    if cfg.num_envs % mesh.world_size != 0:
        raise ValueError(f"num_envs {cfg.num_envs} not divisible by mesh size {mesh.world_size}")


def make_train_iters(env: EnvDef, cfg: SacConfig, num_iters: int, mesh: Mesh | None = None):
    """``run(state) -> (state, metrics)``: ``num_iters`` iterations of
    :func:`train_iters`, sharded over ``mesh`` when given (``cfg.num_envs``
    global and divisible by the world size, ``cfg.batch_size`` per rank,
    the state this rank's shard: :func:`reinmav_tpu_torch.parallel.shard_state`)."""
    if mesh is not None:
        check_divides(cfg, mesh)
    return lambda state: train_iters(env, cfg, state, num_iters, axis=mesh)


@torch.no_grad()
def greedy_action(env: EnvDef, actor, obs, hidden):
    """Deterministic (tanh-mean) action for evaluation, row layout:
    ``actor`` the flat vector of widths ``hidden``, ``obs`` ``(B, D)`` or
    ``(D,)``."""
    layers = actor_layout(env, hidden, 2 * env.action_dim).layers(actor)
    obs_t = obs.T if obs.dim() == 2 else obs[:, None]
    mean, _ = actor_dist_t(layers, obs_t.to(actor.dtype), env.action_dim)
    scaled = scale_action_t(env, torch.tanh(mean))
    return scaled.T if obs.dim() == 2 else scaled[:, 0]
