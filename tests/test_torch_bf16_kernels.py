"""The bf16 twins of K3, K4, K2/K6 and K7 (``compute_dtype="bfloat16"``)
against the JAX package's Pallas kernels in their bf16 mode, run in
interpret mode on the CPU as the JAX package's own tests run them.

Both sides take the same float32 inputs, made with a numpy seed, and
compute in float32 with each product's operands rounded to bf16 (the
Pallas ``_mm``, the twins' ``networks.bf16_mm`` or their kernel-order
sums).  The sides sum in other orders, and XLA's CPU tanh is not libm's,
so a value rounded to bf16 downstream can land one bf16 ulp (2^-8
relative) apart: the tolerances are bf16-sized, and none is looser than
the JAX package's own bf16 tolerances (tests/test_pallas_ppo.py:150-176:
metrics rtol 2e-2 / atol 2e-3, gradient blocks within 0.15 of their
scale):

- K3 (n = 512, tile 128) and K4 (2 epochs x 2 minibatches): metrics rtol
  2e-3 / atol 2e-4; gradients, params and Adam moments by their error's
  norm within 1e-2 of the reference's and every entry within 2e-2 of the
  reference's largest (GRAD_NORM_TOL, GRAD_TOL);
- K2 at 64 envs x 8 steps: sigma -> 0 (the whole rollout deterministic),
  every output within rtol 2e-3 / atol 2e-3, at most 1% of the entries
  of a row within rtol 2e-2 / atol 2e-2 only (a bf16 flip upstream); and
  a stochastic leg on lanes that never reset, the stored logp and value
  those of the JAX bf16 policy on the stored obs and action;
- K7 at 128 envs in its deterministic modes, at 2 x 64 and at 400-300:
  the action rows within rtol 2e-3 / atol 2e-3, at most 1% within rtol
  2e-2 / atol 2e-2 only, and the env's response to the stored action (the
  rows after it) at the f32 tests' rtol 1e-5 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.ops import pallas_offpolicy, pallas_ppo, pallas_ppo_rollout, pallas_ppo_update
from reinmav_tpu.rl import networks as jnet
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu.rl import sac as jsac
from reinmav_tpu_torch.ops import offpolicy
from reinmav_tpu_torch.ops import ppo_loss as pl
from reinmav_tpu_torch.ops import ppo_rollout as pr
from reinmav_tpu_torch.ops import ppo_update as pu
from reinmav_tpu_torch.rl import networks, ppo, sac

BF16 = "bfloat16"
METRIC_TOL = dict(rtol=2e-3, atol=2e-4)
GRAD_TOL = 2e-2
GRAD_NORM_TOL = 1e-2
ROW_TOL = dict(rtol=2e-3, atol=2e-3)
FLIP_TOL = dict(rtol=2e-2, atol=2e-2)
MAX_FLIPS = 0.01
A, TILE = 4, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _f32(x):
    return np.asarray(x, np.float32)


def _vec_close(got, ref, what):
    """The error's norm within GRAD_NORM_TOL of the reference's, every
    entry within GRAD_TOL of the reference's largest."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all(), what
    err = np.linalg.norm(got - ref)
    assert err <= GRAD_NORM_TOL * max(np.linalg.norm(ref), 1e-6), (what, err, np.linalg.norm(ref))
    assert np.abs(got - ref).max() <= GRAD_TOL * np.abs(ref).max(), what


def _rows_close(got, ref, what):
    """Every entry within FLIP_TOL, all but MAX_FLIPS within ROW_TOL."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64).reshape(got.shape)
    np.testing.assert_allclose(got, ref, **FLIP_TOL, err_msg=what)
    outside = ~np.isclose(got, ref, **ROW_TOL)
    assert outside.sum() <= MAX_FLIPS * outside.size, (what, int(outside.sum()), outside.size)


def _params(seed, d, a=A):
    """A 2 x 64 actor-critic, float32, off its init (log_std + 0.1)."""
    rng = np.random.default_rng(seed)
    params = jnet.init_params(jax.random.PRNGKey(seed), jnet.MlpConfig(d, a, (64, 64)))
    params = jax.tree.map(lambda x: jnp.asarray(
        _f32(x) + np.float32(0.05) * rng.standard_normal(x.shape).astype(np.float32)), params)
    params["log_std"] = params["log_std"] + 0.1
    return params


def _batch(seed, d, n):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    obs, act, adv, old_value = f(d, n), f(A, n), f(n), f(n)
    old_logp = f(n) * np.float32(0.3) - np.float32(4.0)
    return obs, act, old_logp, old_value, adv, old_value + f(n) * np.float32(0.5)


def _flat(tree):
    return networks.params_from_jax(jax.tree.map(_f32, tree))


@pytest.mark.parametrize("mode,d", [("clip", 10), ("kl", 10), ("clip", 13)])
def test_k3_bf16_twin_matches_the_jax_kernel(mode, d):
    n, perm = 512, [2, 0, 3]
    params, batch = _params(d, d), _batch(d + 1, d, n)
    stats = [0.1, 1.3, 0.7 if mode == "kl" else 0.0, 0.0]
    cfg = dict(clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, ent_coef=0.01,
               kl_mode=mode == "kl")
    grads, metrics = pl.ppo_loss_grads_gather(
        pl.stack_batch(*(torch.from_numpy(x) for x in batch)), torch.tensor(stats),
        torch.tensor(perm, dtype=torch.int32), _flat(params), d=d, adim=A, tile=TILE,
        compute_dtype=BF16, **cfg)
    layers, wo, bo = jnet.fused_weights(params)
    (w1, b1), (w2, b2) = layers
    with pltpu.force_tpu_interpret_mode():
        j_g, j_m = pallas_ppo.ppo_loss_grads_pallas_gather(
            pallas_ppo.stack_batch(*(jnp.asarray(x) for x in batch)),
            jnp.asarray([stats], jnp.float32), jnp.asarray(perm, jnp.int32), w1, b1, w2, b2, wo,
            bo, params["log_std"], d=d, adim=A, tile=TILE, compute_dtype=BF16, **cfg)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(metrics[name]), float(j_m[name]), **METRIC_TOL,
                                   err_msg=name)
    _vec_close(grads.numpy(), _flat(jppo._unfuse_grads(j_g, 64, A)).numpy(), f"{mode} grads")
    f32, _ = pl.ppo_loss_grads_gather(
        pl.stack_batch(*(torch.from_numpy(x) for x in batch)), torch.tensor(stats),
        torch.tensor(perm, dtype=torch.int32), _flat(params), d=d, adim=A, tile=TILE, **cfg)
    assert float((f32 - grads).abs().max()) > 0.0  # the bf16 products were taken


def test_k4_bf16_twin_matches_the_jax_kernel():
    d, n, epochs, minibatches = 10, 1024, 2, 2
    params, batch = _params(20, d), _batch(21, d, n)
    n_tiles = n // TILE
    rng = np.random.default_rng(22)
    perm = np.concatenate([rng.permutation(n_tiles) for _ in range(epochs)]).astype(np.int32)
    adv_stats = np.stack([rng.normal(0.0, 0.1, epochs * minibatches),
                          rng.uniform(0.8, 1.2, epochs * minibatches)], 1).astype(np.float32)
    kw = dict(tile=TILE, n_minibatches=minibatches, n_epochs=epochs, clip_eps=0.2,
              value_clip_eps=0.2, value_coef=0.5, ent_coef=0.01, lr=3e-3, max_grad_norm=0.5,
              log_std_floor=None)
    layout = networks.Layout(d, A)
    net = _flat(params)
    opt = ppo.AdamState(torch.tensor(3, dtype=torch.int32), 1e-3 * net.sin(), 1e-4 * net.cos() ** 2)
    out = pu.ppo_update(pl.stack_batch(*(torch.from_numpy(x) for x in batch)),
                        torch.from_numpy(adv_stats), torch.from_numpy(perm), net, opt, None,
                        d=d, adim=A, compute_dtype=BF16, **kw)

    def pack(flat):
        tree = layout.unflatten(flat)
        tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
        layers, wo, bo = jnet.fused_weights(tree)
        (w1, b1), (w2, b2) = layers
        return pallas_ppo_update.pack_plane(w1, b1, w2, b2, wo, bo, tree["log_std"], d, A, 128)

    def unpack(plane):
        return _flat(jppo._unfuse_grads(pallas_ppo_update.unpack_plane(plane, d, A, 128), 64,
                                        A)).numpy()

    with pltpu.force_tpu_interpret_mode():
        pk, mu, nu, j_m = pallas_ppo_update.ppo_update_pallas(
            pallas_ppo.stack_batch(*(jnp.asarray(x) for x in batch)), jnp.asarray(adv_stats),
            jnp.asarray(perm), jnp.asarray(3, jnp.int32), pack(net), pack(opt.mu), pack(opt.nu),
            d=d, adim=A, h2dim=128, compute_dtype=BF16, **kw)
    assert int(out.opt_state.count) == 3 + epochs * minibatches
    # What the update moved, and the moments, against the JAX kernel's.
    _vec_close((out.params - net).numpy(), unpack(pk) - net.numpy(), "param step")
    _vec_close(out.opt_state.mu.numpy(), unpack(mu), "adam mu")
    _vec_close(out.opt_state.nu.numpy(), unpack(nu), "adam nu")
    for name in ("pg_loss", "v_loss", "approx_kl", "clip_frac", "entropy"):
        np.testing.assert_allclose(float(out.metrics[name]), float(j_m[name]), **METRIC_TOL,
                                   err_msg=name)


def _k2_setup(sigma_zero, batch=64):
    """tests/test_torch_ppo_rollout.py's inputs, at compute_dtype bf16."""
    env = reinmav_tpu.make("quadrotor3d-v0")
    cfg = jppo.PpoConfig(num_envs=batch, rollout_len=8, hidden=(64, 64), fused_rollout="on",
                         compute_dtype=BF16)
    params = _params(30, env.obs_dim)
    if sigma_zero:
        params["log_std"] = jnp.full_like(params["log_std"], -40.0)
    states = env.vreset(jax.random.split(jax.random.PRNGKey(1), batch)).astype(jnp.float32)
    d = env.obs_dim
    obs_norm = jppo.ObsNorm(jnp.linspace(-0.1, 0.1, d).astype(jnp.float32),
                            jnp.linspace(0.5, 2.0, d).astype(jnp.float32),
                            jnp.asarray(100.0, jnp.float32))
    ret_norm = jppo.RetNorm(jnp.asarray(4.0, jnp.float32), jnp.asarray(100.0, jnp.float32))
    rets = jnp.linspace(-1.0, 1.0, batch).astype(jnp.float32)
    return env, cfg, params, states, obs_norm, ret_norm, rets


def _k2_port(cfg, params, states, obs_norm, ret_norm, rets, seed=7):
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    launches = pr.ppo_rollout.launches
    out = ppo.collect_rollout_kernel(
        reinmav_tpu_torch.make("quadrotor3d-v0"), ppo.PpoConfig(**cfg._asdict()), _flat(params),
        ppo.ObsNorm(t(obs_norm.mean), t(obs_norm.var), t(obs_norm.count)),
        ppo.RetNorm(t(ret_norm.var), t(ret_norm.count)), t(states), t(rets), seed)
    assert pr.ppo_rollout.launches == launches  # the CPU ran the twin
    return out


def test_k2_bf16_twin_sigma_zero_matches_the_jax_kernel():
    env, cfg, params, states, obs_norm, ret_norm, rets = _k2_setup(sigma_zero=True)
    port = _k2_port(cfg, params, states, obs_norm, ret_norm, rets)
    assert not bool(port.traj.done.any()), "an env reset: the reset streams are not comparable"
    with pltpu.force_tpu_interpret_mode():
        f_s, r_s, _, traj, om, rm, rr = jppo._collect_rollout_pallas(
            env, cfg, params, obs_norm, ret_norm, states, rets, jax.random.PRNGKey(7))
    for name in ("obs", "action", "log_prob", "value", "reward"):
        _rows_close(getattr(port.traj, name).numpy(), getattr(traj, name), name)
    _rows_close(port.final_states.numpy(), f_s, "final_states")
    _rows_close(port.env_returns.numpy(), r_s, "env_returns")
    for got, ref, name in ((port.obs_moments, om, "obs moments"),
                           (port.ret_moments, rm, "return moments")):
        np.testing.assert_allclose(got.total.numpy(), _f32(ref.total), rtol=2e-3, atol=2e-2,
                                   err_msg=name)
    np.testing.assert_allclose(float(port.raw_reward_mean), float(rr), rtol=2e-3, err_msg="reward")
    f32 = _k2_port(cfg._replace(compute_dtype="float32"), params, states, obs_norm, ret_norm, rets)
    assert not torch.equal(f32.traj.value, port.traj.value)  # the bf16 products were taken


def test_k2_bf16_twin_stochastic_policy_is_the_jax_bf16_policy():
    """Noise on: on lanes that never reset, each stored logp and value is
    the JAX bf16 policy's (networks.apply_t with jnp.bfloat16) on the
    stored obs and action."""
    env, cfg, params, states, obs_norm, ret_norm, rets = _k2_setup(sigma_zero=False)
    port = _k2_port(cfg, params, states, obs_norm, ret_norm, rets)
    live = ~port.traj.done.numpy().any(axis=0)
    assert live.sum() >= 48, "too few lanes that never reset"
    t, d, batch = port.traj.obs.shape
    flat = lambda x: jnp.asarray(x.permute(1, 0, 2).reshape(x.shape[1], -1).numpy())  # noqa: E731
    mean, log_std, value = jnet.apply_t(params, flat(port.traj.obs), jnp.bfloat16)
    logp = jnet.gaussian_log_prob_t(mean, log_std, flat(port.traj.action))
    _rows_close(port.traj.value.numpy()[:, live], np.asarray(value).reshape(t, batch)[:, live],
                "value")
    _rows_close(port.traj.log_prob.numpy()[:, live], np.asarray(logp).reshape(t, batch)[:, live],
                "log_prob")
    assert float(port.traj.action.std()) > 0.5  # the noise reached the actions


@pytest.mark.parametrize("env_id,mode,hidden", [
    pytest.param("quadrotor3d-v0", "sac_det", (64, 64), id="quadrotor3d-v0-sac_det"),
    pytest.param("MujocoQuadForce-v1", "td3_det", (64, 64), id="MujocoQuadForce-v1-td3_det"),
    pytest.param("quadrotor3d-v0", "td3_det", (400, 300), id="quadrotor3d-v0-td3_det-400-300"),
])
def test_k7_bf16_twin_matches_the_jax_kernel(env_id, mode, hidden):
    """At 2 x 64, and at TD3's 400-300 actor, which K7's wide bf16 instance
    runs on the card."""
    env, b = reinmav_tpu.make(env_id), 128
    d, a = env.obs_dim, env.action_dim
    rng = np.random.default_rng(40)
    head = 2 * a if mode.startswith("sac") else a
    actor = [{k: _f32(v) + np.float32(0.3) * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in layer.items()}
             for layer in jsac._mlp_init(jax.random.PRNGKey(41), (d, *hidden, head))]
    states = _f32(env.vreset(jax.random.split(jax.random.PRNGKey(42), b)))
    if env_id == "MujocoQuadForce-v1":
        states[:, 2] = rng.uniform(0.35, 1.0, b)
    consts = jsac._collect_consts(env, jnp.asarray(0.0, jnp.float32), 0.0)
    with pltpu.force_tpu_interpret_mode():
        _, blk = pallas_offpolicy.collect_step_pallas(
            env.name, mode, jnp.asarray(states.T.reshape(8 * d, b // 8)),
            jnp.asarray([7], jnp.int32), consts, pallas_ppo_rollout.env_params_vec(env),
            *pallas_offpolicy.actor_kernel_args(actor), tile=jsac._collect_tile(b),
            compute_dtype=BF16)
    blk = np.asarray(blk).reshape(2 * d + a + 2, b)
    penv = reinmav_tpu_torch.make(env_id)
    weights = offpolicy.actor_kernel_args(
        [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in actor])
    args = (env_id, mode, torch.from_numpy(states.T.copy()), 7,
            sac.collect_consts(penv, torch.tensor(False), 0.0), pr.env_params_vec(penv), *weights)
    launches = offpolicy.collect_step.launches
    _, block = offpolicy.collect_step(*args, compute_dtype=BF16)
    assert offpolicy.collect_step.launches == launches  # the CPU ran the twin
    block = block.numpy()
    np.testing.assert_array_equal(block[:d], states.T)
    _rows_close(block[d:d + a], blk[d:d + a], "action rows")
    # The env's response to each side's own action: the twin's rows after
    # the action are the JAX env step of the twin's action.
    # One jitted program (eagerly, JAX compiles each primitive apart).
    out = jax.jit(lambda s_t, a_t: jsac._autoreset_dense8(
        env, s_t, jsac._scale_action_t(env, a_t), jax.random.PRNGKey(5)))(
        jnp.asarray(states.T), jnp.asarray(block[d:d + a]))
    np.testing.assert_allclose(block[d + a], np.asarray(out.reward), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(block[d + a + 1:2 * d + a + 1], np.asarray(out.obs), rtol=1e-5,
                               atol=1e-5)
    _, f32 = offpolicy.collect_step(*args)
    assert not np.array_equal(f32.numpy()[d:d + a], block[d:d + a])  # the bf16 products
