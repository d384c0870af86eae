"""The port's GRU learner (reinmav_tpu_torch.rl.recurrent) against the JAX
package's (reinmav_tpu.rl.recurrent), on the CPU in float64 (the suite's
JAX x64).

The pieces (``gru_cell``, ``policy_step``, ``compute_gae``, ``_loss`` and
its gradient against ``jax.value_and_grad``) take the JAX params carried
across and agree at rtol 1e-12 / atol 1e-14 (the gradient 1e-10 /
1e-12).  One whole ``train_step`` on quadrotor2d-v0 (16 envs x 8 steps,
widths 8, 4 epochs x 4 minibatches) takes the JAX draws: the action noise
and the reset states from the JAX key stream of ``collect`` (the resets
through an env whose ``reset_fn`` replays them), the epoch permutations
from the JAX keys.  Params and both Adam moments agree at rtol 1e-8 /
atol 1e-12, the trajectory's metrics likewise; envs end inside the window,
so the done masks are exercised.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.rl import recurrent as jrec
from reinmav_tpu_torch.rl import recurrent as rec

ENV_ID = "quadrotor2d-v0"
TIGHT = dict(rtol=1e-12, atol=1e-14)
GRAD = dict(rtol=1e-10, atol=1e-12)
STEP = dict(rtol=1e-8, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**kw):
    base = dict(num_envs=16, rollout_len=8, hidden=8, embed=8, learning_rate=1e-3,
                entropy_coef=0.01)
    base.update(kw)
    return base


def _np(x):
    return np.asarray(x, np.float64)


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _params_pair(seed=1, **kw):
    jenv = reinmav_tpu.make(ENV_ID)
    cfg = _cfg(**kw)
    jp = jrec.init_params(jax.random.PRNGKey(seed), jenv.obs_dim, jenv.action_dim,
                          jrec.RecurrentPpoConfig(**cfg))
    layout = rec.GruLayout(jenv.obs_dim, jenv.action_dim, cfg["hidden"], cfg["embed"])
    flat = rec.params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float64)
    return jp, layout, flat


def _perturbed(jp, rng):
    """The JAX params with every leaf moved (biases and log_std nonzero)."""
    return jax.tree.map(lambda x: x + 0.3 * rng.standard_normal(x.shape), jp)


def test_cell_and_policy_step_match_jax(rng):
    jp, layout, _ = _params_pair()
    jp = _perturbed(jp, rng)
    tree = layout.unflatten(rec.params_from_jax(jax.tree.map(np.asarray, jp),
                                                dtype=torch.float64))
    obs = rng.standard_normal((5, 12))
    h = rng.standard_normal((8, 12))
    x = rng.standard_normal((8, 12))
    done = (rng.random(12) < 0.5).astype(np.float64)
    np.testing.assert_allclose(rec.gru_cell(tree, _t(h), _t(x)).numpy(),
                               _np(jrec.gru_cell(jp, h, x)), **TIGHT)
    got = rec.policy_step(tree, _t(h), _t(obs), _t(done))
    ref = jrec.policy_step(jp, h, obs, done)
    for name, a, b in zip(("h", "mean", "log_std", "value"), got, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), err_msg=name, **TIGHT)


def test_compute_gae_matches_jax(rng):
    T, B = 8, 6
    traj = dict(value=rng.standard_normal((T, B)), reward=rng.standard_normal((T, B)),
                done=(rng.random((T, B)) < 0.2).astype(np.float64))
    last = rng.standard_normal(B)
    zeros = np.zeros((T, B))
    jtraj = jrec.RecurrentTraj(zeros, zeros, zeros, traj["value"], traj["reward"], traj["done"],
                               zeros)
    ptraj = rec.RecurrentTraj(*(_t(x) for x in jtraj))
    cfg = _cfg()
    adv, ret = rec.compute_gae(rec.RecurrentPpoConfig(**cfg), ptraj, _t(last))
    jadv, jret = jrec.compute_gae(jrec.RecurrentPpoConfig(**cfg), jtraj, last)
    np.testing.assert_allclose(adv.numpy(), _np(jadv), **TIGHT)
    np.testing.assert_allclose(ret.numpy(), _np(jret), **TIGHT)


def test_loss_and_gradient_match_jax_value_and_grad(rng):
    jp, layout, _ = _params_pair(seed=2)
    jp = _perturbed(jp, rng)
    flat = rec.params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float64)
    T, B = 6, 5
    mb = (rng.standard_normal((T, 5, B)), rng.standard_normal((T, 2, B)),
          rng.standard_normal((T, B)) - 3.0, rng.standard_normal((T, B)),
          rng.standard_normal((T, B)), (rng.random((T, B)) < 0.3).astype(np.float64))
    h0 = rng.standard_normal((8, B))
    cfg = _cfg()
    (jloss, jaux), jgrads = jax.value_and_grad(jrec._loss, has_aux=True)(
        jp, jrec.RecurrentPpoConfig(**cfg), mb, h0)
    grads, got = rec.minibatch_grads(layout, flat, rec.RecurrentPpoConfig(**cfg),
                                     tuple(_t(x) for x in mb), _t(h0))
    for name, a, b in zip(("loss", "pg", "v_loss", "ratio_dev"), got, (jloss, *jaux)):
        np.testing.assert_allclose(float(a), float(b), err_msg=name, **TIGHT)
    ref = rec.params_from_jax(jax.tree.map(np.asarray, jgrads), dtype=torch.float64)
    np.testing.assert_allclose(grads.numpy(), ref.numpy(), **GRAD)
    assert float(ref.abs().max()) > 1e-3  # a gradient that moves


def _jax_draws(jenv, jcfg, key):
    """The draws of the JAX ``train_step`` from ``state.key``: each step's
    action noise and reset states (``collect``'s split into k, k_act,
    k_reset), then the epochs' permutations."""
    noise, resets = [], []
    k = key
    for _ in range(jcfg.rollout_len):
        k, k_act, k_reset = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.normal(k_act, (jenv.action_dim, jcfg.num_envs),
                                                  jnp.float32)))
        resets.append(np.asarray(jenv.vreset(jax.random.split(k_reset, jcfg.num_envs))))
    _, k_epochs = jax.random.split(k)
    perms = [torch.from_numpy(np.array(jax.random.permutation(kp, jcfg.num_envs)))
             for kp in jax.random.split(k_epochs, jcfg.epochs)]
    return torch.from_numpy(np.stack(noise)), resets, perms


def _replay_resets(env, resets):
    """``env`` whose ``reset_fn`` returns the given states, one array a call."""
    pending = iter(resets)

    def reset_fn(params, generator, batch, device, dtype):
        del params, generator
        states = torch.from_numpy(np.array(next(pending)))
        assert states.shape[0] == batch
        return states.to(device=device, dtype=dtype)

    return dataclasses.replace(env, reset_fn=reset_fn)


def test_train_step_matches_jax_with_the_jax_draws():
    jenv = reinmav_tpu.make(ENV_ID)
    jcfg = jrec.RecurrentPpoConfig(**_cfg())
    jstate = jrec.init_train_state(jenv, jcfg, jax.random.PRNGKey(3))
    # Mid-run: a hidden that carries, and two envs whose episode ended.
    h = np.random.default_rng(4).standard_normal((jcfg.hidden, jcfg.num_envs)) * 0.5
    prev_done = np.zeros(jcfg.num_envs)
    prev_done[[2, 9]] = 1.0
    # Three envs near the speed limit of 2, so that episodes end in the window.
    env_states = np.array(jstate.env_states)
    env_states[[0, 5, 11], 3] = 1.97
    jstate = jstate._replace(env_states=jnp.asarray(env_states), h=jnp.asarray(h),
                             prev_done=jnp.asarray(prev_done))
    s_ref, m_ref = jax.jit(lambda s: jrec.train_step(jenv, jcfg, s))(jstate)

    noise, resets, perms = _jax_draws(jenv, jcfg, jstate.key)
    env = _replay_resets(reinmav_tpu_torch.make(ENV_ID), resets)
    cfg = rec.RecurrentPpoConfig(**_cfg())
    state = rec.RecurrentTrainState(
        rec.params_from_jax(jax.tree.map(np.asarray, jstate.params), dtype=torch.float64),
        rec.adam_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state), dtype=torch.float64),
        _t(jstate.env_states), _t(h), _t(prev_done), torch.Generator().manual_seed(0), 0)
    new, metrics = rec.train_step(env, cfg, state, noise=noise, perms=perms)

    assert 0.0 < float(m_ref["mean_episode_done_frac"]) < 1.0  # envs end in the window
    np.testing.assert_allclose(
        new.params.numpy(),
        rec.params_from_jax(jax.tree.map(np.asarray, s_ref.params), dtype=torch.float64).numpy(),
        err_msg="params", **STEP)
    adam = rec.adam_state_from_jax(jax.tree.map(np.asarray, s_ref.opt_state), dtype=torch.float64)
    assert int(new.opt_state.count) == int(adam.count) == jcfg.epochs * jcfg.num_minibatches
    np.testing.assert_allclose(new.opt_state.mu.numpy(), adam.mu.numpy(), err_msg="mu", **STEP)
    np.testing.assert_allclose(new.opt_state.nu.numpy(), adam.nu.numpy(), err_msg="nu", **STEP)
    for name, a, b in (("env_states", new.env_states, s_ref.env_states), ("h", new.h, s_ref.h),
                       ("prev_done", new.prev_done, s_ref.prev_done)):
        np.testing.assert_allclose(a.numpy(), _np(b), err_msg=name, **STEP)
    assert set(metrics) == set(m_ref) and new.update_step == 1
    for name in m_ref:
        np.testing.assert_allclose(float(metrics[name]), float(m_ref[name]), err_msg=name, **STEP)


def test_hidden_resets_on_the_boundary_and_carries_memory():
    """tests/test_recurrent.py's two checks on the port: with done_prev = 1
    the step equals a step from a zero hidden, without it the history
    matters; identical observations after different histories act
    differently."""
    env = reinmav_tpu_torch.make(ENV_ID)
    cfg = rec.RecurrentPpoConfig(**_cfg(hidden=16, embed=16))
    layout = rec.GruLayout.of(env, cfg)
    tree = layout.unflatten(rec.init_params(layout, torch.Generator().manual_seed(1),
                                            dtype=torch.float64))
    gen = torch.Generator().manual_seed(2)
    obs = torch.randn((env.obs_dim, 8), generator=gen, dtype=torch.float64)
    h_dirty = torch.randn((16, 8), generator=gen, dtype=torch.float64)
    ones, zeros = torch.ones(8, dtype=torch.float64), torch.zeros(8, dtype=torch.float64)
    _, m1, _, v1 = rec.policy_step(tree, h_dirty, obs, ones)
    _, m2, _, v2 = rec.policy_step(tree, torch.zeros_like(h_dirty), obs, zeros)
    assert torch.equal(m1, m2) and torch.equal(v1, v2)
    _, m3, _, _ = rec.policy_step(tree, h_dirty, obs, zeros)
    assert float((m3 - m1).abs().max()) > 1e-6

    h0, z4 = torch.zeros((16, 4), dtype=torch.float64), zeros[:4]
    ha, *_ = rec.policy_step(tree, h0, torch.zeros((env.obs_dim, 4), dtype=torch.float64), z4)
    hb, *_ = rec.policy_step(tree, h0, torch.full((env.obs_dim, 4), 2.0, dtype=torch.float64), z4)
    now = torch.ones((env.obs_dim, 4), dtype=torch.float64)
    _, ma, _, _ = rec.policy_step(tree, ha, now, z4)
    _, mb, _, _ = rec.policy_step(tree, hb, now, z4)
    assert float((ma - mb).abs().max()) > 1e-6


def test_train_step_is_deterministic_and_moves_the_params():
    env = reinmav_tpu_torch.make(ENV_ID)
    cfg = rec.RecurrentPpoConfig(**_cfg())
    s0 = rec.init_train_state(env, cfg, 7, device="cpu")
    s1, m1 = rec.train_step(env, cfg, rec.init_train_state(env, cfg, 7, device="cpu"))
    s2, m2 = rec.train_step(env, cfg, rec.init_train_state(env, cfg, 7, device="cpu"))
    for a, b in zip((s1.params, s1.opt_state.mu, s1.opt_state.nu, s1.env_states, s1.h),
                    (s2.params, s2.opt_state.mu, s2.opt_state.nu, s2.env_states, s2.h)):
        assert torch.equal(a, b)
    assert all(float(m1[k]) == float(m2[k]) for k in m1)
    assert all(math.isfinite(float(v)) for v in m1.values())
    assert not torch.equal(s0.params, s1.params) and s1.update_step == 1
    s3, m3 = rec.train_many(env, cfg, rec.init_train_state(env, cfg, 7, device="cpu"), 2)
    assert s3.update_step == 2 and set(m3) == set(m1)


def test_greedy_action_is_the_policy_mean():
    env = reinmav_tpu_torch.make(ENV_ID)
    cfg = rec.RecurrentPpoConfig(**_cfg())
    layout = rec.GruLayout.of(env, cfg)
    tree = layout.unflatten(rec.init_params(layout, torch.Generator().manual_seed(3),
                                            init_log_std=-0.5))
    obs = torch.randn((6, env.obs_dim), generator=torch.Generator().manual_seed(4))
    h = torch.randn((cfg.hidden, 6), generator=torch.Generator().manual_seed(5))
    done = torch.tensor([0.0, 1.0, 0.0, 0.0, 1.0, 0.0])
    a, h2 = rec.greedy_action(env, tree, h, obs, done)
    h_ref, mean, _, _ = rec.policy_step(tree, h, obs.T, done)
    assert a.shape == (6, env.action_dim) and torch.equal(a, mean.T) and torch.equal(h2, h_ref)
    a1, h1 = rec.greedy_action(env, tree, h[:, :1], obs[0], done[:1])
    assert a1.shape == (env.action_dim,) and torch.allclose(a1, a[0]) and h1.shape == (8, 1)


@pytest.mark.parametrize("dims", [(5, 2, 8, 8), (10, 4, 16, 12), (13, 4, 64, 64)])
def test_orthogonal_init_at_the_stated_gains(dims):
    layout = rec.GruLayout(*dims)
    flat = rec.init_params(layout, torch.Generator().manual_seed(0), init_log_std=-0.3,
                           dtype=torch.float64)
    tree = layout.unflatten(flat)
    for (top, leaf), gain in rec._GAINS.items():
        w = tree[top][leaf]
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(gram.shape[0]), atol=1e-12,
                                   err_msg=f"{top}.{leaf}")
    for path, _ in layout.entries:
        if path[-1].startswith("b"):
            assert not bool(tree[path[0]][path[1]].any())
    assert torch.equal(tree["log_std"], torch.full((dims[1],), -0.3, dtype=torch.float64))
    # The JAX init's leaves, in its order and shapes.
    jp = jrec.init_params(jax.random.PRNGKey(0), dims[0], dims[1], jrec.RecurrentPpoConfig(
        hidden=dims[2], embed=dims[3]))
    assert [tuple(x.shape) for x in jax.tree.leaves(jp)] == [s for _, s in layout.entries]
