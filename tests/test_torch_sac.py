"""The port's SAC learner (reinmav_tpu_torch.rl.sac) against the JAX
package's (reinmav_tpu.rl.sac), on the CPU.

Networks, losses and updates are held in float64 at rtol 1e-10 (atol
1e-12), with the same inputs made from a numpy seed and the same draws
injected on both sides.  The JAX package asks its matmuls for float32
results (``preferred_element_type``); the fixture ``f64_dots`` lifts that
for float64 inputs, so that both sides compute in float64.  Nothing in
the JAX package changes.

One update is held against the JAX ``train_iters`` itself: two
iterations (the first gated by the warmup, the second open, two updates
each) from a JAX state carried across by ``state_from_jax``, the port's
:func:`update_step` fed the JAX run's ring and the draws its keys make.
"""

import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.rl import sac as jsac
from reinmav_tpu_torch.rl import ppo, sac

RTOL, ATOL = 1e-10, 1e-12
HIDDEN = (32, 32)


@pytest.fixture
def f64_dots(monkeypatch):
    """JAX matmuls of float64 inputs return float64 (the JAX package asks
    for float32 results, a TPU choice)."""
    orig = jax.lax.dot_general

    def dot_general(lhs, rhs, dimension_numbers, precision=None, preferred_element_type=None,
                    **kw):
        if jnp.result_type(lhs, rhs) == jnp.float64:
            preferred_element_type = None
        return orig(lhs, rhs, dimension_numbers, precision=precision,
                    preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jax.lax, "dot_general", dot_general)


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _layers_t(tree):
    """A JAX layer list as float64 tensors."""
    return [{k: _t(v) for k, v in layer.items()} for layer in tree]


def _jax_f64(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _nets(rng, d, a, batch):
    """Random SAC nets (JAX layer lists, float64) and a replay batch."""
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    actor, q1, q2 = jsac.init_sac_params(key, d, a, HIDDEN)
    # Move the heads off their 0.01 init, so that every term matters.
    perturb = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(x, jnp.float64) + 0.3 * rng.standard_normal(x.shape), t)
    actor, q1, q2 = perturb(actor), perturb(q1), perturb(q2)
    q1t, q2t = perturb(q1), perturb(q2)
    rows = rng.standard_normal((2 * d + a + 2, batch))
    rows[d:d + a] = np.tanh(rows[d:d + a])
    rows[2 * d + a + 1] = rng.random(batch) < 0.2
    return actor, q1, q2, q1t, q2t, rows


def test_networks_match_jax(f64_dots):
    rng = np.random.default_rng(0)
    env = reinmav_tpu.make("MujocoQuadForce-v1")
    d, a = env.obs_dim, env.action_dim
    actor, q1, q2, _, _, rows = _nets(rng, d, a, 96)
    obs, act = rows[:d], rows[d:d + a]
    ref = jsac.twin_q_value_t(q1, q2, jnp.asarray(obs), jnp.asarray(act))
    got = sac.twin_q_value_t(_layers_t(q1), _layers_t(q2), _t(obs), _t(act))
    for g, r, name in zip(got, ref, ("q1", "q2")):
        _close(g, r, f"twin {name}")
    _close(sac.q_value_t(_layers_t(q1), _t(obs), _t(act)),
           jsac.q_value_t(q1, jnp.asarray(obs), jnp.asarray(act)), "q_value_t")
    # The head pushed far out, so that log_std clips at both ends and the
    # squash's softplus sees large |u|.
    actor[-1]["b"] = jnp.asarray(np.concatenate([rng.standard_normal(a) * 6.0,
                                                 [-30.0, 5.0, 0.0, -1.0]]))
    eps = rng.standard_normal((a, 96))
    ref_a, ref_lp = jsac.sample_squashed_eps_t(actor, jnp.asarray(obs), jnp.asarray(eps), a)
    got_a, got_lp = sac.sample_squashed_eps_t(_layers_t(actor), _t(obs), _t(eps), a)
    _close(got_a, ref_a, "squashed action")
    _close(got_lp, ref_lp, "log_prob")
    mean, log_std = sac.actor_dist_t(_layers_t(actor), _t(obs), a)
    assert float(log_std.min()) == -20.0 and float(log_std.max()) == 2.0


def test_critic_loss_and_grads_match_jax(f64_dots):
    rng = np.random.default_rng(1)
    env = reinmav_tpu.make("quadrotor3d-v0")
    d, a = env.obs_dim, env.action_dim
    actor, q1, q2, q1t, q2t, rows = _nets(rng, d, a, 128)
    eps = rng.standard_normal((a, 128))
    log_alpha = jnp.asarray(-0.7, jnp.float64)
    cfg = jsac.SacConfig(reward_scale=1.5, gamma=0.97)
    (ref, ref_aux), ref_g = jax.value_and_grad(jsac._critic_loss_eps, has_aux=True)(
        {"q1": q1, "q2": q2}, cfg, env, jnp.asarray(rows), (q1t, q2t), jnp.asarray(eps), actor,
        log_alpha)

    pcfg = sac.SacConfig(reward_scale=1.5, gamma=0.97)
    lq = sac.critic_layout(reinmav_tpu_torch.make("quadrotor3d-v0"), HIDDEN)
    flat = lq.flatten(q1, q2, dtype=torch.float64).requires_grad_(True)
    loss, aux = sac._critic_loss_eps(
        {"q1": lq.layers(flat, 0), "q2": lq.layers(flat, 1)}, pcfg, env, _t(rows),
        (_layers_t(q1t), _layers_t(q2t)), _t(eps), _layers_t(actor), _t(log_alpha))
    (grad,) = torch.autograd.grad(loss, flat)
    _close(loss.item(), ref, "critic loss")
    for g, r, name in zip(aux, ref_aux, ("q_mean", "target_mean")):
        _close(g.item(), r, name)
    _close(grad, lq.flatten(ref_g["q1"], ref_g["q2"], dtype=torch.float64), "critic grads")


def test_actor_alpha_loss_and_grads_match_jax(f64_dots):
    rng = np.random.default_rng(2)
    env = reinmav_tpu.make("MujocoQuadForce-v1")
    d, a = env.obs_dim, env.action_dim
    actor, q1, q2, _, _, rows = _nets(rng, d, a, 128)
    eps = rng.standard_normal((a, 128))
    log_alpha = jnp.asarray(0.4, jnp.float64)
    (ref, ref_aux), ref_g = jax.value_and_grad(jsac._actor_alpha_loss_eps, has_aux=True)(
        {"actor": actor, "log_alpha": log_alpha}, jsac.SacConfig(), env, jnp.asarray(rows), q1, q2,
        jnp.asarray(eps), -4.0)

    la = sac.actor_layout(env, HIDDEN, 2 * a)
    flat = la.flatten(actor, dtype=torch.float64).requires_grad_(True)
    la_t = _t(log_alpha).requires_grad_(True)
    loss, aux = sac._actor_alpha_loss_eps({"actor": la.layers(flat), "log_alpha": la_t},
                                          sac.SacConfig(), env, _t(rows), _layers_t(q1),
                                          _layers_t(q2), _t(eps), -4.0)
    g_actor, g_alpha = torch.autograd.grad(loss, (flat, la_t))
    _close(loss.item(), ref, "actor+alpha loss")
    for g, r, name in zip(aux, ref_aux, ("pi_loss", "entropy", "alpha")):
        _close(g.item(), r, name)
    _close(g_actor, la.flatten(ref_g["actor"], dtype=torch.float64), "actor grads")
    _close(g_alpha.item(), ref_g["log_alpha"], "log_alpha grad")


def _jax_state_f64(module, env, cfg, seed):
    """A JAX state with every float leaf in float64, the ring included
    (the JAX package computes ``gamma * (1 - done)`` in the ring's dtype)."""
    return _jax_f64(module.init_state(env, cfg, jax.random.PRNGKey(seed)))


def _iteration_keys(key, grad_steps, n_keys):
    """The keys one JAX iteration draws its updates from (sac.py:615 /
    td3.py:228): the carried key, then each update's split."""
    key, _, _, _, k_loop = jax.random.split(key, 5)
    return key, [jax.random.split(k, n_keys) for k in jax.random.split(k_loop, grad_steps)]


def _normal(k, a, batch):
    return _t(jax.random.normal(k, (a, batch), jnp.float32))


def _uniform(k, n):
    return torch.from_numpy(np.array(jax.random.uniform(k, (n,), jnp.float32)))


@pytest.mark.parametrize("max_grad_norm", [None, 0.5], ids=["adam", "clip"])
def test_update_step_matches_jax_train_iters(f64_dots, max_grad_norm):
    """Two JAX iterations of two updates each, the first gated by the
    warmup (params and the optimiser state must not move), the second
    open; the port's update_step from the carried state must land on the
    same params, Adam counts and moments, targets and metrics."""
    env = reinmav_tpu.make("quadrotor3d-v0")
    n, batch = 64, 48
    jcfg = jsac.SacConfig(num_envs=n, batch_size=batch, buffer_capacity=256, hidden=HIDDEN,
                          grad_steps=2, warmup_steps=2 * n, fused_collect="off",
                          max_grad_norm=max_grad_norm, tau=0.05, learning_rate=1e-3)
    jstate = _jax_state_f64(jsac, env, jcfg, seed=3)
    after, jmet = jsac.train_iters(env, jcfg, jstate, 2)

    pcfg = sac.SacConfig(**jcfg._asdict())
    penv = reinmav_tpu_torch.make("quadrotor3d-v0")
    state = sac.state_from_jax(penv, pcfg, jax.tree.map(np.asarray, jstate), dtype=torch.float64)
    nets = sac.Nets(state.actor, state.critics, state.critics_target, state.log_alpha,
                    state.opt_actor, state.opt_q, state.opt_alpha)
    ring = torch.from_numpy(np.array(after.buffer))
    key, gates, per_iter = jstate.key, [], []
    for it in (1, 2):
        key, update_keys = _iteration_keys(key, jcfg.grad_steps, 3)
        filled = torch.tensor(min(it * n, 256))
        ready = torch.tensor(it * n >= jcfg.warmup_steps)
        mets = []
        for k_s, k_tgt, k_pi in update_keys:
            draws = sac.Draws(_uniform(k_s, batch), _normal(k_tgt, 4, batch),
                              _normal(k_pi, 4, batch))
            before = nets
            nets, m = sac.update_step(penv, pcfg, nets, ring, filled, ready, draws)
            mets.append(m)
            if not bool(ready):
                for x, y in zip(nets, before):
                    for u, v in zip(x if isinstance(x, tuple) else (x,),
                                    y if isinstance(y, tuple) else (y,)):
                        assert torch.equal(u, v), "a gated update moved the state"
        gates.append(bool(ready))
        per_iter.append({k: torch.stack([m[k] for m in mets]).mean() * float(ready)
                         for k in mets[0]})
    assert gates == [False, True]

    la, lq = sac._sac_layouts(penv, pcfg)
    _close(nets.actor, la.flatten(after.actor, dtype=torch.float64), "actor")
    _close(nets.critics, lq.flatten(after.q1, after.q2, dtype=torch.float64), "critics")
    _close(nets.critics_target, lq.flatten(after.q1_target, after.q2_target,
                                           dtype=torch.float64), "targets")
    _close(nets.log_alpha, after.log_alpha, "log_alpha")
    for name, got, ref, flat in (
            ("actor", nets.opt_actor, after.opt_actor, lambda t: la.flatten(t, dtype=torch.float64)),
            ("critics", nets.opt_q, after.opt_q,
             lambda t: lq.flatten(t["q1"], t["q2"], dtype=torch.float64)),
            ("alpha", nets.opt_alpha, after.opt_alpha, lambda t: _t(t))):
        want = ppo.adam_from_jax(jax.tree.map(np.asarray, ref), flat, dtype=torch.float64)
        assert int(got.count) == int(want.count) == 2, name
        _close(got.mu, want.mu, f"{name} mu")
        _close(got.nu, want.nu, f"{name} nu")
    for k in per_iter[0]:
        _close(float((per_iter[0][k] + per_iter[1][k]) / 1.0), float(jmet[k]), k)


def test_buffer_insert_and_sample_match_jax():
    rng = np.random.default_rng(4)
    r, n, cap = 5, 8, 24
    jbuf, jptr, jfil = jnp.zeros((r, cap), jnp.float32), jnp.int32(0), jnp.int32(0)
    buf, ptr, fil = torch.zeros((r, cap)), torch.tensor(0), torch.tensor(0)
    for _ in range(5):  # wraps twice, saturates at cap
        block = rng.standard_normal((r, n)).astype(np.float32)
        jbuf, jptr, jfil = jsac.buffer_insert(jbuf, jptr, jfil, jnp.asarray(block))
        buf, ptr, fil = sac.buffer_insert(buf, ptr, fil, torch.from_numpy(block))
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        assert (int(ptr), int(fil)) == (int(jptr), int(jfil))
    assert int(fil) == cap
    for filled, tile in ((cap, 1), (13, 1), (cap, 4), (9, 4), (3, 4)):
        key = jax.random.PRNGKey(filled * 10 + tile)
        ref = jsac.buffer_sample(jbuf, jnp.int32(filled), key, 16, tile=tile)
        u = _uniform(key, 16 // tile)
        got = sac.buffer_sample(buf, torch.tensor(filled), u, 16, tile)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"{filled} {tile}")


def test_state_from_jax_and_greedy_action_match(f64_dots):
    env = reinmav_tpu.make("quadrotor3d-v0")
    jcfg = jsac.SacConfig(num_envs=16, batch_size=16, buffer_capacity=64, hidden=HIDDEN)
    jstate = _jax_state_f64(jsac, env, jcfg, seed=5)
    penv = reinmav_tpu_torch.make("quadrotor3d-v0")
    state = sac.state_from_jax(penv, sac.SacConfig(**jcfg._asdict()), jstate, dtype=torch.float64)
    obs = np.asarray(jstate.env_states)
    ref = jsac.greedy_action(env, jstate.actor, jnp.asarray(obs))
    _close(sac.greedy_action(penv, state.actor, _t(obs), HIDDEN), ref, "greedy batch")
    _close(sac.greedy_action(penv, state.actor, _t(obs[3]), HIDDEN), ref[3], "greedy single")
    assert state.buffer.dtype == torch.float32 and state.buffer.shape == (2 * 10 + 4 + 2, 64)
    assert int(state.opt_q.count) == 0 and state.opt_q.mu.shape == state.critics.shape


def test_config_defaults_match_jax_and_bf16_raises():
    assert sac.SacConfig()._asdict() == jsac.SacConfig()._asdict()
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = sac.SacConfig(num_envs=16, batch_size=16, buffer_capacity=64, hidden=(8, 8))
    state = sac.init_state(env, cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        sac.train_iters(env, cfg._replace(compute_dtype="bfloat16"), state, 1)
    with pytest.raises(ValueError, match="too small"):
        sac.init_state(env, cfg._replace(buffer_capacity=8), device="cpu")


@pytest.mark.parametrize("env_id,fused", [("quadrotor3d-v0", "on"), ("MujocoQuadForce-v1", "on"),
                                          ("MujocoQuadForce-v1", "off")])
def test_train_iters_integration(env_id, fused, caplog):
    """Four iterations on the CPU (K7's twin with "on", the eager collection
    with "off"): finite losses, the ring advancing, params moving once the
    gate opens, the path logged."""
    env = reinmav_tpu_torch.make(env_id)
    cfg = sac.SacConfig(num_envs=64, batch_size=64, buffer_capacity=1024, warmup_steps=128,
                        hidden=HIDDEN, fused_collect=fused)
    state = sac.init_state(env, cfg, 0, device="cpu")
    actor0 = state.actor.clone()
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.rl.sac"):
        state, met = sac.train_iters(env, cfg, state, 1)
    assert torch.equal(state.actor, actor0) and met["q_loss"] == 0.0
    state, met = sac.train_iters(env, cfg, state, 3)
    assert ("K7 plain twin" if fused == "on" else "eager, K7 off") in caplog.text
    assert int(state.filled) == int(state.ptr) == 4 * 64 and int(state.total_steps) == 256
    assert all(math.isfinite(v) for v in met.values()), met
    assert not torch.equal(state.actor, actor0)
    assert int(state.opt_actor.count) == 3 and state.env_states.shape == (64, env.state_dim)
    assert torch.count_nonzero(state.buffer[:, :256].abs().sum(0)) == 256
