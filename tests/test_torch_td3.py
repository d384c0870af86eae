"""The port's TD3 and DDPG learners (reinmav_tpu_torch.rl.td3) against the
JAX package's (reinmav_tpu.rl.td3), on the CPU.

Losses, gradients and updates are held in float64 at rtol 1e-10 (atol
1e-12), with the same inputs made from a numpy seed and the same draws on
both sides (the fixture ``f64_dots`` of tests/test_torch_sac.py lifts the
JAX package's float32 matmul results for float64 inputs).  The JAX
``critic_loss`` draws its smoothing noise inside, from its key; the port's
key-free core takes those very draws.  The smoothing std and clip are
0.25 and 0.375 here: the JAX package scales and clips the float32 draws in
float32, which is exact for these two.

DDPG is TD3 with ``single_critic``, ``policy_noise=0``, ``noise_clip=0``
and ``policy_delay=1`` (the CLI's ``--alg=ddpg``); its critic vector holds
``q1`` alone, as the JAX state's ``q2`` slots are None.
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
from reinmav_tpu.rl import td3 as jtd3
from reinmav_tpu_torch.rl import ppo, td3
from test_torch_sac import (HIDDEN, _close, _iteration_keys, _jax_state_f64, _layers_t,  # noqa: F401
                            _normal, _t, _uniform, f64_dots)

ALGS = {
    "td3": dict(policy_noise=0.25, noise_clip=0.375),
    "ddpg": dict(single_critic=True, policy_noise=0.0, noise_clip=0.0, policy_delay=1),
}


def _jcfg(alg, **kw):
    return jtd3.Td3Config(**{**ALGS[alg], **kw})


def _perturbed(rng, tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64) + 0.3 * rng.standard_normal(x.shape),
                        tree)


@pytest.mark.parametrize("alg", sorted(ALGS))
def test_critic_and_actor_losses_match_jax(f64_dots, alg):
    rng = np.random.default_rng(10 if alg == "td3" else 11)
    env_id = "quadrotor3d-v0" if alg == "td3" else "MujocoQuadForce-v1"
    env, penv = reinmav_tpu.make(env_id), reinmav_tpu_torch.make(env_id)
    d, a, batch = env.obs_dim, env.action_dim, 128
    jcfg = _jcfg(alg, hidden=HIDDEN, reward_scale=1.5, gamma=0.97)
    pcfg = td3.Td3Config(**jcfg._asdict())
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    ka, k1, k2 = jax.random.split(key, 3)
    dims = (d + a, *HIDDEN, 1)
    actor = _perturbed(rng, jsac._mlp_init(ka, (d, *HIDDEN, a)))
    q1, q2 = _perturbed(rng, jsac._mlp_init(k1, dims)), _perturbed(rng, jsac._mlp_init(k2, dims))
    q1t, q2t = _perturbed(rng, q1), _perturbed(rng, q2)
    if alg == "ddpg":
        q2 = q2t = None
    rows = rng.standard_normal((2 * d + a + 2, batch))
    rows[d:d + a] = np.tanh(rows[d:d + a])
    rows[2 * d + a + 1] = rng.random(batch) < 0.2
    k_tgt = jax.random.PRNGKey(7)

    qd = jtd3._qdict(jcfg, q1, q2)
    (ref, ref_aux), ref_g = jax.value_and_grad(jtd3.critic_loss, has_aux=True)(
        qd, jcfg, env, jnp.asarray(rows), (q1t, q2t), k_tgt, actor)
    la, lq = td3.layouts(penv, pcfg)
    names = ("q1",) if alg == "ddpg" else ("q1", "q2")
    flat = lq.flatten(*(qd[n] for n in names), dtype=torch.float64).requires_grad_(True)
    targets = {"q1": _layers_t(q1t)} if alg == "ddpg" else {"q1": _layers_t(q1t),
                                                            "q2": _layers_t(q2t)}
    loss, aux = td3._critic_loss_noise(td3.qdict(pcfg, lq, flat), pcfg, penv, _t(rows), targets,
                                       _normal(k_tgt, a, batch), _layers_t(actor))
    assert set(td3.qdict(pcfg, lq, flat)) == set(names)
    (grad,) = torch.autograd.grad(loss, flat)
    _close(loss.item(), ref, f"{alg} critic loss")
    for g, r, name in zip(aux, ref_aux, ("q_mean", "target_mean")):
        _close(g.item(), r, name)
    _close(grad, lq.flatten(*(ref_g[n] for n in names), dtype=torch.float64), f"{alg} critic grads")

    ref_pi, ref_pg = jax.value_and_grad(jtd3.actor_loss)(actor, env, jnp.asarray(rows), q1)
    a_flat = la.flatten(actor, dtype=torch.float64).requires_grad_(True)
    pi = td3.actor_loss(la.layers(a_flat), penv, _t(rows), _layers_t(q1))
    (pg,) = torch.autograd.grad(pi, a_flat)
    _close(pi.item(), ref_pi, f"{alg} actor loss")
    _close(pg, la.flatten(ref_pg, dtype=torch.float64), f"{alg} actor grads")
    _close(td3.actor_action_t(_layers_t(actor), _t(rows[:d])),
           jtd3.actor_action_t(actor, jnp.asarray(rows[:d])), "actor_action_t")


@pytest.mark.parametrize("alg,max_grad_norm", [("td3", None), ("td3", 0.5), ("ddpg", None)],
                         ids=["td3-adam", "td3-clip", "ddpg-adam"])
def test_update_step_matches_jax_train_iters(f64_dots, alg, max_grad_norm):
    """Two JAX iterations of three updates each, the first gated by the
    warmup (nothing moves), the second open: with policy_delay 2 the actor,
    its optimiser and the targets move on the second update only (DDPG:
    on each).  The port's update_step from the carried state must land on
    the same params, targets, Adam counts and moments, update counter and
    metrics."""
    env, penv = reinmav_tpu.make("quadrotor3d-v0"), reinmav_tpu_torch.make("quadrotor3d-v0")
    n, batch, steps = 64, 48, 3
    jcfg = _jcfg(alg, num_envs=n, batch_size=batch, buffer_capacity=256, hidden=HIDDEN,
                 grad_steps=steps, warmup_steps=2 * n, fused_collect="off",
                 max_grad_norm=max_grad_norm, tau=0.05, learning_rate=1e-3)
    jstate = _jax_state_f64(jtd3, env, jcfg, seed=6)
    after, jmet = jtd3.train_iters(env, jcfg, jstate, 2)

    pcfg = td3.Td3Config(**jcfg._asdict())
    state = td3.state_from_jax(penv, pcfg, jax.tree.map(np.asarray, jstate), dtype=torch.float64)
    nets = td3.Nets(state.actor, state.actor_target, state.critics, state.critics_target,
                    state.opt_actor, state.opt_q, state.updates)
    ring = torch.from_numpy(np.array(after.buffer))
    key, per_iter = jstate.key, []
    for it in (1, 2):
        key, update_keys = _iteration_keys(key, steps, 2)
        filled, ready = torch.tensor(min(it * n, 256)), torch.tensor(it * n >= jcfg.warmup_steps)
        mets = []
        for k_s, k_tgt in update_keys:
            before = nets
            nets, m = td3.update_step(penv, pcfg, nets, ring, filled, ready,
                                      td3.Draws(_uniform(k_s, batch), _normal(k_tgt, 4, batch)))
            mets.append(m)
            if not bool(ready):
                for x, y in zip(nets, before):
                    for u, v in zip(x if isinstance(x, tuple) else (x,),
                                    y if isinstance(y, tuple) else (y,)):
                        assert torch.equal(u, v), "a gated update moved the state"
        per_iter.append({k: torch.stack([m[k] for m in mets]).mean() * float(ready)
                         for k in mets[0]})

    la, lq = td3.layouts(penv, pcfg)
    names = ("q1",) if alg == "ddpg" else ("q1", "q2")
    f64 = dict(dtype=torch.float64)
    _close(nets.actor, la.flatten(after.actor, **f64), "actor")
    _close(nets.actor_target, la.flatten(after.actor_target, **f64), "actor target")
    _close(nets.critics, lq.flatten(*(getattr(after, n) for n in names), **f64), "critics")
    _close(nets.critics_target, lq.flatten(*(getattr(after, f"{n}_target") for n in names), **f64),
           "critic targets")
    assert int(nets.updates) == int(after.updates) == steps
    for name, got, ref, flat in (
            ("actor", nets.opt_actor, after.opt_actor, lambda t: la.flatten(t, **f64)),
            ("critics", nets.opt_q, after.opt_q, lambda t: lq.flatten(*(t[n] for n in names), **f64))):
        want = ppo.adam_from_jax(jax.tree.map(np.asarray, ref), flat, dtype=torch.float64)
        assert int(got.count) == int(want.count), name
        _close(got.mu, want.mu, f"{name} mu")
        _close(got.nu, want.nu, f"{name} nu")
    assert int(nets.opt_q.count) == steps
    assert int(nets.opt_actor.count) == (steps if alg == "ddpg" else 1)
    for k in per_iter[0]:
        _close(float(per_iter[0][k] + per_iter[1][k]), float(jmet[k]), k)


@pytest.mark.parametrize("alg", sorted(ALGS))
def test_state_from_jax_and_greedy_action_match(f64_dots, alg):
    env, penv = reinmav_tpu.make("MujocoQuadForce-v1"), reinmav_tpu_torch.make("MujocoQuadForce-v1")
    jcfg = _jcfg(alg, num_envs=16, batch_size=16, buffer_capacity=64, hidden=HIDDEN)
    jstate = _jax_state_f64(jtd3, env, jcfg, seed=8)
    pcfg = td3.Td3Config(**jcfg._asdict())
    state = td3.state_from_jax(penv, pcfg, jstate, dtype=torch.float64)
    obs = np.asarray(jstate.env_states)
    ref = jtd3.greedy_action(env, jstate.actor, jnp.asarray(obs))
    _close(td3.greedy_action(penv, state.actor, _t(obs), HIDDEN), ref, "greedy batch")
    _close(td3.greedy_action(penv, state.actor, _t(obs[5]), HIDDEN), ref[5], "greedy single")
    copies = 1 if alg == "ddpg" else 2
    _, lq = td3.layouts(penv, pcfg)
    assert lq.copies == copies and state.critics.shape == (lq.size,)
    assert state.opt_q.mu.shape == state.critics.shape and int(state.updates) == 0
    assert torch.equal(state.actor, state.actor_target)


def test_config_defaults_match_jax():
    assert td3.Td3Config()._asdict() == jtd3.Td3Config()._asdict()
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = td3.Td3Config(num_envs=16, batch_size=16, buffer_capacity=64, hidden=(8, 8))
    state = td3.init_state(env, cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        td3.train_iters(env, cfg._replace(compute_dtype="bfloat16"), state, 1)


@pytest.mark.parametrize("alg,env_id,fused", [("td3", "quadrotor3d-v0", "on"),
                                              ("ddpg", "MujocoQuadForce-v1", "on"),
                                              ("td3", "MujocoQuadForce-v1", "off")])
def test_train_iters_integration(alg, env_id, fused, caplog):
    """Four iterations on the CPU (K7's twin in td3 mode with "on", the
    eager collection with "off"): finite losses, the ring advancing, the
    actor moving once the gate opens, the path logged."""
    env = reinmav_tpu_torch.make(env_id)
    cfg = td3.Td3Config(**ALGS[alg], num_envs=64, batch_size=64, buffer_capacity=1024,
                        warmup_steps=128, hidden=HIDDEN, fused_collect=fused)
    state = td3.init_state(env, cfg, 0, device="cpu")
    actor0 = state.actor.clone()
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.rl.td3"):
        state, met = td3.train_iters(env, cfg, state, 1)
        assert torch.equal(state.actor, actor0) and met["q_loss"] == 0.0
        state, met = td3.train_iters(env, cfg, state, 3)
    assert f"{alg}.train_iters" in caplog.text
    assert ("K7 plain twin" if fused == "on" else "eager, K7 off") in caplog.text
    assert int(state.filled) == int(state.ptr) == 4 * 64 and int(state.total_steps) == 256
    assert all(math.isfinite(v) for v in met.values()), met
    assert not torch.equal(state.actor, actor0)
    assert int(state.updates) == 3 and int(state.opt_q.count) == 3
    assert int(state.opt_actor.count) == (3 if alg == "ddpg" else 1)
    assert torch.count_nonzero(state.buffer[:, :256].abs().sum(0)) == 256
