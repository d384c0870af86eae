"""quadrotor2d-v0 in the PyTorch port against the JAX package, on the CPU.

- The env (``reinmav_tpu_torch.envs.quadrotor2d``): step, control and
  reset in float64 against the JAX env at 1e-12 (default and swept
  Params), a 100-step closed loop against its golden
  (``tests/goldens/quadrotor2d-v0.npz``, rtol 1e-8 / atol 1e-9) and
  against the NumPy oracle (``Quadrotor2DOracle``); the planar PD
  controller module; the wrappers against ``reinmav_tpu.envs.wrappers``.
- K8's plain twin (``ops.closed_loop_rollout``) against the JAX kernel
  ``quad2d_rollout_autoreset_pallas8`` in interpret mode, free-running
  with ``autoreset=False`` at tests/test_pallas_rollout.py's tolerances
  (rtol 3e-3 / atol 1e-4, reward total rtol 1e-4).
- The A = 2 kind of the policy kernels: K6's twin against
  ``ppo_rollout_pallas`` (sigma -> 0 leg and the stochastic invariants),
  K3's and K4's twins at (5, 2) against the JAX kernels, K7's twin
  against ``collect_step_pallas``; ``params_from_jax`` and the SAC/TD3
  ``state_from_jax`` at A = 2.
- The dispatch: a swept Params stays on the kernel path, a wrapped env is
  refused and runs eagerly, with the reason logged.

The helpers taking an ``env_id`` serve tests/test_torch_slungload.py too.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.controllers import pd2d as jpd2d
from reinmav_tpu.envs import quadrotor2d as jq2
from reinmav_tpu.envs import quadrotor2d_slungload as js2
from reinmav_tpu.envs import quadrotor3d_slungload as js3
from reinmav_tpu.envs import wrappers as jwrappers
from reinmav_tpu.ops import pallas_offpolicy, pallas_ppo, pallas_ppo_rollout, pallas_rollout
from reinmav_tpu.oracle import Quadrotor2DOracle
from reinmav_tpu.rl import networks as jnet
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu.rl import sac as jsac
from reinmav_tpu.rl import td3 as jtd3
from reinmav_tpu_torch.controllers import pd2d
from reinmav_tpu_torch.envs import core, quadrotor2d, quadrotor2d_slungload, quadrotor3d_slungload
from reinmav_tpu_torch.envs import wrappers
from reinmav_tpu_torch.ops import closed_loop_rollout as cl
from reinmav_tpu_torch.ops import offpolicy
from reinmav_tpu_torch.ops import ppo_loss as pl
from reinmav_tpu_torch.ops import ppo_rollout as pr
from reinmav_tpu_torch.rl import networks, ppo, sac, td3
from test_torch_ppo import _jax_state, _perms_from_jax_keys, _port_state
from test_torch_ppo_rollout import _compare, _port_rollout
from test_torch_sac import f64_dots  # noqa: F401  (a fixture)

#: env id -> (JAX env module, port env module, a non-default Params sweep).
ENVS = {
    "quadrotor2d-v0": (jq2, quadrotor2d, dict(mass=1.3, dt=0.02, ref_x=0.4, ref_z=-0.3,
                                               vel_limit=2.5, kp=-4.0, kv=-3.0, tau=0.15,
                                               thrust_scale=8.0)),
    "quadrotor2d-slungload-v0": (js2, quadrotor2d_slungload, dict(
        mass=1.2, load_mass=0.2, dt=0.02, tether_length=0.6, pos_limit=2.5, ref_x=0.3,
        kp=-4.0, tau=0.15)),
    "quadrotor3d-slungload-v0": (js3, quadrotor3d_slungload, dict(
        mass=1.1, load_mass=0.15, dt=0.02, tether_length=1.2, pos_limit=3.5, ref_z=1.5,
        kp=-4.0, tau=0.25)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t64(x):
    return torch.from_numpy(np.array(x, np.float64))


def _t32(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def env_pair(env_id, swept=False):
    """The JAX env and the port's, with the default or the swept Params."""
    jmod, tmod, sweep = ENVS[env_id]
    jp = jmod.Params(**sweep) if swept else jmod.Params()
    return jmod.make(jp), tmod.make(tmod.params_from_jax(jp))


def tether_states(env_id, rng, batch, scale=1.0):
    """U(-1, 1) states times ``scale``, with the load placed so that tether
    norms straddle L (both branches populated) for the slung-load envs."""
    d = reinmav_tpu.make(env_id).state_dim
    s = rng.uniform(-1.0, 1.0, (batch, d)) * scale
    if env_id == "quadrotor3d-slungload-v0":
        s[:, 10:13] = s[:, 0:3] + rng.normal(size=(batch, 3)) * 1.5 / np.sqrt(3.0) * 1.1
    elif env_id == "quadrotor2d-slungload-v0":
        s[:, 5:7] = s[:, 0:2] + rng.normal(size=(batch, 2)) * 0.5 / np.sqrt(2.0) * 1.1
    return s


def far_out(env_id, s, n, factor=4.0):
    """``s`` with the positions (the quad's, and the load's of the
    slung-load envs, whose done test reads it) of its first ``n`` envs
    scaled by ``factor``."""
    s = s.copy()
    k = 3 if env_id.startswith("quadrotor3d") else 2
    s[:n, 0:k] *= factor
    if env_id != "quadrotor2d-v0":
        s[:n, s.shape[1] - 2 * k:s.shape[1] - k] *= factor
    return s


def check_step_control_against_jax(env_id, rng, swept):
    """One batched step and control in float64 from random states."""
    jenv, tenv = env_pair(env_id, swept)
    s = far_out(env_id, tether_states(env_id, rng, 64), 8)
    a = np.asarray(jenv.vcontrol(jnp.asarray(s)))
    np.testing.assert_allclose(tenv.vcontrol(_t64(s)).numpy(), a, rtol=1e-12, atol=1e-13)
    a = a + rng.normal(size=a.shape)  # off the controller's action
    out_j = jenv.vstep(jnp.asarray(s), jnp.asarray(a))
    out_t = tenv.vstep(_t64(s), _t64(a))
    np.testing.assert_allclose(out_t.state.numpy(), np.asarray(out_j.state), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(out_t.reward.numpy(), np.asarray(out_j.reward), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_array_equal(out_t.done.numpy(), np.asarray(out_j.done))
    assert 0 < int(out_t.done.sum()) < 64  # both sides of the done test are live
    # One env (D,) as a batch row; the reset draws U(-1, 1)^D.
    np.testing.assert_array_equal(tenv.step(_t64(s[3]), _t64(a[3])).state.numpy(),
                                  out_t.state[3].numpy())
    fresh = tenv.vreset(torch.Generator().manual_seed(0), 4096, dtype=torch.float64)
    assert fresh.shape == (4096, tenv.state_dim) and float(fresh.abs().max()) <= 1.0
    assert abs(float(fresh.mean())) < 0.02
    assert (tenv.state_dim, tenv.action_dim, tenv.obs_dim) == (
        jenv.state_dim, jenv.action_dim, jenv.obs_dim)


def check_params_from_jax(env_id):
    jmod, tmod, sweep = ENVS[env_id]
    jp = jmod.Params(**sweep)
    tp = tmod.params_from_jax(jp)
    assert tuple(tp) == tuple(float(v) for v in jp) and tmod.params_from_jax(jmod.Params()) == \
        tmod.Params()
    assert tmod.params_from_jax({k: np.float32(v) for k, v in jp._asdict().items()}) == tuple(
        float(np.float32(v)) for v in jp)
    with pytest.raises(ValueError, match="fields"):
        tmod.params_from_jax(dict(reversed(list(jp._asdict().items()))))


def closed_loop_port(env_id, states, seed, horizon, autoreset, params=None):
    """The port's closed-loop twin on ``states`` (B, D) float32."""
    tmod = ENVS[env_id][1]
    pvec = cl.KINDS[env_id].pack(tmod.Params() if params is None else params)
    return cl.closed_loop_rollout(env_id, _t32(states.T).contiguous(), seed, horizon,
                                  params_vec=pvec, autoreset=autoreset)


def check_k6_sigma_zero(env_id, states, horizon):
    """K6's twin against the JAX kernel with log_std -> -40, from
    ``states`` (B, D), through a horizon in which no env resets (the reset
    streams differ by design)."""
    env = reinmav_tpu.make(env_id)
    batch = states.shape[0]
    cfg = jppo.PpoConfig(num_envs=batch, rollout_len=horizon, hidden=(64, 64),
                         fused_rollout="on")
    params = jnet.init_params(jax.random.PRNGKey(0), jnet.MlpConfig(env.obs_dim, env.action_dim))
    params["log_std"] = jnp.full_like(params["log_std"], -40.0)
    d = env.obs_dim
    obs_norm = jppo.ObsNorm(jnp.linspace(-0.1, 0.1, d).astype(jnp.float32),
                            jnp.linspace(0.5, 2.0, d).astype(jnp.float32),
                            jnp.asarray(100.0, jnp.float32))
    ret_norm = jppo.RetNorm(jnp.asarray(4.0, jnp.float32), jnp.asarray(100.0, jnp.float32))
    rets = jnp.linspace(-1.0, 1.0, batch).astype(jnp.float32)
    states = jnp.asarray(states, jnp.float32)
    port = _port_rollout(cfg, params, states, obs_norm, ret_norm, rets, env_id=env_id)
    assert not bool(port.traj.done.any()), "an env reset: the reset streams are not comparable"
    with pltpu.force_tpu_interpret_mode():
        kern = jppo._collect_rollout_pallas(env, cfg, params, obs_norm, ret_norm, states, rets,
                                            jax.random.PRNGKey(7))
    _compare(port, kern, f"{env_id} vs the JAX kernel")
    return port


def check_k6_stochastic(env_id, states, horizon):
    """A noisy rollout of the twin: logp and value as the JAX policy
    recomputes them from the stored obs and action, N(0, 1) noise, and
    step 0's rewards and dones the JAX env's response to the stored action
    (the K2 test's invariants at this kind's action dim)."""
    env = reinmav_tpu.make(env_id)
    d, a = env.obs_dim, env.action_dim
    batch = states.shape[0]
    cfg = jppo.PpoConfig(num_envs=batch, rollout_len=horizon, hidden=(64, 64))
    params = jnet.init_params(jax.random.PRNGKey(0), jnet.MlpConfig(d, a))
    params["log_std"] = jnp.asarray([-0.5, 0.3, 0.0, -1.0][:a], jnp.float32)
    obs_norm = jppo.ObsNorm(jnp.zeros(d, jnp.float32), jnp.ones(d, jnp.float32),
                            jnp.asarray(1e-4, jnp.float32))
    ret_norm = jppo.RetNorm(jnp.asarray(4.0, jnp.float32), jnp.asarray(100.0, jnp.float32))
    rets = jnp.zeros(batch, jnp.float32)
    port = _port_rollout(cfg, params, jnp.asarray(states, jnp.float32), obs_norm, ret_norm,
                         rets, seed=3, env_id=env_id)
    traj = port.traj
    obs = traj.obs.numpy().transpose(1, 0, 2).reshape(d, -1)
    act = traj.action.numpy().transpose(1, 0, 2).reshape(a, -1)
    mean, log_std, value = jnet.apply_t(params, jnp.asarray(obs))
    ref_logp = jnet.gaussian_log_prob_t(mean, log_std, jnp.asarray(act))
    np.testing.assert_allclose(traj.log_prob.numpy().reshape(-1), np.asarray(ref_logp),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(traj.value.numpy().reshape(-1), np.asarray(value), rtol=1e-4,
                               atol=1e-4)
    z = ((act - np.asarray(mean)) / np.exp(np.asarray(log_std))[:, None]).reshape(-1)
    assert abs(z.mean()) < 5.0 / np.sqrt(z.size) and abs(z.std() - 1.0) < 5.0 / np.sqrt(2 * z.size)
    # Step 0: the JAX env (float32) under the stored action.
    out = jax.jit(env.vstep)(jnp.asarray(states, jnp.float32), jnp.asarray(traj.action[0].numpy().T))
    scaled = np.clip(np.asarray(out.reward) / np.sqrt(np.float32(4.0) + np.float32(1e-8)),
                     -10.0, 10.0)
    np.testing.assert_allclose(traj.reward[0].numpy(), scaled, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(traj.done[0].numpy(), np.asarray(out.done))
    return port


def _loss_case(d, a, seed=0, n=1024):
    params = jnet.init_params(jax.random.PRNGKey(seed), jnet.MlpConfig(d, a, (64, 64)))
    params["log_std"] = params["log_std"] + 0.1
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    old_value = f32(n)
    batch = (f32(d, n), f32(a, n), f32(n) * np.float32(0.3) - np.float32(4.0), old_value,
             f32(n), old_value + f32(n) * np.float32(0.5))
    return params, batch


def check_k3(d, a, mode):
    """K3's twin against the JAX K3 (interpret mode) at obs d, action a:
    tests/test_torch_ppo_loss.py's case and tolerances."""
    perm, tile, shift, inv, beta, ent = [5, 2, 7, 0], 128, 0.1, 1.3, 0.7, 1e-2
    params, batch = _loss_case(d, a)
    cfg = dict(clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, ent_coef=ent,
               kl_mode=mode == "kl")
    data = pl.stack_batch(*(torch.from_numpy(x) for x in batch))
    stats = torch.tensor([shift, inv, beta if mode == "kl" else 0.0, 0.0])
    grads, metrics = pl.ppo_loss_grads_gather(data, stats, torch.tensor(perm, dtype=torch.int32),
                                              networks.params_from_jax(_np_tree(params)), d=d,
                                              adim=a, tile=tile, **cfg)
    layers, wo, bo = jnet.fused_weights(params)
    (w1, b1), (w2, b2) = layers
    jstats = jnp.asarray([[shift, inv, beta if mode == "kl" else 0.0, 0.0]], jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        j_g, j_m = pallas_ppo.ppo_loss_grads_pallas_gather(
            pallas_ppo.stack_batch(*(jnp.asarray(x) for x in batch)), jstats,
            jnp.asarray(perm, jnp.int32), w1, b1, w2, b2, wo, bo, params["log_std"], d=d,
            adim=a, tile=tile, compute_dtype="float32", **cfg)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(metrics[name]), float(j_m[name]), rtol=2e-4, atol=1e-6,
                                   err_msg=name)
    ref = networks.params_from_jax(_np_tree(jppo._unfuse_grads(j_g, 64, a)))
    np.testing.assert_allclose(grads.numpy(), ref.numpy(), rtol=2e-3, atol=2e-6)


def check_k4(env_id):
    """K4's twin against the JAX one-launch update (interpret mode) on the
    JAX rollout's trajectory, 2 epochs x 2 minibatches, clip mode, at
    tests/test_torch_ppo_update.py's tolerances."""
    jcfg = jppo.PpoConfig(num_envs=256, rollout_len=32, num_epochs=2, num_minibatches=2,
                          hidden=(64, 64), fused_loss="on", fused_rollout="off", shuffle_tile=64,
                          learning_rate=3e-3, max_grad_norm=0.5)
    env, jstate = _jax_state(jcfg, seed=0, env_id=env_id)
    step = jax.jit(lambda s: (
        jppo.train_step(env, jcfg, s, dense8=False, fused_rollout=False, fused_loss=True,
                        fused_update=True),
        jppo.collect_rollout(env, jcfg, s.params, s.obs_norm, s.ret_norm, s.env_states,
                             s.env_returns, s.key, dense8=False)))
    with pltpu.force_tpu_interpret_mode():
        (s_ref, m_ref), (final, rets, key, traj, omom, rmom, raw_mean) = step(jstate)
    penv = reinmav_tpu_torch.make(env_id)
    pcfg = ppo.PpoConfig(**jcfg._asdict())
    rollout = ppo.Rollout(_t32(final), _t32(rets), ppo.Transition(*(
        _t32(x) if x.dtype != np.bool_ else torch.from_numpy(np.array(x)) for x in traj)),
        ppo.RawObsMoments(*map(_t32, omom)), ppo.RawObsMoments(*map(_t32, rmom)),
        _t32(raw_mean))
    _, n_tiles = ppo._tiling(pcfg, 256 * 32)
    perms = _perms_from_jax_keys(key, n_tiles, jcfg.num_epochs)
    state, summary = ppo.update_phase(penv, pcfg, _port_state(jstate, jcfg), rollout, perms,
                                      fused_loss=False, fused_update=True)
    flat = lambda tree: networks.params_from_jax(jax.tree.map(np.asarray, tree))  # noqa: E731
    np.testing.assert_allclose(state.params.numpy(), flat(s_ref.params).numpy(), rtol=2e-4,
                               atol=1e-6)
    adam = s_ref.opt_state[1][0]
    assert int(state.opt_state.count) == int(adam.count) == 4
    np.testing.assert_allclose(state.opt_state.mu.numpy(), flat(adam.mu).numpy(), rtol=2e-4,
                               atol=5e-8)
    np.testing.assert_allclose(state.opt_state.nu.numpy(), flat(adam.nu).numpy(), rtol=2e-4,
                               atol=5e-8)
    for name in m_ref:
        np.testing.assert_allclose(float(summary[name]), float(m_ref[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def _k7_actor(env, head, key=0, h=64):
    rng = np.random.default_rng(key)
    actor = jsac._mlp_init(jax.random.PRNGKey(key), (env.obs_dim, h, h, head))
    return [{k: np.asarray(v, np.float32) + np.float32(0.3) * rng.standard_normal(v.shape)
             .astype(np.float32) for k, v in layer.items()} for layer in actor]


def _k7_twin(env_id, actor, states, mode, seed=7, noise=0.0):
    penv = reinmav_tpu_torch.make(env_id)
    weights = offpolicy.actor_kernel_args(
        [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in actor])
    consts = sac.collect_consts(penv, torch.tensor(False), noise)
    new, block = offpolicy.collect_step(env_id, mode, _t32(states.T).contiguous(), seed, consts,
                                        pr.env_params_vec(penv), *weights)
    return new.numpy(), block.numpy()


def check_k7(env_id, states, mode):
    """K7's twin against the JAX collection kernel (interpret mode) in a
    ``_det`` mode: the block's rows and the new states of the envs that did
    not end; the done envs restart from K7's Philox reset stream.  Then the
    stochastic mode's stored actions stepped again through the JAX env."""
    env = reinmav_tpu.make(env_id)
    d, a, b = env.obs_dim, env.action_dim, states.shape[0]
    actor = _k7_actor(env, 2 * a if mode == "sac_det" else a)
    consts = jsac._collect_consts(env, jnp.asarray(0.0, jnp.float32), 0.0)
    with pltpu.force_tpu_interpret_mode():
        new_j, block_j = pallas_offpolicy.collect_step_pallas(
            env_id, mode, jnp.asarray(states.T.reshape(8 * d, b // 8)),
            jnp.asarray([7], jnp.int32), consts, pallas_ppo_rollout.env_params_vec(env),
            *pallas_offpolicy.actor_kernel_args(actor), tile=jsac._collect_tile(b))
    new_j = np.asarray(new_j).reshape(d, b)
    block_j = np.asarray(block_j).reshape(2 * d + a + 2, b)
    new_t, block_t = _k7_twin(env_id, actor, states, mode)
    np.testing.assert_allclose(block_t[:d + a], block_j[:d + a], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(block_t[d + a:], block_j[d + a:], rtol=1e-5, atol=1e-5)
    done = block_t[2 * d + a + 1] > 0.5
    assert 0 < done.sum() < b // 2, done.sum()
    np.testing.assert_allclose(new_t[:, ~done], new_j[:, ~done], rtol=1e-5, atol=1e-5)
    idx = torch.from_numpy(np.nonzero(done)[0])
    from reinmav_tpu_torch.ops.rollout import reset_draws
    np.testing.assert_array_equal(new_t[:, done], reset_draws(idx, 0, 7, 5, d).numpy())
    # The stochastic mode: the stored actions through the JAX env step.
    noisy = mode.replace("_det", "")
    actor = _k7_actor(env, 2 * a if noisy == "sac" else a)
    _, block = _k7_twin(env_id, actor, states, noisy, noise=0.3)
    a_t = jnp.asarray(block[d:d + a])
    out = jax.jit(env.vstep)(jnp.asarray(states), jsac._scale_action_t(env, a_t).T)
    np.testing.assert_allclose(block[d + a], np.asarray(out.reward), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(block[d + a + 1:2 * d + a + 1], np.asarray(out.obs).T, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(block[2 * d + a + 1], np.asarray(out.done, np.float32))


# --- quadrotor2d-v0 ---------------------------------------------------------------


@pytest.mark.parametrize("swept", [False, True], ids=["default", "swept"])
def test_step_and_control_match_jax(rng, swept):
    check_step_control_against_jax("quadrotor2d-v0", rng, swept)


def test_params_from_jax():
    check_params_from_jax("quadrotor2d-v0")


def test_closed_loop_matches_golden_and_oracle():
    """100 closed-loop steps in float64: the golden at its tolerance, and
    the oracle step for step."""
    import os

    data = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                                "quadrotor2d-v0.npz"))
    env = reinmav_tpu_torch.make("quadrotor2d-v0")
    oracle = Quadrotor2DOracle()
    oracle.reset_to(data["init"])
    s = _t64(data["init"])
    for t in range(data["traj"].shape[0]):
        out = env.step(s, env.control(s))
        np.testing.assert_allclose(out.state.numpy(), data["traj"][t], rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(float(out.reward), data["rewards"][t], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(env.control(s).numpy(), oracle.control(), rtol=1e-12,
                                   atol=1e-12)
        ref, r, done, _ = oracle.step(oracle.control())
        np.testing.assert_allclose(out.state.numpy(), ref, rtol=1e-10, atol=1e-12)
        assert float(out.reward) == pytest.approx(r, rel=1e-10, abs=1e-12)
        assert bool(out.done) == done
        s = out.state


def test_pd2d_controller_matches_jax(rng):
    gains = dict(kp=-4.0, kv=-3.5, tau=0.2, mass=1.1, lift=9.81)
    pos, vel, ref = (rng.normal(size=(16, 2)) for _ in range(3))
    att = rng.normal(size=16)
    ref_vel = rng.normal(size=(16, 2))
    for rv in (None, ref_vel):
        got = pd2d.control(pd2d.Gains(**gains), _t64(pos), _t64(att), _t64(vel), _t64(ref),
                           None if rv is None else _t64(rv))
        want = jax.vmap(lambda p, a, v, r, q: jpd2d.control(jpd2d.Gains(**gains), p, a, v, r, q))(
            jnp.asarray(pos), jnp.asarray(att), jnp.asarray(vel), jnp.asarray(ref),
            jnp.zeros((16, 2)) if rv is None else jnp.asarray(rv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)
    # The env's controller is the module's at the env's gains and lift 9.8.
    env = reinmav_tpu_torch.make("quadrotor2d-v0")
    s = _t64(rng.uniform(-1, 1, (8, 5)))
    np.testing.assert_allclose(
        env.vcontrol(s).numpy(),
        pd2d.control(pd2d.Gains(), s[:, 0:2], s[:, 2], s[:, 3:5], s.new_zeros(2)).numpy(),
        rtol=1e-12, atol=1e-13)


def test_k8_twin_matches_jax_kernel_free_running():
    """tests/test_pallas_rollout.py::test_quad2d_pallas_matches_scan's leg:
    256 envs x 50 steps without reset from 0.4 x a reset, the twin against
    the JAX kernel at that test's tolerances."""
    env = reinmav_tpu.make("quadrotor2d-v0")
    states = np.asarray(env.vreset(jax.random.split(jax.random.PRNGKey(0), 256)) * 0.4,
                        np.float32)
    with pltpu.force_tpu_interpret_mode():
        f_j, r_j = pallas_rollout.quad2d_rollout_autoreset_pallas8(
            jnp.asarray(states.T), 0, 50, tile8=8, autoreset=False)
    f_t, r_t = closed_loop_port("quadrotor2d-v0", states, 0, 50, autoreset=False)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=3e-3, atol=1e-4)
    np.testing.assert_allclose(float(r_t.sum()), float(r_j.sum()), rtol=1e-4)


def test_k8_twin_autoreset_and_param_sweep(caplog):
    """With resets on, done envs redraw from stream 0 of the Philox twin; a
    swept Params stays eligible for the kernel (its values are kernel
    arguments) and the twin flies it as the eager env does; on the CPU,
    throughput_rollout runs the eager loop and says why, and the kernel
    backend raises."""
    rng = np.random.default_rng(3)
    states = rng.uniform(-1, 1, (512, 5)).astype(np.float32)
    f, r = closed_loop_port("quadrotor2d-v0", states, 9, 30, autoreset=True)
    assert bool(torch.isfinite(f).all()) and float(f[0:2].norm(dim=0).max()) < 3.2
    f2, _ = closed_loop_port("quadrotor2d-v0", states, 9, 30, autoreset=True)
    assert torch.equal(f, f2)
    # One step from states beyond the position limit: all done, all redrawn.
    far = states.copy()
    far[:, 0] = 5.0
    f1, r1 = closed_loop_port("quadrotor2d-v0", far, 4, 1, autoreset=True)
    assert bool((r1 == 1.0).all())
    from reinmav_tpu_torch.ops.rollout import reset_draws
    assert torch.equal(f1, reset_draws(torch.arange(512), 0, 4, 0, 5))
    # The sweep: eligible, and the twin follows the env's float32 step.
    jenv, tenv = env_pair("quadrotor2d-v0", swept=True)
    assert core.fused_kernel_mismatch(tenv) is None
    s = states[:64] * 0.3
    f_t, _ = closed_loop_port("quadrotor2d-v0", s, 0, 20, False, params=tenv.params)
    x = torch.from_numpy(s)
    for _ in range(20):
        x = tenv.vstep(x, tenv.vcontrol(x)).state
    np.testing.assert_allclose(f_t.T.numpy(), x.numpy(), rtol=2e-4, atol=2e-5)
    # The CPU path of throughput_rollout: eager, and it says why.
    gen = torch.Generator().manual_seed(0)
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        final, rew = reinmav_tpu_torch.throughput_rollout(tenv, _t64(s), gen, 10)
    assert "eager loop (states on cpu" in caplog.text
    assert final.shape == (64, 5) and rew.shape == (64,) and bool(torch.isfinite(rew).all())
    with pytest.raises(ValueError, match="kernel backend refused"):
        reinmav_tpu_torch.throughput_rollout(tenv, _t64(s), gen, 10, backend="kernel")


def test_wrappers_match_jax():
    jenv, tenv = env_pair("quadrotor2d-v0")
    rng = np.random.default_rng(5)
    s = rng.uniform(-1, 1, (32, 5))
    a = rng.normal(size=(32, 2)) * 20.0
    for jw, tw in (
            (jwrappers.clip_action(jenv), wrappers.clip_action(tenv)),
            (jwrappers.clip_action(jenv, -1.0, 2.0), wrappers.clip_action(tenv, -1.0, 2.0)),
            (jwrappers.scale_reward(jenv, 0.1), wrappers.scale_reward(tenv, 0.1))):
        oj, ot = jw.vstep(jnp.asarray(s), jnp.asarray(a)), tw.vstep(_t64(s), _t64(a))
        np.testing.assert_allclose(ot.state.numpy(), np.asarray(oj.state), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(ot.reward.numpy(), np.asarray(oj.reward), rtol=1e-12)
    jt, tt = jwrappers.time_limit(jenv, 3), wrappers.time_limit(tenv, 3)
    assert tt.state_dim == jt.state_dim == 6 and tt.obs_dim == 5
    sj = jnp.concatenate([jnp.asarray(s) * 0.1, jnp.zeros((32, 1))], axis=1)
    st = _t64(np.asarray(sj))
    a = a * 0.01
    for step in range(4):
        oj, ot = jt.vstep(sj, jnp.asarray(a)), tt.vstep(st, _t64(a))
        np.testing.assert_allclose(ot.state.numpy(), np.asarray(oj.state), rtol=1e-12, atol=1e-14)
        np.testing.assert_array_equal(ot.truncated.numpy(), np.asarray(oj.truncated))
        np.testing.assert_array_equal(ot.done.numpy(), np.asarray(oj.done))
        sj, st = oj.state, ot.state
    assert bool(ot.truncated.any())  # the horizon ran out
    fresh = tt.vreset(torch.Generator().manual_seed(0), 8, dtype=torch.float64)
    assert fresh.shape == (8, 6) and float(fresh[:, -1].abs().max()) == 0.0
    # Auto-reset resets on truncation.
    out = tt.autoreset_step(st, _t64(a), torch.Generator().manual_seed(1))
    assert bool((out.state[out.truncated, -1] == 0.0).all())


def test_wrapped_env_is_refused_and_runs_eagerly(caplog):
    """A wrapped env keeps its name but not the registry's functions: every
    fused kernel refuses it by identity, and the learners' "auto" runs it
    eagerly and logs why."""
    env = reinmav_tpu_torch.make("quadrotor2d-v0")
    wrapped = wrappers.clip_action(env, -1.0, 1.0)
    assert "wrapped" in core.fused_kernel_mismatch(wrapped)
    cuda = torch.device("cuda")
    cfg = ppo.PpoConfig(num_envs=32, rollout_len=4, num_epochs=1, num_minibatches=2)
    assert "wrapped" in ppo._rollout_refusal(cfg, wrapped)
    assert ppo._rollout_refusal(cfg, env) is None and ppo._update_refusal(cfg, env, None,
                                                                          cuda) is None
    scfg = sac.SacConfig()
    assert "wrapped" in sac.collect_refusal(scfg, wrapped, cuda)
    assert sac.collect_refusal(scfg, env, cuda) is None and offpolicy.supported(env)
    gen = torch.Generator().manual_seed(0)
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        reinmav_tpu_torch.throughput_rollout(wrapped, wrapped.vreset(gen, 8), gen, 2)
    assert "eager loop (env step/control/reset fns are wrapped or replaced)" in caplog.text
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.rl.ppo"):
        state = ppo.init_train_state(wrapped, cfg, 0, device="cpu")
        ppo.train_step(wrapped, cfg, state)
    assert "eager loop" in caplog.text
    # reinmav-v0 builds now, but it takes no action: no policy kernel runs
    # it, and each refuses it by name.
    reinmav = reinmav_tpu_torch.make("reinmav-v0")
    assert reinmav.name == "reinmav-v0" and reinmav.action_dim == 0
    for other in (reinmav, dataclasses.replace(env, name="reinmav-v0")):
        assert "no fused PPO rollout kernel for reinmav-v0" in ppo._rollout_refusal(cfg, other)
        assert "no K7 for reinmav-v0" in sac.collect_refusal(scfg, other, cuda)


@pytest.mark.parametrize("env_id,alg", [("quadrotor2d-v0", "ppo"),
                                        ("quadrotor2d-slungload-v0", "td3"),
                                        ("quadrotor3d-slungload-v0", "sac")])
def test_cli_trains_and_plays_the_new_envs(env_id, alg, tmp_path, capsys):
    """The CLI takes the new ids with no special case, on the CPU through
    the kernels' plain twins: train with a checkpoint, then play."""
    import json

    from reinmav_tpu_torch.rl import run

    ck = str(tmp_path / "ck")
    small = ["--device=cpu", f"--env={env_id}", f"--alg={alg}", "--num_env=64"]
    extra = (["--rollout_len=16", "--num_timesteps=2048"] if alg == "ppo" else
             ["--batch_size=64", "--buffer_capacity=1024", "--warmup_steps=64",
              "--updates_per_jit=4", "--num_timesteps=512"])
    run.main([*small, *extra, "--log_interval=1", f"--save_path={ck}"])
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    train = [row for row in rows if "env_steps" in row]
    assert train and all(np.isfinite(v) for row in train for v in row.values())
    run.main([*small, *extra[:1], "--play", f"--load_path={ck}", "--play_steps=20",
              *(extra[1:4] if alg != "ppo" else [])])
    (played,) = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert played["play_steps"] == 20 and np.isfinite(played["total_reward"])


def test_k6_quad2d_sigma_zero_matches_jax_kernel():
    rng = np.random.default_rng(2)
    states = (rng.uniform(-1, 1, (64, 5)) * 0.3).astype(np.float32)
    check_k6_sigma_zero("quadrotor2d-v0", states, 8)


def test_k6_quad2d_stochastic_invariants():
    rng = np.random.default_rng(4)
    port = check_k6_stochastic("quadrotor2d-v0", rng.uniform(-1, 1, (256, 5)).astype(np.float32),
                               16)
    assert bool(port.traj.done.any())  # the 10x gain: episodes end and reset
    assert port.traj.action.shape == (16, 2, 256)


@pytest.mark.parametrize("mode", ["clip", "kl"])
def test_k3_twin_at_obs5_act2_matches_jax_kernel(mode):
    check_k3(5, 2, mode)


def test_k4_twin_on_quad2d_matches_jax_k4():
    check_k4("quadrotor2d-v0")


@pytest.mark.parametrize("mode", ["sac_det", "td3_det"])
def test_k7_quad2d_matches_jax_kernel(mode):
    rng = np.random.default_rng(6)
    states = rng.uniform(-1, 1, (256, 5)).astype(np.float32)
    states[:32, 3:5] *= 3.0  # past vel_limit: these end at once
    check_k7("quadrotor2d-v0", states, mode)


def test_networks_and_offpolicy_states_from_jax_at_action_dim_2(f64_dots):
    """The JAX params and learner states carry into the port at A = 2
    without a special case: the actor-critic's outputs, SAC's and TD3's
    greedy actions agree in float64."""
    env = reinmav_tpu.make("quadrotor2d-v0")
    penv = reinmav_tpu_torch.make("quadrotor2d-v0")
    params = jnet.init_params(jax.random.PRNGKey(1), jnet.MlpConfig(5, 2))
    flat = networks.params_from_jax(jax.tree.map(np.asarray, params), dtype=torch.float64)
    assert flat.shape == (networks.Layout(5, 2).size,)
    obs = np.random.default_rng(0).normal(size=(5, 32))
    mean, log_std, value = jnet.apply_t(jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                                                     params), jnp.asarray(obs))
    t_mean, t_ls, t_val = networks.apply_t(networks.Layout(5, 2).unflatten(flat), _t64(obs))
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(mean), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t_val.numpy(), np.asarray(value), rtol=1e-10, atol=1e-12)
    for jmod, tmod, cfg_t in ((jsac, sac, sac.SacConfig), (jtd3, td3, td3.Td3Config)):
        jcfg = jmod.SacConfig if jmod is jsac else jmod.Td3Config
        jcfg = jcfg(num_envs=16, batch_size=16, buffer_capacity=64, hidden=(32, 32))
        jstate = jax.tree.map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            jmod.init_state(env, jcfg, jax.random.PRNGKey(5)))
        state = tmod.state_from_jax(penv, cfg_t(**jcfg._asdict()), jstate, dtype=torch.float64)
        o = np.asarray(jstate.env_states)
        ref = jmod.greedy_action(env, jstate.actor, jnp.asarray(o))
        got = tmod.greedy_action(penv, state.actor, _t64(o), (32, 32))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
        assert state.buffer.shape == (2 * 5 + 2 + 2, 64)
