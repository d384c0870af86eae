"""The plain twin of kernels K2 and K6-hover (reinmav_tpu_torch.ops.ppo_rollout,
kinds quadrotor3d-v0 and MujocoQuadForce-v1) against the JAX package's
fused PPO rollout (``ppo._collect_rollout_pallas``, run in interpret mode
as tests/test_pallas_ppo_rollout.py runs it) and its scan path
(``ppo.collect_rollout``), on the CPU in float32.

The strategy is the JAX package's own (tests/test_pallas_ppo_rollout.py):

1. sigma -> 0 (log_std = -40): ``mean + sigma * z`` rounds to ``mean``
   and logp comes from the rounded action, so the whole rollout is
   deterministic and every output must agree at that test's tolerances
   (1e-5; logp 1e-4; moments rtol 1e-4 / atol 1e-3).  quadrotor3d's
   reset streams differ by design (Philox here, the TPU's on-core PRNG
   there), so its leg asserts that no env resets; the hover task resets
   deterministically, so its leg runs through the resets.
2. Stochastic: logp is the Gaussian log-density of the stored action
   under the policy recomputed from the stored obs (rtol 2e-3 / atol
   2e-3, the JAX test's), value the recomputed value (1e-4), rewards the
   env's response to the stored action, and the Philox noise has N(0, 1)
   moments (5 standard errors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.rl import networks as jnet
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu_torch.envs import tpuquad
from reinmav_tpu_torch.ops import hover_rollout as hr
from reinmav_tpu_torch.ops import ppo_rollout as pr
from reinmav_tpu_torch.ops import rollout as ro
from reinmav_tpu_torch.rl import networks, ppo

T = 16


def _np(x):
    return np.asarray(x, np.float32)


def _setup(batch, sigma_zero, env_id="quadrotor3d-v0"):
    """tests/test_pallas_ppo_rollout.py::_setup: warmed normalisers, a
    spread of running returns, float32 throughout.  The hover task starts
    from perturbed states between z = 0.35 and 1, so that most envs fall
    through z = 0.3 within the horizon and reset."""
    env = reinmav_tpu.make(env_id)
    cfg = jppo.PpoConfig(num_envs=batch, rollout_len=T, hidden=(64, 64), fused_rollout="on")
    params = jnet.init_params(jax.random.PRNGKey(0), jnet.MlpConfig(env.obs_dim, env.action_dim))
    if sigma_zero:
        params["log_std"] = jnp.full_like(params["log_std"], -40.0)
    states = env.vreset(jax.random.split(jax.random.PRNGKey(1), batch)).astype(jnp.float32)
    if env_id == "MujocoQuadForce-v1":
        rng = np.random.default_rng(1)
        base = np.array(states)
        base[:, 2] = rng.uniform(0.35, 1.0, batch)
        base[:, 7:13] = rng.uniform(-0.3, 0.3, (batch, 6))
        states = jnp.asarray(base, jnp.float32)
    d = env.obs_dim
    obs_norm = jppo.ObsNorm(jnp.linspace(-0.1, 0.1, d).astype(jnp.float32),
                            jnp.linspace(0.5, 2.0, d).astype(jnp.float32),
                            jnp.asarray(100.0, jnp.float32))
    ret_norm = jppo.RetNorm(jnp.asarray(4.0, jnp.float32), jnp.asarray(100.0, jnp.float32))
    rets = jnp.linspace(-1.0, 1.0, batch).astype(jnp.float32)
    return env, cfg, params, states, obs_norm, ret_norm, rets


def _port_rollout(cfg, params, states, obs_norm, ret_norm, rets, seed=7,
                  env_id="quadrotor3d-v0"):
    env = reinmav_tpu_torch.make(env_id)
    pcfg = ppo.PpoConfig(num_envs=cfg.num_envs, rollout_len=cfg.rollout_len)
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    return ppo.collect_rollout_kernel(
        env, pcfg, networks.params_from_jax(jax.tree.map(_np, params)),
        ppo.ObsNorm(t(obs_norm.mean), t(obs_norm.var), t(obs_norm.count)),
        ppo.RetNorm(t(ret_norm.var), t(ret_norm.count)), t(states), t(rets), seed)


def _compare(port, ref, what):
    f_s, r_s, _, traj_s, om_s, rm_s, rr_s = ref

    def close(a, b, name, tol=1e-5):
        # The JAX kernel's (T, D, 8, B/8) views reshape to (T, D, B) in env order.
        np.testing.assert_allclose(_np(a), _np(b).reshape(a.shape), rtol=tol, atol=tol,
                                   err_msg=f"{what}: {name}")

    traj = port.traj
    close(traj.obs, traj_s.obs, "obs")
    close(traj.action, traj_s.action, "action")
    close(traj.log_prob, traj_s.log_prob, "log_prob", 1e-4)
    close(traj.value, traj_s.value, "value")
    close(traj.reward, traj_s.reward, "reward")
    np.testing.assert_array_equal(traj.done.numpy(),
                                  np.asarray(traj_s.done).reshape(traj.done.shape), err_msg=what)
    close(port.final_states, f_s, "final_states")
    close(port.env_returns, r_s, "env_returns")
    for a, b, name in ((port.obs_moments, om_s, "obs_moments"),
                       (port.ret_moments, rm_s, "ret_moments")):
        np.testing.assert_allclose(_np(a.total), _np(b.total), rtol=1e-4, atol=1e-3,
                                   err_msg=f"{what}: {name}")
        np.testing.assert_allclose(_np(a.total_sq), _np(b.total_sq), rtol=1e-4, atol=1e-3,
                                   err_msg=f"{what}: {name}")
        assert float(a.count) == float(b.count)
    np.testing.assert_allclose(float(port.raw_reward_mean), float(rr_s), rtol=1e-4, err_msg=what)


def test_sigma_zero_matches_jax_kernel_and_scan():
    from jax.experimental.pallas import tpu as pltpu

    env, cfg, params, states, obs_norm, ret_norm, rets = _setup(64, sigma_zero=True)
    port = _port_rollout(cfg, params, states, obs_norm, ret_norm, rets)
    assert not bool(port.traj.done.any()), "an env reset: the reset streams are not comparable"
    key = jax.random.PRNGKey(7)
    scan = jax.jit(lambda *a: jppo.collect_rollout(env, cfg, *a, dense8=False))(
        params, obs_norm, ret_norm, states, rets, key)
    with pltpu.force_tpu_interpret_mode():
        kern = jppo._collect_rollout_pallas(env, cfg, params, obs_norm, ret_norm, states, rets,
                                            key)
    _compare(port, scan, "vs the JAX scan path")
    _compare(port, kern, "vs the JAX kernel")


def test_hover_sigma_zero_through_resets_matches_jax_kernel_and_scan():
    """K6-hover's twin: the whole rollout, resets included, at sigma -> 0,
    against the JAX kernel and the port's eager rollout (the counterpart of
    the JAX scan path, through the env held to the JAX env in
    tests/test_torch_tpuquad.py)."""
    from jax.experimental.pallas import tpu as pltpu

    env, cfg, params, states, obs_norm, ret_norm, rets = _setup(
        64, sigma_zero=True, env_id="MujocoQuadForce-v1")
    port = _port_rollout(cfg, params, states, obs_norm, ret_norm, rets,
                         env_id="MujocoQuadForce-v1")
    assert int(port.traj.done.sum()) >= 32, "too few resets: the leg does not cross them"
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    eager = ppo.collect_rollout(
        reinmav_tpu_torch.make("MujocoQuadForce-v1"),
        ppo.PpoConfig(num_envs=cfg.num_envs, rollout_len=cfg.rollout_len),
        networks.params_from_jax(jax.tree.map(_np, params)),
        ppo.ObsNorm(t(obs_norm.mean), t(obs_norm.var), t(obs_norm.count)),
        ppo.RetNorm(t(ret_norm.var), t(ret_norm.count)), t(states), t(rets), torch.Generator())
    with pltpu.force_tpu_interpret_mode():
        kern = jppo._collect_rollout_pallas(env, cfg, params, obs_norm, ret_norm, states, rets,
                                            jax.random.PRNGKey(7))
    _compare(port, (eager.final_states, eager.env_returns, None, *eager[2:]),
             "vs the port's eager rollout")
    _compare(port, kern, "vs the JAX kernel")


def _stochastic_leg(env_id, states_scale=1.0):
    """Per-sample invariants of a noisy rollout: logp and value as the JAX
    policy recomputes them from the stored obs and action, N(0, 1) noise,
    and step 0's rewards and dones the eager env's response to the stored
    action."""
    env, cfg, params, states, obs_norm, ret_norm, rets = _setup(256, sigma_zero=False,
                                                                env_id=env_id)
    params["log_std"] = jnp.asarray([-0.5, 0.0, 0.3, -1.0], jnp.float32)
    port = _port_rollout(cfg, params, states, obs_norm, ret_norm, rets, seed=3, env_id=env_id)
    traj = port.traj
    d = env.obs_dim
    obs = traj.obs.numpy().transpose(1, 0, 2).reshape(d, -1)
    act = traj.action.numpy().transpose(1, 0, 2).reshape(4, -1)
    mean, log_std, value = jnet.apply_t(params, jnp.asarray(obs))
    ref_logp = jnet.gaussian_log_prob_t(mean, log_std, jnp.asarray(act))
    np.testing.assert_allclose(traj.log_prob.numpy().reshape(-1), _np(ref_logp),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(traj.value.numpy().reshape(-1), _np(value), rtol=1e-4, atol=1e-4)

    z = ((act - _np(mean)) / np.exp(_np(log_std))[:, None]).reshape(-1)
    n = z.size
    assert abs(z.mean()) < 5.0 / np.sqrt(n), z.mean()
    assert abs(z.std() - 1.0) < 5.0 / np.sqrt(2 * n), z.std()

    # Step 0's rewards and dones are the env's response to the stored action.
    out = reinmav_tpu_torch.make(env_id).vstep_t(torch.from_numpy(_np(states).T.copy()),
                                                 traj.action[0])
    raw_scaled = torch.clamp(out.reward / torch.sqrt(torch.tensor(4.0) + 1e-8), -10.0, 10.0)
    np.testing.assert_allclose(traj.reward[0].numpy(), raw_scaled.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(traj.done[0].numpy(), out.done.numpy())
    return port


def test_stochastic_invariants():
    _stochastic_leg("quadrotor3d-v0")


def test_stochastic_invariants_hover():
    port = _stochastic_leg("MujocoQuadForce-v1")
    assert bool(port.traj.done.any())
    # The raw reward mean is the hover reward's, not quadrotor3d's (which is
    # at most 1 a step): the kernel stepped the hover task.
    assert 50.0 < float(port.raw_reward_mean) < 100.0


def test_collect_rollout_kernel_packs_the_envs_params():
    """The rollout kernel's wrapper takes each env's own Params pack (the
    per-kind table): a hover env with live non-default Params steps them."""
    params = tpuquad.Params(init_z=0.8, mass=0.33, arm_xy=0.12)
    env = tpuquad.make_hovering(params)
    cfg = ppo.PpoConfig(num_envs=64, rollout_len=8)
    st = ppo.init_train_state(env, cfg, 0, device="cpu")
    out = ppo.collect_rollout_kernel(env, cfg, st.params, st.obs_norm, st.ret_norm,
                                     st.env_states, st.env_returns, seed=4)
    assert torch.equal(pr.env_params_vec(env), hr.hover_params_vec(params))
    consts = ppo._rollout_consts(st.params, networks.Layout(13, 4), st.obs_norm, st.ret_norm,
                                 cfg.gamma)
    args = (st.env_states.T.contiguous(), st.env_returns, 4, st.params, consts, 8)
    ref = pr.ppo_rollout(*args, params_vec=hr.hover_params_vec(params),
                         env_kind="MujocoQuadForce-v1")
    assert torch.equal(out.traj.reward, ref.reward) and torch.equal(out.final_states.T,
                                                                     ref.final_states)
    default = pr.ppo_rollout(*args, env_kind="MujocoQuadForce-v1")
    assert not torch.equal(default.final_states, ref.final_states)
    with pytest.raises(ValueError, match="params_vec"):
        pr.ppo_rollout(*args, params_vec=ro.quad3d_params_vec(), env_kind="MujocoQuadForce-v1")
    with pytest.raises(ValueError, match="env_kind"):
        pr.ppo_rollout(*args, env_kind="MujocoQuadForce-v0")
    with pytest.raises(ValueError, match="states_t"):
        pr.ppo_rollout(*args)  # 13-dim states under the quadrotor3d kind


def test_normal_draws_have_gaussian_moments_and_tails():
    z = pr.normal_draws(torch.arange(65536), step=3, seed=11).reshape(-1).double()
    n = z.numel()
    assert abs(float(z.mean())) < 5.0 / np.sqrt(n)
    assert abs(float(z.std()) - 1.0) < 5.0 / np.sqrt(2 * n)
    assert 4.0 < float(z.abs().max()) < 8.0  # 262k draws: a healthy Gaussian tail
    other = pr.normal_draws(torch.arange(65536), step=4, seed=11).reshape(-1).double()
    assert abs(float(torch.corrcoef(torch.stack([z, other]))[0, 1])) < 0.02


def test_done_envs_redraw_from_the_reset_stream():
    """Envs outside the envelope are done at step 0 and take the stream-2
    Philox reset; the others keep stepping."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=128, rollout_len=1)
    st = ppo.init_train_state(env, cfg, 0, device="cpu")
    states = st.env_states.clone() * 0.1
    states[:40, 0] = 5.0
    out = ppo.collect_rollout_kernel(env, cfg, st.params, st.obs_norm, st.ret_norm, states,
                                     st.env_returns, seed=9)
    assert bool(out.traj.done[0, :40].all()) and not bool(out.traj.done[0, 40:].any())
    assert torch.equal(out.final_states[:40].T, ro.reset_draws(torch.arange(40), 0, 9, 2))
    assert not torch.equal(out.final_states[:40].T, ro.reset_draws(torch.arange(40), 0, 9, 0))
    # Return carries reset on done: ret * (1 - done).
    assert float(out.env_returns[:40].abs().max()) == 0.0


def test_switches_and_determinism():
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=64, rollout_len=4)
    st = ppo.init_train_state(env, cfg, 1, device="cpu")
    consts = ppo._rollout_consts(st.params, networks.Layout(10, 4), st.obs_norm, st.ret_norm, 0.99)
    args = (st.env_states.T.contiguous(), st.env_returns, 5, st.params, consts, 4)
    a, b = pr.ppo_rollout(*args), pr.ppo_rollout(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    raw = pr.ppo_rollout(*args, normalize_obs=False, normalize_rewards=False)
    assert torch.equal(raw.obs[0], st.env_states.T)
    assert float(raw.stats[:22].abs().max()) == 0.0 and float(raw.stats[22]) != 0.0
    assert torch.equal(raw.returns, st.env_returns)
    assert raw.obs.shape == (4, 10, 64) and raw.action.shape == (4, 4, 64)
    assert raw.done.dtype == torch.bool and raw.stats.shape == (23,)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=16, rollout_len=2)
    st = ppo.init_train_state(env, cfg, 2, device="cpu")
    consts = ppo._rollout_consts(st.params, networks.Layout(10, 4), st.obs_norm, st.ret_norm, 0.99)
    s_t = st.env_states.T.contiguous()
    before = pr.ppo_rollout.launches
    with pytest.raises(TypeError, match="states_t"):
        pr.ppo_rollout(s_t.double(), st.env_returns, 0, st.params, consts, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pr.ppo_rollout(st.env_states.T, st.env_returns, 0, st.params, consts, 2)
    with pytest.raises(ValueError, match="env_returns"):
        pr.ppo_rollout(s_t, st.env_returns[:3], 0, st.params, consts, 2)
    with pytest.raises(ValueError, match="net"):
        pr.ppo_rollout(s_t, st.env_returns, 0, st.params[:-1].contiguous(), consts, 2)
    with pytest.raises(ValueError, match="consts"):
        pr.ppo_rollout(s_t, st.env_returns, 0, st.params, consts[:-1].contiguous(), 2)
    with pytest.raises(ValueError, match="seed"):
        pr.ppo_rollout(s_t, st.env_returns, 2**32, st.params, consts, 2)
    pr.ppo_rollout(s_t, st.env_returns, 0, st.params, consts, 2)
    assert pr.ppo_rollout.launches == before  # the CPU ran the twin
