"""The port's PPO learner (reinmav_tpu_torch.rl.ppo) against the JAX
package's (reinmav_tpu.rl.ppo), on the CPU in float32.

The update phase is held against JAX ``train_step(..., dense8=False,
fused_rollout=False, fused_loss=False)``: the JAX rollout's trajectory
is carried across, the epoch permutations are rebuilt from the same JAX
key stream (ppo.py:753-756) through the port's own bijection, and the
port's update then runs with each minibatch's gradient through K3's twin
and through ``torch.autograd``.  Params, Adam moments, normalisers and
metrics agree at rtol 1e-4 / atol 1e-6 (tests/test_pallas_ppo.py's
tolerance for the JAX kernel against autodiff over a whole update).

Learning sanity: from the same params and env states, a port update's
``mean_reward`` is within 10% of the JAX scan path's (the noise draws
differ), as tests/test_pallas_ppo_rollout.py holds the JAX kernel path.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu_torch.rl import networks, ppo

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _jax_state(cfg, seed=0, env_id="quadrotor3d-v0"):
    env = reinmav_tpu.make(env_id)
    state = jppo.init_train_state(env, cfg, jax.random.PRNGKey(seed))
    return env, state._replace(params=_f32(state.params), opt_state=_f32(state.opt_state),
                               env_states=_f32(state.env_states), obs_norm=_f32(state.obs_norm),
                               ret_norm=_f32(state.ret_norm), env_returns=_f32(state.env_returns),
                               kl_beta=jnp.asarray(state.kl_beta, jnp.float32))


def _port_state(jstate, cfg):
    """The JAX TrainState carried into the port's (CPU tensors)."""
    return ppo.TrainState(
        networks.params_from_jax(jax.tree.map(np.asarray, jstate.params)),
        ppo.adam_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state)),
        _t(jstate.env_states), ppo.ObsNorm(*map(_t, jstate.obs_norm)),
        ppo.RetNorm(*map(_t, jstate.ret_norm)), _t(jstate.env_returns),
        torch.Generator().manual_seed(0), 0, _t(jstate.kl_beta))


def _perms_from_jax_keys(key, n_tiles, epochs):
    """The epoch scan's permutations (ppo.py:753-756): the five integers
    drawn as JAX draws them, the bijection applied by the port."""
    perms = []
    k = key
    for _ in range(epochs):
        k, k_perm = jax.random.split(k)
        ks = jax.random.split(k_perm, 5)
        half, full = n_tiles // 2, n_tiles
        draws = [int(jax.random.randint(ks[0], (), 0, half, jnp.uint32)) * 2 + 1,
                 int(jax.random.randint(ks[1], (), 0, full, jnp.uint32)),
                 int(jax.random.randint(ks[2], (), 0, half, jnp.uint32)) * 2 + 1,
                 int(jax.random.randint(ks[3], (), 0, full, jnp.uint32)),
                 int(jax.random.randint(ks[4], (), 0, full, jnp.uint32))]
        perm = ppo.shuffle_from_draws(n_tiles, draws)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jppo._shuffle_indices(k_perm,
                                                                                     n_tiles)))
        perms.append(perm)
    return perms


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def jax_update():
    """The JAX side of test_update_phase_matches_jax_train_step for a
    ``kl_target``, computed once and shared by the port's two paths:
    ``(jcfg, jstate, (s_ref, m_ref), the rollout it runs)``."""
    cache = {}

    def get(kl_target):
        if kl_target not in cache:
            jcfg = jppo.PpoConfig(num_envs=64, rollout_len=8, num_epochs=2, num_minibatches=2,
                                  kl_target=kl_target, entropy_coef=0.01)
            env, jstate = _jax_state(jcfg)
            ref = jax.jit(lambda s: jppo.train_step(env, jcfg, s, dense8=False,
                                                    fused_rollout=False, fused_loss=False))(jstate)
            rollout = jax.jit(
                lambda s: jppo.collect_rollout(env, jcfg, s.params, s.obs_norm, s.ret_norm,
                                               s.env_states, s.env_returns, s.key,
                                               dense8=False))(jstate)
            cache[kl_target] = jcfg, jstate, ref, rollout
        return cache[kl_target]

    return get


@pytest.mark.parametrize("fused_loss", [True, False], ids=["k3-twin", "autograd"])
@pytest.mark.parametrize("kl_target", [None, 0.01], ids=["clip", "kl"])
def test_update_phase_matches_jax_train_step(fused_loss, kl_target, jax_update):
    jcfg, jstate, (s_ref, m_ref), rollout_ref = jax_update(kl_target)
    final, rets, key, traj, omom, rmom, raw_mean = rollout_ref

    penv = reinmav_tpu_torch.make("quadrotor3d-v0")
    pcfg = ppo.PpoConfig(**jcfg._asdict())
    rollout = ppo.Rollout(_t(final), _t(rets), ppo.Transition(*(
        _t(x) if x.dtype != jnp.bool_ else torch.from_numpy(np.array(x)) for x in traj)),
        ppo.RawObsMoments(*map(_t, omom)), ppo.RawObsMoments(*map(_t, rmom)), _t(raw_mean))
    _, n_tiles = ppo._tiling(pcfg, 64 * 8)
    perms = _perms_from_jax_keys(key, n_tiles, jcfg.num_epochs)
    state, summary = ppo.update_phase(penv, pcfg, _port_state(jstate, jcfg), rollout, perms,
                                      fused_loss)

    tree = networks.Layout(10, 4).unflatten(state.params)
    for (path, ref), got in zip(jax.tree_util.tree_flatten_with_path(s_ref.params)[0],
                                jax.tree.leaves(tree)):
        _close(got.numpy(), ref, f"params {path}")
    adam = s_ref.opt_state[1][0]
    assert int(state.opt_state.count) == int(adam.count) == 4
    _close(state.opt_state.mu.numpy(), networks.params_from_jax(jax.tree.map(np.asarray, adam.mu)),
           "adam mu")
    _close(state.opt_state.nu.numpy(), networks.params_from_jax(jax.tree.map(np.asarray, adam.nu)),
           "adam nu")
    for name, a, b in (("obs_norm", state.obs_norm, s_ref.obs_norm),
                       ("ret_norm", state.ret_norm, s_ref.ret_norm)):
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x.numpy(), y, f"{name}[{i}]")
    _close(float(state.kl_beta), float(s_ref.kl_beta), "kl_beta")
    np.testing.assert_array_equal(state.env_states.numpy(), np.asarray(s_ref.env_states, np.float32))
    assert set(summary) == set(m_ref)
    for name in m_ref:
        _close(float(summary[name]), float(m_ref[name]), name)


@pytest.fixture(scope="module")
def jax_learning():
    """The JAX side of test_train_step_learns_like_jax, shared by its two
    rollout paths: the config, the initial state and each of 2 updates'
    metrics."""
    jcfg = jppo.PpoConfig(num_envs=64, rollout_len=16, num_epochs=2, num_minibatches=2)
    env, jstate = _jax_state(jcfg, seed=1)
    step = jax.jit(lambda s: jppo.train_step(env, jcfg, s, dense8=False, fused_rollout=False,
                                             fused_loss=False))
    metrics, s = [], jstate
    for _ in range(2):
        s, m = step(s)
        metrics.append(m)
    return jcfg, jstate, metrics


@pytest.mark.parametrize("fused_rollout", [True, False], ids=["k2-twin", "eager"])
def test_train_step_learns_like_jax(fused_rollout, caplog, jax_learning):
    jcfg, jstate, metrics = jax_learning
    penv = reinmav_tpu_torch.make("quadrotor3d-v0")
    pcfg = ppo.PpoConfig(**jcfg._asdict())
    pstate = _port_state(jstate, jcfg)
    for update, m_ref in enumerate(metrics):
        with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.rl.ppo"):
            pstate, m = ppo.train_step(penv, pcfg, pstate, fused_rollout=fused_rollout)
        for name, v in m.items():
            assert np.isfinite(float(v)), name
        np.testing.assert_allclose(float(m["mean_reward"]), float(m_ref["mean_reward"]), rtol=0.1,
                                   err_msg=f"update {update}")
    assert pstate.update_step == 2
    expected = "K2 plain twin" if fused_rollout else "eager loop"
    assert expected in caplog.text and "autograd, K3 off" in caplog.text


def test_train_many_and_the_paths_not_ported():
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=32, rollout_len=4, num_epochs=1, num_minibatches=2)
    state = ppo.init_train_state(env, cfg, 0, device="cpu")
    state, summary = ppo.train_many(env, cfg, state, 2, fused_loss=True)
    assert state.update_step == 2 and np.isfinite(float(summary["v_loss"]))
    # K4 is ported: "on" runs its plain twin on the CPU, and refuses a loss
    # path that is switched off, as the JAX package needs fused_loss for it.
    k4_state, k4_summary = ppo.train_step(env, cfg._replace(fused_update="on"), state)
    assert int(k4_state.opt_state.count) == int(state.opt_state.count) + 2
    assert np.isfinite(float(k4_summary["v_loss"]))
    with pytest.raises(ValueError, match="fused_loss is off"):
        ppo.train_step(env, cfg._replace(fused_update="on", fused_loss="off"), state)
    # bf16 is ported (tests/test_torch_bf16_learners.py); another dtype is refused.
    bf_state, bf_summary = ppo.train_step(env, cfg._replace(compute_dtype="bfloat16"), state)
    assert bf_state.params.dtype == torch.float32 and np.isfinite(float(bf_summary["v_loss"]))
    with pytest.raises(ValueError, match="compute_dtype"):
        ppo.train_step(env, cfg._replace(compute_dtype="float16"), state)
    with pytest.raises(ValueError, match="compute_dtype"):
        ppo.init_train_state(env, cfg._replace(compute_dtype="float16"), device="cpu")
    with pytest.raises(ValueError, match="fused_rollout"):
        ppo.train_step(env, cfg._replace(hidden=(32, 32)), state, fused_rollout=True)


def test_kernel_refusals_take_the_env_and_device():
    """K3/K4's 64-wide instances are built for obs dims 10 and 13 (and the
    2D and slung dims), their wide instances take obs dims up to 32 and two
    equal hidden widths up to 256: on the card an env of more obs dims, or
    a wider net, is refused with the dims or the width named, and "auto"
    then takes the loop (it does not raise), "on" raises; the plain twins on
    the CPU take any widths."""
    hover = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    odd = dataclasses.replace(hover, obs_dim=7)
    wide_obs = dataclasses.replace(hover, obs_dim=40)
    cfg = ppo.PpoConfig()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for env in (hover, reinmav_tpu_torch.make("quadrotor3d-v0")):
        assert ppo._loss_refusal(cfg, env, cuda) is None
        assert ppo._update_refusal(cfg, env, None, cuda) is None
        assert ppo._rollout_refusal(cfg, env) is None
        assert ppo._instance_note(cfg, env) == ""
    # Obs dim 7 at (64, 64): no 64-wide instance, the wide one takes it.
    assert ppo._update_refusal(cfg, odd, None, cuda) is None
    assert ppo._instance_note(cfg, odd) == " (wide, H=64)"
    reason = ppo._update_refusal(cfg, wide_obs, None, cuda)
    assert "(40, 4)" in reason and "(10, 4), (13, 4)" in reason
    assert ppo._loss_refusal(cfg, wide_obs, cpu) is None
    assert "(7, 4)" in ppo._rollout_refusal(cfg, odd)
    use, how = ppo._choose("fused_update", None, "auto", reason, cuda)
    assert not use and "(10, 4), (13, 4)" in how
    use, how = ppo._choose("fused_loss", None, "auto", ppo._loss_refusal(cfg, wide_obs, cuda),
                           cuda)
    assert not use
    with pytest.raises(ValueError, match="fused_update refused"):
        ppo._choose("fused_update", None, "on", reason, cuda)
    # Two equal widths up to 256 take the wide instances; 512 is refused by name.
    for width in (32, 128, 256):
        wide = cfg._replace(hidden=(width, width))
        assert ppo._loss_refusal(wide, hover, cuda) is None
        use, how = ppo._choose("fused_update", None, "auto",
                               ppo._update_refusal(wide, hover, None, cuda), cuda,
                               ppo._instance_note(wide, hover))
        assert use and how == f"CUDA kernel (wide, H={width})"
    too_wide = cfg._replace(hidden=(512, 512))
    assert "hidden (512, 512)" in ppo._loss_refusal(too_wide, hover, cuda)
    use, how = ppo._choose("fused_update", None, "auto",
                           ppo._update_refusal(too_wide, hover, None, cuda), cuda)
    assert not use and "hidden (512, 512)" in how
    with pytest.raises(ValueError, match=r"fused_update refused: hidden \(512, 512\)"):
        ppo._choose("fused_update", None, "on", ppo._update_refusal(too_wide, hover, None, cuda),
                    cuda)
    assert "not two equal layers" in ppo._loss_refusal(cfg._replace(hidden=(64, 32)), hover, cuda)
    assert "no fused PPO rollout kernel" in ppo._rollout_refusal(
        cfg, reinmav_tpu_torch.make("MujocoQuadForce-v0"))
    from reinmav_tpu_torch.envs import tpuquad
    assert "frame_skip" in ppo._rollout_refusal(
        cfg, tpuquad.make_hovering(tpuquad.Params(init_z=1.0, frame_skip=3)))


def test_train_step_on_hover_runs_k6_hover_and_k4_twins(caplog):
    env = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    cfg = ppo.PpoConfig(num_envs=32, rollout_len=8, num_epochs=1, num_minibatches=2,
                        fused_rollout="on", fused_update="on")
    state = ppo.init_train_state(env, cfg, 0, device="cpu")
    assert state.params.shape == (networks.Layout(13, 4).size,)
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.rl.ppo"):
        state, summary = ppo.train_step(env, cfg, state)
    assert "rollout: K6-hover plain twin" in caplog.text and "K4 plain twin" in caplog.text
    assert all(np.isfinite(float(v)) for v in summary.values())
    assert 50.0 < float(summary["mean_reward"]) < 100.0


def test_shuffle_indices_is_a_permutation():
    gen = torch.Generator().manual_seed(3)
    for n in (1, 2, 64, 96, 1024):
        perm = ppo._shuffle_indices(gen, n)
        assert sorted(perm.tolist()) == list(range(n))
    assert ppo._tiling(ppo.PpoConfig(num_minibatches=4), 32768 * 32) == (128, 8192)
    assert ppo._tiling(ppo.PpoConfig(num_minibatches=2), 64 * 8) == (4, 128)
