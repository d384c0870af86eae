"""K4's plain twin (reinmav_tpu_torch.ops.ppo_update) against the JAX
package's one-launch update (reinmav_tpu.ops.pallas_ppo_update, in
interpret mode on the CPU), and against the port's own per-minibatch loop.

The JAX side is ``train_step(..., fused_loss=True, fused_update=True)``;
the port's side is the update phase that ``train_step(...,
fused_update=True)`` runs, on the JAX rollout's trajectory carried across,
with the epoch permutations rebuilt from the same JAX key stream.  512
envs x 64 steps, the 2x64 net, 2 epochs x 2 minibatches, in the three modes
of tests/test_pallas_ppo_update.py: clip, adaptive KL, and the log-std
floor with an entropy bonus; and clip on the hover task
(MujocoQuadForce-v1, obs 13), the hover update phase against the JAX
``train_step``.  Its tolerances: params rtol 2e-4 / atol 1e-6,
Adam moments rtol 2e-4 / atol 5e-8, metrics rtol 1e-4 / atol 1e-6, the
count exactly E * M and ``kl_beta`` exactly.  Two epochs, because the floor
clamp and Adam amplify 1e-7 gaps over more passes
(tests/test_pallas_ppo_update.py:111-115).  The JAX kernel takes Adam's
bias corrections as ``exp(t log b)`` in float32, the port in float64; the
tolerances cover that.  The seeds are that file's: at another (3), the
entropy bonus nearly cancels the log-std gradient in some pass, and the
JAX kernel then differs from the JAX loop by 1.7e-4 as much as the port
does (Adam divides the cancelled gradient by its own RMS).
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import reinmav_tpu_torch
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu_torch.ops import ppo_update as pu
from reinmav_tpu_torch.rl import networks, ppo
from test_torch_ppo import _jax_state, _perms_from_jax_keys, _port_state, _t

PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
MOMENT_TOL = dict(rtol=2e-4, atol=5e-8)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
#: mode -> (seed, config): tests/test_pallas_ppo_update.py's seed for each.
MODES = {"clip": (0, {}), "kl": (5, {"kl_target": 0.01}),
         "floor-entropy": (1, {"log_std_floor": -0.05, "entropy_coef": 0.01}),
         "clip-hover": (0, {})}
#: mode -> env id (quadrotor3d-v0 where not named).
ENV_OF = {"clip-hover": "MujocoQuadForce-v1"}


def _cfg(**kw):
    """tests/test_pallas_ppo_update.py's config, at 2 epochs x 2 minibatches."""
    return jppo.PpoConfig(num_envs=512, rollout_len=64, num_epochs=2, num_minibatches=2,
                          hidden=(64, 64), fused_loss="on", fused_rollout="off", shuffle_tile=128,
                          learning_rate=3e-3, max_grad_norm=0.5, **kw)


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **tol,
                               err_msg=what)


def _flat(tree):
    return networks.params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("mode", MODES)
def test_k4_twin_matches_jax_k4(mode):
    seed, kw = MODES[mode]
    env_id = ENV_OF.get(mode, "quadrotor3d-v0")
    jcfg = _cfg(**kw)
    env, jstate = _jax_state(jcfg, seed=seed, env_id=env_id)
    # The update and the rollout it runs, in one program (one compile).
    step = jax.jit(lambda s: (
        jppo.train_step(env, jcfg, s, dense8=False, fused_rollout=False, fused_loss=True,
                        fused_update=True),
        jppo.collect_rollout(env, jcfg, s.params, s.obs_norm, s.ret_norm, s.env_states,
                             s.env_returns, s.key, dense8=False)))
    with pltpu.force_tpu_interpret_mode():
        (s_ref, m_ref), (final, rets, key, traj, omom, rmom, raw_mean) = step(jstate)

    penv = reinmav_tpu_torch.make(env_id)
    pcfg = ppo.PpoConfig(**jcfg._asdict())
    rollout = ppo.Rollout(_t(final), _t(rets), ppo.Transition(*(
        _t(x) if x.dtype != np.bool_ else torch.from_numpy(np.array(x)) for x in traj)),
        ppo.RawObsMoments(*map(_t, omom)), ppo.RawObsMoments(*map(_t, rmom)), _t(raw_mean))
    _, n_tiles = ppo._tiling(pcfg, 512 * 64)
    perms = _perms_from_jax_keys(key, n_tiles, jcfg.num_epochs)
    launches = pu.ppo_update.launches
    state, summary = ppo.update_phase(penv, pcfg, _port_state(jstate, jcfg), rollout, perms,
                                      fused_loss=False, fused_update=True)
    assert pu.ppo_update.launches == launches  # the CPU runs the twin, not the kernel

    _close(state.params.numpy(), _flat(s_ref.params), PARAM_TOL, "params")
    adam = s_ref.opt_state[1][0]
    assert int(state.opt_state.count) == int(adam.count) == 4
    _close(state.opt_state.mu.numpy(), _flat(adam.mu), MOMENT_TOL, "adam mu")
    _close(state.opt_state.nu.numpy(), _flat(adam.nu), MOMENT_TOL, "adam nu")
    assert float(state.kl_beta) == float(s_ref.kl_beta)
    if "log_std_floor" in kw:
        assert float(state.params[:4].min()) >= -0.05
    assert state.params.shape == (networks.Layout(penv.obs_dim, 4).size,)
    assert set(summary) == set(m_ref)
    for name in m_ref:
        _close(float(summary[name]), float(m_ref[name]), METRIC_TOL, name)


@pytest.mark.parametrize("mode", MODES)
def test_k4_twin_matches_the_k3_loop(mode):
    """One update phase from one eager rollout: every pass in K4's twin,
    and the per-minibatch loop through K3's twin and ClipAdam."""
    env = reinmav_tpu_torch.make(ENV_OF.get(mode, "quadrotor3d-v0"))
    cfg = ppo.PpoConfig(num_envs=256, rollout_len=32, num_epochs=2, num_minibatches=2,
                        learning_rate=3e-3, **MODES[mode][1])
    state = ppo.init_train_state(env, cfg, seed=4, device="cpu")
    rollout = ppo.collect_rollout(env, cfg, state.params, state.obs_norm, state.ret_norm,
                                  state.env_states, state.env_returns,
                                  torch.Generator().manual_seed(5))
    _, n_tiles = ppo._tiling(cfg, 256 * 32)
    gen = torch.Generator().manual_seed(6)
    perms = [ppo._shuffle_indices(gen, n_tiles) for _ in range(cfg.num_epochs)]
    k4, m4 = ppo.update_phase(env, cfg, state, rollout, perms, fused_loss=False, fused_update=True)
    k3, m3 = ppo.update_phase(env, cfg, state, rollout, perms, fused_loss=True, fused_update=False)
    _close(k4.params.numpy(), k3.params.numpy(), PARAM_TOL, "params")
    _close(k4.opt_state.mu.numpy(), k3.opt_state.mu.numpy(), MOMENT_TOL, "adam mu")
    _close(k4.opt_state.nu.numpy(), k3.opt_state.nu.numpy(), MOMENT_TOL, "adam nu")
    assert int(k4.opt_state.count) == int(k3.opt_state.count) == 4
    assert float(k4.kl_beta) == float(k3.kl_beta)
    assert set(m4) == set(m3)
    for name in m3:
        _close(float(m4[name]), float(m3[name]), METRIC_TOL, name)


def test_k4_wrapper_checks_its_inputs():
    layout = networks.Layout(10, 4)
    n, tile = 1024, 32
    data = torch.zeros((18, n))
    params = torch.zeros(layout.size)
    opt = ppo.AdamState(torch.zeros((), dtype=torch.int32), params.clone(), params.clone())
    perm = torch.arange(n // tile, dtype=torch.int32).repeat(2)
    stats = torch.tensor([[0.0, 1.0]]).repeat(4, 1)
    kw = dict(d=10, adim=4, tile=tile, n_minibatches=2, n_epochs=2, clip_eps=0.2,
              value_clip_eps=0.2, value_coef=0.5, ent_coef=0.0, lr=3e-4, max_grad_norm=0.5)
    out = pu.ppo_update(data, stats, perm, params, opt, None, keep_grad0=True, **kw)
    assert int(out.opt_state.count) == 4 and out.grad0.shape == (layout.size,)
    assert set(out.metrics) == {"pg_loss", "v_loss", "approx_kl", "clip_frac", "entropy"}
    with pytest.raises(ValueError, match="perm_all"):
        pu.ppo_update(data, stats, perm[:-1], params, opt, None, **kw)
    with pytest.raises(ValueError, match="kl_beta"):
        pu.ppo_update(data, stats, perm, params, opt, None, kl_mode=True, **kw)
    with pytest.raises(ValueError, match="int32"):
        pu.ppo_update(data, stats, perm, params, opt._replace(count=torch.tensor(0)), None, **kw)
    with pytest.raises(TypeError, match="float32"):
        pu.ppo_update(data.double(), stats, perm, params, opt, None, **kw)
