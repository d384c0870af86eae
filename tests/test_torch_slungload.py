"""The slung-load envs (quadrotor2d-slungload-v0, quadrotor3d-slungload-v0)
in the PyTorch port against the JAX package, on the CPU.

- The envs: step and control in float64 against the JAX envs at 1e-12
  (default and swept Params, both tether branches populated); the
  closed loop against its golden and against the NumPy oracle,
  resynchronised every step as tests/test_goldens.py and
  tests/test_parity.py do (the taut branch leaves the load within an ulp
  of the tether sphere, where the next step's branch is fp-degenerate).
- K9's plain twin against the JAX kernels ``slung2d_rollout_pallas8`` /
  ``slung3d_rollout_pallas8`` in interpret mode, resynchronised every step
  and skipping the lanes within 1e-4 of the sphere
  (tests/test_pallas_slungload.py's strategy), at rtol 3e-4 / atol 3e-5,
  with both branches populated.
- The slung kinds of the policy kernels: K6's twin against
  ``ppo_rollout_pallas`` (sigma -> 0 and the stochastic invariants), K3's
  and K4's twins at (9, 2) and (16, 4) against the JAX kernels, K7's twin
  against ``collect_step_pallas``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.ops import pallas_slungload
from reinmav_tpu.rl import networks as jnet
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu.oracle import Quadrotor2DSlungloadOracle, Quadrotor3DSlungloadOracle
from reinmav_tpu_torch.envs import core
from reinmav_tpu_torch.ops.rollout import reset_draws
from test_torch_ppo_rollout import _port_rollout
from test_torch_quad2d import (_t64, check_k3, check_k4, check_k6_stochastic,
                               check_k7, check_params_from_jax, check_step_control_against_jax,
                               closed_loop_port, env_pair, far_out, tether_states)

IDS = ["quadrotor2d-slungload-v0", "quadrotor3d-slungload-v0"]
ORACLE = {"quadrotor2d-slungload-v0": Quadrotor2DSlungloadOracle,
          "quadrotor3d-slungload-v0": Quadrotor3DSlungloadOracle}
JAX_KERNEL = {"quadrotor2d-slungload-v0": pallas_slungload.slung2d_rollout_pallas8,
              "quadrotor3d-slungload-v0": pallas_slungload.slung3d_rollout_pallas8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tether(env_id, s):
    """Tether norms of ``(B, D)`` states and the tether length."""
    k = 3 if env_id.startswith("quadrotor3d") else 2
    return np.linalg.norm(s[:, -2 * k:-k] - s[:, 0:k], axis=1)


@pytest.mark.parametrize("swept", [False, True], ids=["default", "swept"])
@pytest.mark.parametrize("env_id", IDS)
def test_step_and_control_match_jax(env_id, swept, rng):
    check_step_control_against_jax(env_id, rng, swept)
    # Both branches were in that batch.
    jenv, _ = env_pair(env_id, swept)
    tn = _tether(env_id, tether_states(env_id, np.random.default_rng(0), 64))
    assert (tn >= jenv.params.tether_length).any() and (tn < jenv.params.tether_length).any()


@pytest.mark.parametrize("env_id", IDS)
def test_params_from_jax(env_id):
    check_params_from_jax(env_id)


@pytest.mark.parametrize("env_id", IDS)
def test_closed_loop_matches_golden_and_oracle_resynchronised(env_id):
    """Each transition from the golden's state against the golden's next
    state (rtol 1e-8 / atol 1e-9) and the oracle's (rtol 1e-10 / atol
    1e-12), skipping only the steps that start within 4 ulp of the
    sphere with the two disagreeing."""
    data = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                                f"{env_id}.npz"))
    env = reinmav_tpu_torch.make(env_id)
    L = env.params.tether_length
    skipped = 0
    prev = data["init"]
    for t in range(data["traj"].shape[0]):
        s = _t64(prev)
        out = env.step(s, env.control(s))
        oracle = ORACLE[env_id]()
        oracle.reset_to(prev)
        np.testing.assert_allclose(env.control(s).numpy(), oracle.control(), rtol=1e-10,
                                   atol=1e-12)
        ref, r, done, _ = oracle.step(oracle.control())
        got = out.state.numpy()
        boundary = abs(_tether(env_id, prev[None])[0] - L) < 4 * np.finfo(np.float64).eps
        if boundary and not np.allclose(got, data["traj"][t], rtol=1e-8, atol=1e-9):
            skipped += 1
        else:
            np.testing.assert_allclose(got, data["traj"][t], rtol=1e-8, atol=1e-9,
                                       err_msg=f"step {t}")
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12, err_msg=f"step {t}")
            assert float(out.reward) == pytest.approx(r, rel=1e-10, abs=1e-12)
            assert bool(out.done) == done
        prev = data["traj"][t]
    assert skipped < 10, skipped


@pytest.mark.parametrize("env_id", IDS)
def test_k9_twin_matches_jax_kernel_resynchronised(env_id):
    """512 envs x 30 steps: each step both sides start from the JAX
    kernel's state; lanes within 1e-4 of the sphere are skipped."""
    env = reinmav_tpu.make(env_id)
    states = np.asarray(env.vreset(jax.random.split(jax.random.PRNGKey(0), 512)) * 0.5,
                        np.float32)
    if env_id.startswith("quadrotor3d"):
        states[:, 10:13] *= 4.0  # tether norms straddle L = 1.5
    L = env.params.tether_length
    both, checked = 0, 0
    for t in range(30):
        with pltpu.force_tpu_interpret_mode():
            f_j, r_j = JAX_KERNEL[env_id](jnp.asarray(states.T), 0, 1, tile8=16, autoreset=False)
        f_t, r_t = closed_loop_port(env_id, states, 0, 1, autoreset=False)
        tn = _tether(env_id, states)
        safe = np.abs(tn - L) > 1e-4
        both += int((tn >= L).any() and (tn < L).any())
        checked += int(safe.sum())
        np.testing.assert_allclose(f_t.numpy()[:, safe], np.asarray(f_j)[:, safe], rtol=3e-4,
                                   atol=3e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(r_t.numpy()[safe], np.asarray(r_j)[safe], rtol=1e-3,
                                   atol=1e-4)
        states = np.asarray(f_j).T.copy()
    assert both > 15 and checked > 512 * 30 // 4, (both, checked)


@pytest.mark.parametrize("env_id", IDS)
def test_k9_twin_autoreset_and_param_sweep(env_id):
    """Done envs redraw U(-1, 1)^D from stream 0; a swept Params stays
    eligible for the kernel and the twin flies it as the eager env does
    over one step from each state of a batch."""
    rng = np.random.default_rng(7)
    states = tether_states(env_id, rng, 256).astype(np.float32)
    d = states.shape[1]
    k = 3 if d == 16 else 2
    far = states.copy()
    far[:, 0:k] = 9.0  # the quad far out, its load at rest beside it (slack)
    far[:, -2 * k:-k], far[:, -k:] = 9.0, 0.0
    f1, r1 = closed_loop_port(env_id, far, 4, 1, autoreset=True)
    assert bool((r1 == 1.0).all())
    assert torch.equal(f1, reset_draws(torch.arange(256), 0, 4, 0, d))
    f, _ = closed_loop_port(env_id, states, 4, 40, autoreset=True)
    assert bool(torch.isfinite(f).all())
    f2, _ = closed_loop_port(env_id, states, 4, 40, autoreset=True)
    assert torch.equal(f, f2)
    _, tenv = env_pair(env_id, swept=True)
    assert core.fused_kernel_mismatch(tenv) is None
    f_t, r_t = closed_loop_port(env_id, states, 0, 1, False, params=tenv.params)
    x = torch.from_numpy(states)
    out = tenv.vstep(x, tenv.vcontrol(x))
    tn = _tether(env_id, states)
    safe = np.abs(tn - tenv.params.tether_length) > 1e-4
    np.testing.assert_allclose(f_t.T.numpy()[safe], out.state.numpy()[safe], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("env_id", IDS)
def test_k6_sigma_zero_matches_jax_kernel_resynchronised(env_id):
    """tests/test_pallas_ppo_rollout.py's slung-load sigma -> 0 leg: one
    step at a time from the JAX kernel's state, both branches populated,
    the lanes within 1e-4 of the sphere skipped (a taut step parks them
    on it, where ulp-level differences pick the other branch)."""
    env = reinmav_tpu.make(env_id)
    batch = 64
    cfg = jppo.PpoConfig(num_envs=batch, rollout_len=1, hidden=(64, 64), fused_rollout="on")
    params = jnet.init_params(jax.random.PRNGKey(0), jnet.MlpConfig(env.obs_dim, env.action_dim))
    params["log_std"] = jnp.full_like(params["log_std"], -40.0)
    d = env.obs_dim
    obs_norm = jppo.ObsNorm(jnp.linspace(-0.1, 0.1, d).astype(jnp.float32),
                            jnp.linspace(0.5, 2.0, d).astype(jnp.float32),
                            jnp.asarray(100.0, jnp.float32))
    ret_norm = jppo.RetNorm(jnp.asarray(4.0, jnp.float32), jnp.asarray(100.0, jnp.float32))
    rets = jnp.linspace(-1.0, 1.0, batch).astype(jnp.float32)
    states = jnp.asarray(tether_states(env_id, np.random.default_rng(2), batch, 0.3), jnp.float32)
    L = env.params.tether_length
    taut = slack = checked = 0
    for t in range(8):
        port = _port_rollout(cfg, params, states, obs_norm, ret_norm, rets, env_id=env_id)
        with pltpu.force_tpu_interpret_mode():
            f_j, r_j, _, traj_j, _, _, _ = jppo._collect_rollout_pallas(
                env, cfg, params, obs_norm, ret_norm, states, rets, jax.random.PRNGKey(7))
        tn = _tether(env_id, np.asarray(states))
        safe = np.abs(tn - L) > 1e-4
        taut += int((tn >= L).sum())
        slack += int((tn < L).sum())
        checked += int(safe.sum())
        for a, b, name in ((port.traj.obs, traj_j.obs, "obs"),
                           (port.traj.action, traj_j.action, "action"),
                           (port.traj.log_prob, traj_j.log_prob, "log_prob"),
                           (port.traj.value, traj_j.value, "value"),
                           (port.traj.reward, traj_j.reward, "reward"),
                           (port.final_states.T, f_j.T, "final_states"),
                           (port.env_returns[None], r_j[None], "env_returns")):
            a = np.asarray(a, np.float32).reshape(-1, batch)[:, safe]
            b = np.asarray(b, np.float32).reshape(-1, batch)[:, safe]
            np.testing.assert_allclose(a, b, rtol=1e-4 if name == "log_prob" else 1e-5,
                                       atol=1e-4 if name == "log_prob" else 1e-5,
                                       err_msg=f"{name} step {t}")
        np.testing.assert_array_equal(port.traj.done.numpy().reshape(-1, batch)[:, safe],
                                      np.asarray(traj_j.done).reshape(-1, batch)[:, safe])
        assert not bool(port.traj.done.any())  # the reset streams are not comparable
        states, rets = f_j, r_j
    assert taut > 0 and slack > 0 and checked > batch * 8 // 4, (taut, slack, checked)


@pytest.mark.parametrize("env_id", IDS)
def test_k6_stochastic_invariants(env_id):
    rng = np.random.default_rng(4)
    check_k6_stochastic(env_id, tether_states(env_id, rng, 256).astype(np.float32), 8)


@pytest.mark.parametrize("d,a", [(9, 2), (16, 4)])
def test_k3_twin_matches_jax_kernel(d, a):
    check_k3(d, a, "clip")


@pytest.mark.parametrize("env_id", IDS)
def test_k4_twin_matches_jax_k4(env_id):
    check_k4(env_id)


@pytest.mark.parametrize("env_id", IDS)
def test_k7_matches_jax_kernel(env_id):
    rng = np.random.default_rng(6)
    states = far_out(env_id, tether_states(env_id, rng, 256), 32).astype(np.float32)
    check_k7(env_id, states, "sac_det" if env_id.startswith("quadrotor3d") else "td3_det")
