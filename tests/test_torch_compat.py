"""The port's gymnasium adapters (reinmav_tpu_torch.compat) on the CPU,
against the JAX package's (reinmav_tpu.compat).

gymnasium's own env checker on all eight ids; registration under the
port's ``reinmav_tpu_torch/`` prefix beside the JAX package's
``reinmav_tpu/``; seeding, an injected state, truncation against
termination, params and wrappers, the renderers through the adapter.
Both adapters step float32 states, so the port's are held to the JAX
adapter's at rtol 1e-5 / atol 1e-6 from the same injected states and
actions (the vector adapter's ``final_obs`` and its step from given
states too; the resets themselves come from different generators).
"""

import functools
import math
import os
import warnings

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

import reinmav_tpu  # noqa: E402
import reinmav_tpu_torch  # noqa: E402
from reinmav_tpu.compat import gym_env as jgym  # noqa: E402
from reinmav_tpu.compat import vector_env as jvec  # noqa: E402
from reinmav_tpu_torch.compat import gym_env, vector_env  # noqa: E402
from reinmav_tpu_torch.envs import quadrotor3d, wrappers  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_register_all_under_the_ports_prefix():
    gym_env.register_all()
    jgym.register_all()
    assert reinmav_tpu_torch.registered_ids() == reinmav_tpu.registered_ids()
    for env_id in reinmav_tpu_torch.registered_ids():
        assert f"reinmav_tpu_torch/{env_id}" in gymnasium.registry
        assert f"reinmav_tpu/{env_id}" in gymnasium.registry
    e = gymnasium.make("reinmav_tpu_torch/quadrotor3d-v0", **CPU)
    assert isinstance(e.unwrapped, gym_env.GymAdapter) and e.unwrapped.device.type == "cpu"
    assert isinstance(gymnasium.make("reinmav_tpu/quadrotor3d-v0").unwrapped, jgym.GymAdapter)
    assert gym_env.make("reinmav_tpu_torch/quadrotor2d-v0", **CPU).env.name == "quadrotor2d-v0"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only refusal")
def test_the_default_device_is_the_card_without_a_fallback():
    with pytest.raises(RuntimeError):
        gym_env.make("quadrotor3d-v0")
    with pytest.raises(RuntimeError):
        vector_env.make_vec("quadrotor3d-v0", 4)


def test_gymnasium_official_env_checker_all_ids():
    from gymnasium.utils.env_checker import check_env

    for env_id in reinmav_tpu_torch.registered_ids():
        e = gym_env.make(env_id, render_mode="rgb_array", **CPU)
        with warnings.catch_warnings():
            # The reference's spaces are not normalised to [-1, 1]; the
            # checker warns about style, as for the JAX adapter.
            warnings.simplefilter("ignore")
            check_env(e, skip_render_check=True)


def test_seeding_and_the_injected_state_match_the_jax_adapter(rng):
    e1, e2 = gym_env.make("quadrotor3d-v0", **CPU), gym_env.make("quadrotor3d-v0", **CPU)
    o1, _ = e1.reset(seed=42)
    o2, _ = e2.reset(seed=42)
    np.testing.assert_array_equal(o1, o2)
    assert not np.array_equal(o1, e1.reset(seed=43)[0])
    for env_id, dim in (("quadrotor3d-v0", 10), ("quadrotor2d-slungload-v0", 9),
                        ("MujocoQuadForce-v1", 13)):
        port, ref = gym_env.make(env_id, **CPU), jgym.make(env_id)
        s = ref.reset(seed=5)[0] if dim == 13 else rng.uniform(-0.5, 0.5, dim)
        p_obs, _ = port.reset(options={"state": s})
        j_obs, _ = ref.reset(options={"state": s})
        np.testing.assert_array_equal(p_obs, j_obs)
        for _ in range(20):
            a = rng.uniform(-0.3, 0.3, port.action_space.shape).astype(np.float32)
            if dim == 13:
                a += 0.7
            got, want = port.step(a), ref.step(a)
            np.testing.assert_allclose(got[0], want[0], err_msg=env_id, **TOL)
            np.testing.assert_allclose(got[1], want[1], err_msg=env_id, **TOL)
            assert got[2:4] == want[2:4]
        if env_id != "MujocoQuadForce-v1":
            np.testing.assert_allclose(port.control(), ref.control(), **TOL)


def test_reference_pattern_flies_quadrotor3d():
    """The reference smoke test (test_quadrotor3d.py:12-24) through the
    adapter: 400 steps of control() + step(), reset on termination."""
    env = gym_env.make("quadrotor3d-v0", **CPU)
    obs, _ = env.reset(seed=0)
    resets = 0
    for _ in range(400):
        obs, reward, term, trunc, _ = env.step(env.control())
        assert np.isfinite(obs).all() and math.isfinite(reward)
        if term:
            obs, _ = env.reset()
            resets += 1
    assert np.linalg.norm(obs[:3] - np.array([0, 0, 2.0])) < 1.0 or resets > 0


def test_truncation_vs_termination_and_the_actionless_env():
    """As tests/test_compat.py: a time-limited env reports truncated, not
    terminated, at the horizon; termination stays the inner env's."""
    e = gym_env.GymAdapter("quadrotor3d-v0", params=quadrotor3d.Params(ref_z=5.0),
                           wrappers=[functools.partial(wrappers.time_limit, max_steps=4)], **CPU)
    assert e.env.params.ref_z == 5.0
    benign = np.zeros(11, np.float32)
    benign[2], benign[3] = 0.5, 1.0
    e.reset(options={"state": benign})
    for i in range(4):
        _, _, term, trunc, _ = e.step(e.control())
        assert (term, trunc) == (False, i == 3)
    far = benign.copy()
    far[0], far[7] = 2.9, 50.0
    e.reset(options={"state": far})
    _, _, term, trunc, _ = e.step(np.zeros(4, np.float32))
    assert term and not trunc

    r = gym_env.make("reinmav-v0", **CPU)
    assert r.action_space.shape == (1,)
    obs, _ = r.reset()
    obs, reward, term, _, _ = r.step(np.zeros(1))
    assert obs.shape == (13,) and reward == 90.0 and term  # PARITY.md Q9


def test_render_plot_and_html_through_the_adapter(tmp_path):
    e = gym_env.make("quadrotor3d-slungload-v0", render_mode="rgb_array", **CPU)
    e.reset(seed=1)
    for _ in range(3):
        e.step(e.control())
    frame = e.render()
    assert frame.ndim == 3 and frame.shape[2] == 3 and frame.dtype == np.uint8
    paths = e.plot_state(str(tmp_path / "traj"))
    assert len(paths) == 4 and all(os.path.exists(p) for p in paths)
    html = e.render_html(str(tmp_path / "ep.html"))
    assert os.path.getsize(html) > 1000


class TestVectorAdapter:
    def test_spaces_shapes_and_seeding(self):
        v = vector_env.make_vec("quadrotor3d-v0", 8, **CPU)
        obs, _ = v.reset(seed=0)
        assert obs.shape == (8, 10) and obs.dtype == np.float32
        assert v.observation_space.shape == (8, 10) and v.action_space.shape == (8, 4)
        obs, rew, term, trunc, infos = v.step(np.zeros((8, 4), np.float32))
        assert obs.shape == (8, 10) and rew.shape == (8,) and rew.dtype == np.float64
        assert term.dtype == bool and trunc.dtype == bool and term.shape == trunc.shape == (8,)
        v2 = vector_env.make_vec("quadrotor3d-v0", 8, **CPU)
        o1, _ = v.reset(seed=42)
        o2, _ = v2.reset(seed=42)
        np.testing.assert_array_equal(o1, o2)
        a = np.full((8, 4), 0.3, np.float32)
        s1, s2 = v.step(a), v2.step(a)
        np.testing.assert_array_equal(s1[0], s2[0])
        np.testing.assert_array_equal(s1[1], s2[1])
        assert vector_env.make_vec("reinmav-v0", 2, **CPU).single_action_space.shape == (1,)

    def test_same_step_autoreset_matches_the_jax_adapter_from_given_states(self, rng):
        """From the same states and actions, the terminal obs in
        infos["final_obs"], its mask, rewards and flags are the JAX
        adapter's; the envs that did not end continue identically, the
        ones that did start from fresh U(-1, 1) resets."""
        from gymnasium.vector import AutoresetMode

        n = 64
        port, ref = vector_env.make_vec("quadrotor3d-v0", n, **CPU), jvec.make_vec(
            "quadrotor3d-v0", n)
        assert port.metadata["autoreset_mode"] == AutoresetMode.SAME_STEP
        port.reset(seed=3)
        ref.reset(seed=3)
        states = rng.uniform(-1, 1, (n, 10)).astype(np.float32)
        states[:8, 0] = 2.99  # these leave the position envelope
        states[:8, 7] = 3.0
        port._states = torch.from_numpy(states)
        ref._states = jvec.jnp.asarray(states)
        saw = 0
        for _ in range(5):
            a = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
            p_obs, p_rew, p_term, p_trunc, p_inf = port.step(a)
            j_obs, j_rew, j_term, j_trunc, j_inf = ref.step(a)
            np.testing.assert_array_equal(p_term, j_term)
            np.testing.assert_array_equal(p_trunc, j_trunc)
            np.testing.assert_allclose(p_rew, j_rew, **TOL)
            assert ("final_obs" in p_inf) == ("final_obs" in j_inf)
            ended = p_term | p_trunc
            if ended.any():
                saw += int(ended.sum())
                np.testing.assert_array_equal(p_inf["_final_obs"], ended)
                np.testing.assert_allclose(p_inf["final_obs"][ended], j_inf["final_obs"][ended],
                                           **TOL)
                assert np.isnan(p_inf["final_obs"][~ended]).all()
                assert np.all(np.abs(p_obs[ended]) <= 1.0)
            np.testing.assert_allclose(p_obs[~ended], j_obs[~ended], **TOL)
            # The next step starts both from the same states again.
            ref._states = jvec.jnp.asarray(port._states.numpy())
        assert saw >= 8

    def test_time_limit_truncation(self):
        v = vector_env.make_vec("MujocoQuadForce-v1", 4, wrappers=(
            lambda e: wrappers.time_limit(e, 5),), **CPU)
        v.reset(seed=0)
        hover = np.full((4, 4), 0.73575, np.float32)
        for _ in range(5):
            _, _, term, trunc, infos = v.step(hover)
        assert trunc.all() and not term.any() and infos["_final_obs"].all()
