"""reinmav-v0 in the PyTorch port against the JAX package, on the CPU: the
env (reinmav_tpu_torch.envs.reinmav13) against reinmav_tpu's in float64,
its 50/51 substep pattern in both dtypes, kernel K10's plain twin
(reinmav_tpu_torch.ops.reinmav_rollout) against the JAX kernel
(``pallas_reinmav.reinmav_rollout_pallas8``, in interpret mode as
tests/test_pallas_rollout.py runs it) and the JAX scan path in float32, and
throughput_rollout's plain (no-reset) eager loop.

Tolerances: the env at 1e-10 in float64 (the same arithmetic up to the
matrix products' order).  The twin against the JAX kernel at 1e-3 abs over
B = 256 x T = 20, tests/test_pallas_rollout.py's own: the JAX kernel's
polynomial atan2/asin against the library's, through about 1000 stiff
substeps.  Against the JAX scan path (its inverse inertia inverted in
float32, its mixer a matrix product) at 1e-3 of max(1, |value|): the body
rates, up to 10 rad/s here, part by up to 1.5e-3 there (1.5e-4 relative),
the other components by at most 2e-6.
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
from reinmav_tpu.envs import reinmav13 as jr13
from reinmav_tpu_torch.envs import core, reinmav13
from reinmav_tpu_torch.ops import reinmav_rollout as rr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _perturbed(batch, seed, scale=0.05):
    """The init state plus U(-scale, scale) on the 13 states, t = 0, float64."""
    rng = np.random.default_rng(seed)
    s = np.tile(np.asarray(reinmav13.INIT_STATE + (0.0,)), (batch, 1))
    s[:, :13] += rng.uniform(-scale, scale, (batch, 13))
    return s


def test_env_step_matches_jax_in_float64():
    """50 steps of perturbed states through both envs: state, obs, reward
    and done at 1e-10."""
    s0 = _perturbed(32, 0)
    jenv, tenv = reinmav_tpu.make("reinmav-v0"), reinmav_tpu_torch.make("reinmav-v0")
    jstep = jax.jit(jax.vmap(lambda s: jenv.step(s, None)))
    x, y = jnp.asarray(s0), torch.tensor(s0)
    for _ in range(50):
        jo = jstep(x)
        to = tenv.vstep(y, None)
        np.testing.assert_allclose(to.state.numpy(), np.asarray(jo.state), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(to.reward.numpy(), np.asarray(jo.reward))
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
        x, y = jo.state, to.state
    # One env (14,) steps as a batch of one.
    one = tenv.step(torch.tensor(s0[0]), None)
    np.testing.assert_allclose(one.state.numpy(),
                               np.asarray(jenv.step(jnp.asarray(s0[0]), None).state),
                               rtol=1e-10, atol=1e-10)
    assert tenv.action_dim == 0 and tenv.obs_dim == 13 and tenv.state_dim == 14
    reset = tenv.vreset(torch.Generator(), 3, dtype=torch.float64)
    np.testing.assert_array_equal(reset.numpy(),
                                  np.tile(np.asarray(jr13.reset(jr13.Params(), None)), (3, 1)))


def _pattern(dtype, steps=400):
    t = torch.zeros((), dtype=dtype)
    dt, ds = torch.tensor(0.01, dtype=dtype), torch.tensor(1.0 / 5000.0, dtype=dtype)
    out = []
    for _ in range(steps):
        out.append(int(reinmav13.substep_count(t, dt, ds)))
        t = t + dt
    return np.asarray(out)


def test_substep_patterns_in_both_dtypes():
    """tests/test_reinmav_f32_substeps.py's pinned pattern: over 400 steps
    from t = 0, float64 gives 188 x 51 and float32 14 x 51; the env's own
    carry follows it, and so do the kernels' counts (substep_counts)."""
    n64, n32 = _pattern(torch.float64), _pattern(torch.float32)
    assert set(n64) == {50, 51} and set(n32) == {50, 51}
    assert (n64 == 51).sum() == 188 and (n32 == 51).sum() == 14 and (n64 != n32).sum() == 176
    np.testing.assert_array_equal(rr.substep_counts(torch.zeros(1), 400)[:, 0].numpy(), n32)
    env = reinmav_tpu_torch.make("reinmav-v0")
    for dtype, expected in ((torch.float64, n64), (torch.float32, n32)):
        s = env.vreset(torch.Generator(), 1, dtype=dtype)
        got = []
        for _ in range(40):
            t = s[0, 13]
            got.append(int(reinmav13.substep_count(t, t.new_tensor(0.01), t.new_tensor(0.0002))))
            s = env.vstep(s, None).state
        np.testing.assert_array_equal(got, expected[:40])


def _jax_float32_states(batch=256):
    """tests/test_pallas_rollout.py's reinmav inputs, (B, 14) float32."""
    env = reinmav_tpu.make("reinmav-v0")
    key = jax.random.PRNGKey(0)
    states = jnp.tile(env.reset(key), (batch, 1)).astype(jnp.float32)
    pert = jax.random.uniform(key, (batch, 13), minval=-0.05, maxval=0.05).astype(jnp.float32)
    return states.at[:, :13].add(pert)


def test_twin_matches_jax_kernel_and_scan_path():
    from jax.experimental.pallas import tpu as pltpu

    from reinmav_tpu.ops.pallas_reinmav import reinmav_rollout_pallas8

    T = 20
    states = _jax_float32_states()
    with pltpu.force_tpu_interpret_mode():
        f_pal = np.asarray(reinmav_rollout_pallas8(states.T, T, tile8=32).T)
    env = reinmav_tpu.make("reinmav-v0")
    scan = jax.jit(jax.vmap(lambda s: jax.lax.scan(
        lambda c, _: (env.step(c, jnp.zeros(0)).state, None), s, None, length=T)[0]))
    f_scan = np.asarray(scan(states))

    before = rr.reinmav_rollout.launches
    twin, counts = rr.reinmav_rollout(torch.tensor(np.asarray(states).T.copy()), T,
                                      record_substeps=True)
    assert rr.reinmav_rollout.launches == before  # the CPU ran the twin
    twin = twin.T.numpy()
    assert np.abs(twin - f_pal).max() <= 1e-3
    assert (np.abs(twin - f_scan) / np.maximum(1.0, np.abs(f_scan))).max() <= 1e-3
    np.testing.assert_allclose(twin[:, 13], T / 100.0, rtol=1e-5)
    np.testing.assert_array_equal(twin[:, 13], f_pal[:, 13])
    np.testing.assert_array_equal(counts.numpy(), rr.substep_counts(torch.zeros(256), T).numpy())


def test_throughput_rollout_steps_without_reset(caplog):
    """The CPU runs the plain eager loop and says why: no reset, reward sums
    90 T exactly, the time T / 100; in float64 the JAX package's loop gives
    the same states."""
    env = reinmav_tpu_torch.make("reinmav-v0")
    s0 = _perturbed(16, 1)
    T = 30
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        final, rew = reinmav_tpu_torch.throughput_rollout(env, torch.tensor(s0), torch.Generator(),
                                                          T)
    assert "eager loop (states on cpu, the kernel needs a CUDA tensor)" in caplog.text
    assert torch.equal(rew, torch.full((16,), 90.0 * T, dtype=torch.float64))
    np.testing.assert_allclose(final[:, 13].numpy(), T / 100.0, rtol=1e-12)
    j_final, j_rew = reinmav_tpu.throughput_rollout(reinmav_tpu.make("reinmav-v0"),
                                                    jnp.asarray(s0), jax.random.PRNGKey(0), T)
    np.testing.assert_allclose(final.numpy(), np.asarray(j_final), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(rew.numpy(), np.asarray(j_rew))
    f32, r32 = reinmav_tpu_torch.throughput_rollout(env, env.vreset(torch.Generator(), 4), None, T)
    assert r32.dtype == torch.float32 and bool((r32 == 90.0 * T).all())
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        reinmav_tpu_torch.throughput_rollout(env, torch.tensor(s0), None, 2, backend="kernel")


def test_params_from_jax_round_trip():
    jp = jr13.Params(mass=0.2, inertia=((3e-4, 0.0, 1e-6), (0.0, 2e-4, 0.0), (1e-6, 0.0, 4e-4)),
                     kp=(8.0, 9.0, 30.0), t_max=3.0)
    tp = reinmav13.params_from_jax(jp)
    assert tp == reinmav13.Params(mass=0.2, inertia=jp.inertia, kp=(8.0, 9.0, 30.0), t_max=3.0)
    assert reinmav13.params_from_jax(jp._asdict()) == tp
    assert reinmav13.params_from_jax(jr13.Params()) == reinmav13.Params()
    with pytest.raises(ValueError, match="fields"):
        reinmav13.params_from_jax(reinmav_tpu.make("quadrotor3d-v0").params)
    with pytest.raises(ValueError, match="shape"):
        reinmav13.params_from_jax({**jp._asdict(), "kp": (1.0, 2.0)})
    # The kernel's vector: the fields, then the constants derived in float64.
    vec = rr.reinmav_params_vec(tp).numpy()
    c = dict(zip(rr.KERNEL_FIELDS, vec))
    inv = np.linalg.inv(np.asarray(jp.inertia))
    np.testing.assert_array_equal([c[f"j{r}{k}"] for r in range(3) for k in range(3)],
                                  inv.reshape(-1).astype(np.float32))
    assert c["inv_mass"] == np.float32(1.0 / 0.2) and c["cv2"] == np.float32(60.0 / 3.0)
    assert c["max_force4"] == np.float32(3.5316 / 4.0) and len(vec) == len(rr.KERNEL_FIELDS)
    with pytest.raises(ValueError, match="reinmav13.Params"):
        rr.reinmav_params_vec(jp)
    # The env's step with the carried params is the JAX env's.
    s0 = _perturbed(4, 2)
    got = reinmav13.make(tp).vstep(torch.tensor(s0), None).state.numpy()
    want = np.asarray(jax.vmap(lambda s: _jax_step(jp, s))(jnp.asarray(s0)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def _jax_step(p, s):
    return jr13.step(p, s, None).state


def test_the_kernel_dispatch_refuses_by_identity(caplog):
    env = reinmav_tpu_torch.make("reinmav-v0")
    assert core.fused_kernel_mismatch(env) is None
    assert core.fused_kernel_mismatch(reinmav13.make(reinmav13.Params(mass=0.2))) is None
    wrapped = dataclasses.replace(env, step_fn=lambda p, s, a: reinmav13.step(p, s, a))
    assert "wrapped" in core.fused_kernel_mismatch(wrapped)
    with pytest.raises(ValueError, match="wrapped"):
        reinmav_tpu_torch.throughput_rollout(wrapped, env.vreset(torch.Generator(), 2), None, 2,
                                             backend="kernel")
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        reinmav_tpu_torch.throughput_rollout(wrapped, env.vreset(torch.Generator(), 2), None, 2)
    assert "eager loop (env step/control/reset fns are wrapped or replaced)" in caplog.text
    foreign = dataclasses.replace(env, params=jr13.Params())
    assert "not the kernel's Params" in core.fused_kernel_mismatch(foreign)


def test_wrapper_checks():
    s = torch.tensor(_perturbed(8, 3).T.copy(), dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        rr.reinmav_rollout(s.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        rr.reinmav_rollout(s.T.contiguous().T, 2)
    with pytest.raises(ValueError, match=r"\(14, B\)"):
        rr.reinmav_rollout(s[:13].contiguous(), 2)
    with pytest.raises(ValueError, match="params_vec"):
        rr.reinmav_rollout(s, 2, params_vec=rr.reinmav_params_vec()[:-1])
    final, counts = rr.reinmav_rollout(s[:, :5].contiguous(), 0, record_substeps=True)
    assert torch.equal(final, s[:, :5]) and counts.shape == (0, 5)


def test_k10_layout_choice_and_its_checks():
    """The layout K10's wrapper picks by the batch and the card's SM count
    (PERF.md section 6, K10): 2 warps an env while one env a thread would
    give a warp scheduler at most 1.5 warps (25,344 envs on 132 SMs), else
    one env a thread; a lanes_per_env other than 1, 2 or None raises,
    on the CPU too, where every layout runs the twin."""
    assert [rr.lanes_per_env_for(b, 132) for b in (1, 8192, 16_384, 24_576, 25_344, 25_345,
                                                   32_768, 131_072, 2_097_152)] == \
        [2, 2, 2, 2, 2, 1, 1, 1, 1]
    assert [rr.lanes_per_env_for(8192, sms) for sms in (16, 32, 43, 132)] == [1, 1, 2, 2]
    s = torch.tensor(_perturbed(8, 3).T.copy(), dtype=torch.float32)
    for bad in (0, 3, 4, 8, 1.5, "2"):
        with pytest.raises(ValueError, match="lanes_per_env"):
            rr.reinmav_rollout(s, 2, lanes_per_env=bad)
    want = rr.reinmav_rollout_reference(s, 2)
    for lanes in (None, 1, 2):
        assert torch.equal(rr.reinmav_rollout(s, 2, lanes_per_env=lanes), want)
