"""Kernel K5's plain twin (reinmav_tpu_torch.ops.hover_rollout) against the
JAX package's hover kernel (``pallas_tpuquad.hover_rollout_pallas8``, run
in interpret mode as tests/test_pallas_tpuquad.py runs it) and against the
port's eager env core, on the CPU in float32.

The hover task resets deterministically, so the comparison runs
free through the resets: 512 envs x 80 steps from perturbed hover states,
for the zero action (every env falls through z = 0.3 near step 37 and
resets) and for the JAX test's near-hover action.  Tolerances are that
test's own: states rtol 2e-4 / atol 2e-5, reward sums rtol 1e-4 / atol
1e-2.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu.ops import pallas_tpuquad
from reinmav_tpu_torch.envs import tpuquad
from reinmav_tpu_torch.ops import hover_rollout as hr

B, T = 512, 80
ACTIONS = [(0.0, 0.0, 0.0, 0.0), (0.75, 0.73, 0.74, 0.76)]
STATE_TOL = dict(rtol=2e-4, atol=2e-5)
REWARD_TOL = dict(rtol=1e-4, atol=1e-2)


def _states(seed=0):
    """tests/test_pallas_tpuquad.py's perturbed hover states, (B, 13) float32."""
    base = np.tile(np.asarray(pallas_tpuquad._INIT, np.float32), (B, 1))
    rng = np.random.default_rng(seed)
    base[:, :3] += rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    base[:, 7:13] = rng.uniform(-0.5, 0.5, (B, 6)).astype(np.float32)
    return base


@pytest.mark.parametrize("action", ACTIONS)
def test_twin_matches_jax_kernel_through_resets(action):
    from jax.experimental.pallas import tpu as pltpu

    base = _states()
    with pltpu.force_tpu_interpret_mode():
        f_pal, r_pal = pallas_tpuquad.hover_rollout_pallas8(jnp.asarray(base).T, T, tile8=8,
                                                            action=action)
    before = hr.hover_rollout.launches
    final, rew = hr.hover_rollout(torch.from_numpy(base.T.copy()), T, action=action)
    assert hr.hover_rollout.launches == before  # the CPU ran the twin
    np.testing.assert_allclose(final.numpy(), np.asarray(f_pal), **STATE_TOL)
    np.testing.assert_allclose(rew.numpy(), np.asarray(r_pal), **REWARD_TOL)
    if sum(action) == 0.0:
        assert float(final[2].min()) > 0.3  # every env reset


def test_twin_matches_the_eager_env_core():
    """throughput_rollout's eager loop (the env's matrix form, zero action)
    and K5's twin (the TPU kernel's component form) agree at the kernel
    tolerances; with live non-default Params too."""
    base = _states(1)
    for params in (tpuquad.Params(init_z=1.0), tpuquad.Params(init_z=0.8, mass=0.32, dt=0.008,
                                                               frame_skip=3)):
        env = tpuquad.make_hovering(params)
        f_eager, r_eager = reinmav_tpu_torch.throughput_rollout(
            env, torch.from_numpy(base), torch.Generator(), T, backend="scan")
        f_twin, r_twin = hr.hover_rollout(torch.from_numpy(base.T.copy()), T,
                                          params_vec=hr.hover_params_vec(params),
                                          frame_skip=params.frame_skip)
        np.testing.assert_allclose(f_twin.T.numpy(), f_eager.numpy(), **STATE_TOL)
        np.testing.assert_allclose(r_twin.numpy(), r_eager.numpy(), **REWARD_TOL)
    default = hr.hover_rollout(torch.from_numpy(base.T.copy()), T)[0]
    assert not torch.equal(default, f_twin)  # the params are live


def test_params_vec_and_wrapper_checks():
    np.testing.assert_array_equal(
        hr.hover_params_vec().numpy(),
        np.asarray(pallas_tpuquad.hover_params_vec(), np.float32))
    p = tpuquad.Params(init_z=0.7, mass=0.25, box_dims=(0.3, 0.2, 0.1))
    from reinmav_tpu.envs import tpuquad as jtq

    jp = jtq.Params(init_z=0.7, mass=0.25, box_dims=(0.3, 0.2, 0.1))
    np.testing.assert_array_equal(hr.hover_params_vec(p).numpy(),
                                  np.asarray(pallas_tpuquad.hover_params_vec(jp), np.float32))
    with pytest.raises(ValueError, match="tpuquad.Params"):
        hr.hover_params_vec(tpuquad.QuatParams())
    s = torch.from_numpy(_states()[:8].T.copy())
    with pytest.raises(TypeError, match="float32"):
        hr.hover_rollout(s.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        hr.hover_rollout(s.T.contiguous().T, 2)
    with pytest.raises(ValueError, match=r"\(13, B\)"):
        hr.hover_rollout(s[:10].contiguous(), 2)
    with pytest.raises(ValueError, match="frame_skip"):
        hr.hover_rollout(s, 2, frame_skip=0)
    with pytest.raises(ValueError, match="params_vec"):
        hr.hover_rollout(s, 2, params_vec=hr.hover_params_vec()[:-1])
    # A ragged batch, horizon 0.
    f0, r0 = hr.hover_rollout(s[:, :5].contiguous(), 0)
    assert torch.equal(f0, s[:, :5]) and torch.equal(r0, torch.zeros(5))


def test_throughput_rollout_kernel_refusals_on_the_cpu():
    env = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    s = torch.from_numpy(_states()[:8])
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        reinmav_tpu_torch.throughput_rollout(env, s, torch.Generator(), 2, backend="kernel")
    wrapped = dataclasses.replace(env, step_fn=lambda p, x, a: tpuquad.hovering_step(p, x, a))
    with pytest.raises(ValueError, match="wrapped"):
        reinmav_tpu_torch.throughput_rollout(wrapped, s, torch.Generator(), 2, backend="kernel")
