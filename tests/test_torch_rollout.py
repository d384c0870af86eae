"""Kernel K1 (reinmav_tpu_torch.ops.rollout): its plain PyTorch twin
against the JAX package's Pallas kernel and the port's eager loop on the
CPU.  The CUDA kernel against the twin on the card is in
tests/test_torch_cuda.py.

Tolerances are the JAX kernel tests' own (tests/test_pallas_rollout.py):
float32 final states at rtol 2e-4 / atol 2e-5, the reward total at
rtol 1e-4.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.ops import pallas_rollout
from reinmav_tpu_torch.envs import quadrotor3d
from reinmav_tpu_torch.ops import rollout as ro

# Random123's known-answer vectors for Philox4x32-10.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
]
RTOL, ATOL, RTOL_REWARD = 2e-4, 2e-5, 1e-4


def _states_t(seed, batch, scale=1.0, device="cpu"):
    """(10, B) float32 U(-1,1)·scale states from a NumPy seed."""
    s = np.random.default_rng(seed).uniform(-1, 1, (batch, 10)) * scale
    return torch.tensor(s.T, dtype=torch.float32, device=device).contiguous()


# --- CPU: the plain twin ------------------------------------------------------


@pytest.mark.parametrize("ctr,key,expected", KAT)
def test_philox_known_answers(ctr, key, expected):
    got = ro.philox4x32_10(torch.tensor([ctr]), torch.tensor([key]))
    assert tuple(got[0].tolist()) == expected


def test_reset_draws_are_philox_words_in_u_pm1():
    idx = torch.arange(7, 4096, 13)
    draws = ro.reset_draws(idx, step=5, seed=11)
    assert draws.shape == (10, idx.numel()) and draws.dtype == torch.float32
    assert ((draws >= -1) & (draws < 1)).all()
    assert abs(float(draws.mean())) < 0.02 and abs(float(draws.var()) - 1 / 3) < 0.01
    # Component 5 is word 1 of draw 1: counter (env, step, 1, 0), key (seed, 0).
    ctr = torch.tensor([[int(idx[3]), 5, 1, 0]])
    bits = int(ro.philox4x32_10(ctr, torch.tensor([[11, 0]]))[0, 1])
    f12 = np.array([(bits >> 9) | 0x3F800000], np.uint32).view(np.float32)[0]
    assert float(draws[5, 3]) == float(np.float32(2.0) * (f12 - np.float32(1.0)) - np.float32(1.0))


def test_twin_matches_jax_pallas8_kernel():
    """The twin against quad3d_rollout_autoreset_pallas8 in interpret mode,
    on tame states where no env resets."""
    from jax.experimental.pallas import tpu as pltpu

    st = _states_t(2, 1024, scale=0.1)
    final, rew = ro.quad3d_rollout_reference(st, 3, 30)
    no_reset, _ = ro.quad3d_rollout_reference(st, 3, 30, autoreset=False)
    assert torch.equal(final, no_reset), "an env reset: the streams are not comparable"
    with pltpu.force_tpu_interpret_mode():
        j_final, j_rew = pallas_rollout.quad3d_rollout_autoreset_pallas8(
            jnp.asarray(st.numpy()), 3, 30, tile8=64)
    np.testing.assert_allclose(final.numpy(), np.asarray(j_final), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(rew.sum()), float(np.asarray(j_rew).sum()), rtol=RTOL_REWARD)


@pytest.mark.parametrize("params", [quadrotor3d.Params(), quadrotor3d.Params(ref_x=0.5, ref_z=1.5, mass=1.2, tau=0.4)])
def test_twin_without_reset_matches_control_rollout(params):
    env = quadrotor3d.make(params)
    st = _states_t(3, 512, scale=0.5)
    final, rew = ro.quad3d_rollout_reference(st, 0, 50, ro.quad3d_params_vec(params), autoreset=False)
    f_ref, traj = reinmav_tpu_torch.control_rollout(env, st.T, torch.Generator(), 50,
                                                    auto_reset=False)
    np.testing.assert_allclose(final.T.numpy(), f_ref.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(rew.sum()), float(traj.reward.sum()), rtol=RTOL_REWARD)


def test_twin_autoreset_redraws_done_envs_from_philox():
    """Envs outside the envelope are done at step 0 and take exactly the
    step-0 draw; envs inside are stepped as without reset."""
    st = _states_t(4, 256, scale=0.1)
    st[0, :100] = 5.0
    final, rew = ro.quad3d_rollout_reference(st, 9, 1)
    plain, plain_rew = ro.quad3d_rollout_reference(st, 9, 1, autoreset=False)
    assert torch.equal(final[:, :100], ro.reset_draws(torch.arange(100), 0, 9))
    assert torch.equal(final[:, 100:], plain[:, 100:])
    assert torch.equal(rew, plain_rew) and (rew[:100] == 1.0).all()


def test_twin_autoreset_envelope_and_determinism():
    st = _states_t(5, 512)
    f1, r1 = ro.quad3d_rollout_reference(st, 7, 200)
    f2, r2 = ro.quad3d_rollout_reference(st, 7, 200)
    f3, _ = ro.quad3d_rollout_reference(st, 8, 200)
    assert torch.equal(f1, f2) and torch.equal(r1, r2)
    assert not torch.equal(f1, f3)
    assert torch.isfinite(f1).all() and torch.isfinite(r1).all()
    assert float(f1[0:3].norm(dim=0).max()) < 3.5


def test_wrapper_on_cpu_runs_twin_and_counts_no_launch():
    st = _states_t(6, 64)
    before = ro.quad3d_rollout_autoreset.launches
    f, r = ro.quad3d_rollout_autoreset(st, 1, 20)
    f_ref, r_ref = ro.quad3d_rollout_reference(st, 1, 20)
    assert torch.equal(f, f_ref) and torch.equal(r, r_ref)
    assert f.dtype == r.dtype == torch.float32 and f.shape == (10, 64) and r.shape == (64,)
    assert ro.quad3d_rollout_autoreset.launches == before


@pytest.mark.parametrize("bad,err", [
    (lambda st: st.double(), TypeError),
    (lambda st: st[:9], ValueError),
    (lambda st: st.T, ValueError),
    (lambda st: st[:, :0], ValueError),
    (lambda st: st.T.contiguous().T, ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        ro.quad3d_rollout_autoreset(bad(_states_t(0, 16)), 0, 3)


def test_wrapper_rejects_bad_seed_horizon_and_params():
    st = _states_t(0, 16)
    with pytest.raises(ValueError, match="seed"):
        ro.quad3d_rollout_autoreset(st, 2**32, 3)
    with pytest.raises(ValueError, match="horizon"):
        ro.quad3d_rollout_autoreset(st, 0, -1)
    with pytest.raises(ValueError, match="params_vec"):
        ro.quad3d_rollout_autoreset(st, 0, 3, params_vec=torch.zeros(10))
    reordered = collections.namedtuple("Params", ro._Q3_FIELDS[::-1])(*range(11))
    with pytest.raises(ValueError, match="fields"):
        ro.quad3d_params_vec(reordered)
    np.testing.assert_array_equal(ro.quad3d_params_vec(reinmav_tpu.envs.quadrotor3d.Params()).numpy(),
                                  ro.quad3d_params_vec().numpy())
