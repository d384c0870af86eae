"""The last two kernels on the card against their plain PyTorch twins: K10
(reinmav-v0's rollout of 50/51-substep steps) and K11 (the contact envs'
constant-action rollout, MujocoQuadForce-v0 and MujocoQuadQuat-v0); and
throughput_rollout launching them.  Every test needs a CUDA device and the
``nvcc`` that builds the kernels, and skips without a device.

This file imports no JAX, so that it runs where only PyTorch is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_reinmav_contact.py

Tolerances:

- K10: max |err| <= 1e-3 against the twin, free-running from t = 0
  (tests/test_pallas_rollout.py's own for the reinmav kernel); the kernel
  is built without FMA contraction, as its twin computes.  The live
  substep count of every step and env equal to the twin's: a count that
  differs is a 0.2 ms shift of simulated time, not a tolerance.
- K11: rtol 2e-4 / atol 2e-5 per value (the JAX kernel tests' float32
  tolerances), one step at a time from the twin's state, as
  tests/test_pallas_tpuquad.py resynchronises; the envs with a contact
  candidate within 1e-6 of the plane at the step's start or its middle
  (the active test's knife edge) are skipped and counted.  The
  16-candidate tier bitwise the forced 48-candidate sweep on states with
  core and cap contacts only; a rerun bitwise equal.
"""

import logging

import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.envs import reinmav13, tpuquad
from reinmav_tpu_torch.ops import contact_rollout as cr
from reinmav_tpu_torch.ops import reinmav_rollout as rr

TOL = dict(rtol=2e-4, atol=2e-5)
CONTACT = ["MujocoQuadForce-v0", "MujocoQuadQuat-v0"]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _reinmav_states(device, batch, seed, t_max=0.0):
    """reinmav-v0's init state perturbed by U(-0.05, 0.05), times in [0, t_max]."""
    rng = np.random.default_rng(seed)
    s = np.tile(np.asarray(reinmav13.INIT_STATE + (0.0,), np.float32), (batch, 1))
    s[:, :13] += rng.uniform(-0.05, 0.05, (batch, 13))
    s[:, 13] = rng.uniform(0.0, t_max, batch)
    return torch.tensor(s.T.copy(), device=device)


def _contact_states(device, batch, seed, tilt=0.25, z_lo=0.0):
    """tests/test_pallas_tpuquad.py's contact-heavy states, ``(13, B)``: the
    z = 0 pose raised by U(z_lo, 0.05), the quaternion tilted by U(-tilt,
    tilt) and renormalised, velocities and rates U(-0.2, 0.2)."""
    rng = np.random.default_rng(seed)
    s = np.zeros((batch, 13), np.float32)
    s[:, 3] = 1.0
    s[:, 2] += rng.uniform(z_lo, 0.05, batch)
    s[:, 4:7] += rng.uniform(-tilt, tilt, (batch, 3))
    s[:, 7:13] += rng.uniform(-0.2, 0.2, (batch, 6))
    s[:, 3:7] /= np.linalg.norm(s[:, 3:7], axis=1, keepdims=True)
    return torch.tensor(s.T.copy(), device=device)


def test_k10_matches_twin_and_counts_alike(cuda):
    states = _reinmav_states(cuda, 4096 + 37, 0)  # a ragged tail
    before = rr.reinmav_rollout.launches
    f_k, n_k = rr.reinmav_rollout(states, 20, record_substeps=True)
    torch.cuda.synchronize()
    assert rr.reinmav_rollout.launches == before + 1
    f_p, n_p = rr.reinmav_rollout_reference(states, 20, record_substeps=True)
    assert torch.equal(n_k, n_p) and set(n_k.unique().tolist()) <= {50, 51}
    assert float((f_k - f_p).abs().max()) <= 1e-3
    assert torch.equal(f_k[13], f_p[13])
    assert torch.equal(f_k, rr.reinmav_rollout(states, 20))


def test_k10_substep_counts_over_the_horizon(cuda):
    """500 steps from t = 0 and from random times: the kernel's counts are
    substep_counts' (float32 accumulation), 14 x 51 in the first 400 steps
    from t = 0, as the JAX package pins it."""
    states = _reinmav_states(cuda, 8192, 1, t_max=2.0)
    states[13, :4096] = 0.0
    _, n_k = rr.reinmav_rollout(states, 500, record_substeps=True)
    assert torch.equal(n_k, rr.substep_counts(states[13], 500))
    assert int((n_k[:400, 0] == 51).sum()) == 14


def test_k10_takes_live_params(cuda):
    p = reinmav13.Params(mass=0.2, t_max=3.0, kp=(8.0, 8.0, 30.0))
    states = _reinmav_states(cuda, 2048, 2)
    vec = rr.reinmav_params_vec(p)
    f_k = rr.reinmav_rollout(states, 10, params_vec=vec)
    f_p = rr.reinmav_rollout_reference(states, 10, params_vec=vec)
    assert float((f_k - f_p).abs().max()) <= 1e-3
    assert not torch.equal(f_k, rr.reinmav_rollout(states, 10))


def test_throughput_rollout_launches_k10(cuda, caplog):
    env = reinmav_tpu_torch.make("reinmav-v0")
    gen = torch.Generator(device=cuda).manual_seed(0)
    states = env.vreset(gen, 8192)
    before = rr.reinmav_rollout.launches
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        final, rew = reinmav_tpu_torch.throughput_rollout(env, states, gen, 20)
    torch.cuda.synchronize()
    assert rr.reinmav_rollout.launches == before + 1 and "fused CUDA kernel" in caplog.text
    assert bool((rew == 1800.0).all()) and bool(torch.isfinite(final).all())
    assert bool((final[:, 13] == final[0, 13]).all()) and abs(float(final[0, 13]) - 0.2) < 1e-6
    f_e, r_e = reinmav_tpu_torch.throughput_rollout(env, states[:64], gen, 20, backend="scan")
    assert float((final[:64] - f_e).abs().max()) <= 1e-3 and torch.equal(r_e, rew[:64])


@pytest.mark.parametrize("env_id", CONTACT)
def test_k11_matches_twin_step_by_step(cuda, env_id):
    env = reinmav_tpu_torch.make(env_id)
    vec = cr.contact_params_vec(env.params)
    x = _contact_states(cuda, 4096 + 3, 3)
    outside = knife = 0
    before = cr.contact_rollout.launches
    for _ in range(6):
        f_k, z_k, t_k = cr.contact_rollout(x, 1, params_vec=vec, record_tiers=True)
        mid, _, t_mid = cr.contact_rollout_reference(x, 1, params_vec=vec, frame_skip=1,
                                                     record_tiers=True)
        f_p, z_p, t_p = cr.contact_rollout_reference(mid, 1, params_vec=vec, frame_skip=1,
                                                     record_tiers=True)
        safe = ~(cr.near_plane(x) | cr.near_plane(mid))
        bad = ~(torch.isclose(f_k, f_p, **TOL).all(dim=0) & torch.isclose(z_k, z_p, **TOL)
                & (t_k == t_mid + t_p).all(dim=1))
        outside += int((bad & safe).sum())
        knife += int((~safe).sum())
        x = f_p
    assert cr.contact_rollout.launches == before + 6
    assert outside == 0, (outside, knife)
    assert knife < 0.01 * 6 * x.shape[1]


@pytest.mark.parametrize("env_id", CONTACT)
def test_k11_tiers_and_rerun_bitwise(cuda, env_id):
    """No arm contact (nearly level bodies low on the plane): the gated
    kernel and the forced 48-candidate sweep agree bit for bit; a rerun
    too, with arm contacts."""
    env = reinmav_tpu_torch.make(env_id)
    vec = cr.contact_params_vec(env.params)
    x = _contact_states(cuda, 2048, 4, tilt=0.02, z_lo=0.015)
    gated = cr.contact_rollout(x, 3, params_vec=vec)
    forced = cr.contact_rollout(x, 3, params_vec=vec, force48=True)
    assert torch.equal(gated[0], forced[0]) and torch.equal(gated[1], forced[1])
    again = cr.contact_rollout(x, 3, params_vec=vec)
    assert torch.equal(gated[0], again[0]) and torch.equal(gated[1], again[1])
    wide = cr.contact_rollout(_contact_states(cuda, 2048, 5), 3, params_vec=vec)
    assert torch.equal(wide[0], cr.contact_rollout(_contact_states(cuda, 2048, 5), 3,
                                                   params_vec=vec)[0])


@pytest.mark.parametrize("env_id", CONTACT)
def test_throughput_rollout_launches_k11(cuda, env_id, caplog):
    env = reinmav_tpu_torch.make(env_id)
    gen = torch.Generator(device=cuda).manual_seed(0)
    states = env.vreset(gen, 4096)
    before = cr.contact_rollout.launches
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        final, rew = reinmav_tpu_torch.throughput_rollout(env, states, gen, 50)
    torch.cuda.synchronize()
    assert cr.contact_rollout.launches == before + 1 and "fused CUDA kernel" in caplog.text
    assert torch.equal(rew, torch.zeros_like(rew)) and bool(torch.isfinite(final).all())
    # The reward sums are 0 * Σz, as the JAX kernel path's: an env whose z
    # went non-finite reports NaN.
    bad = states[:8].clone()
    bad[1, 2] = float("nan")
    _, rew_bad = reinmav_tpu_torch.throughput_rollout(env, bad, gen, 3)
    others = torch.ones(8, dtype=torch.bool, device=cuda)
    others[1] = False
    assert bool(rew_bad[1].isnan()) and torch.equal(rew_bad[others], torch.zeros(7, device=cuda))
    assert cr.contact_rollout.launches == before + 2
    f_e, _ = reinmav_tpu_torch.throughput_rollout(env, states[:32], gen, 50, backend="scan")
    np.testing.assert_allclose(final[:32].cpu().numpy(), f_e.cpu().numpy(), rtol=2e-4, atol=1e-4)
    # contact_enabled=False is a value K11 cannot honour: the eager loop runs.
    off = _with_params(env, contact_enabled=False)
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        reinmav_tpu_torch.throughput_rollout(off, states[:8], gen, 2)
    assert "contact_enabled=False" in caplog.text and cr.contact_rollout.launches == before + 2


def test_k11_in_flight_is_k5(cuda):
    """Bodies in flight, no candidate near the plane: K11's substep (its
    own copy of the rigid-body arithmetic, csrc/contact_rollout.cu) and
    K5's (csrc/hover_common.cuh::hover_substep) under one constant action
    agree at the float32 tolerance over 10 steps (K5 contracts FMAs, K11
    does not, so not bit for bit; their CPU twins agree bit for bit)."""
    from reinmav_tpu_torch.ops import hover_rollout as hr

    p = tpuquad.Params(init_z=1.0)
    action = (0.8, 0.7, 0.75, 0.72)
    x = _contact_states(cuda, 4096, 6)
    x[2] += 1.0
    f_c, _ = cr.contact_rollout(x, 10, params_vec=cr.contact_params_vec(p, action))
    f_h, _ = hr.hover_rollout(x, 10, action=action, params_vec=hr.hover_params_vec(p))
    assert float(f_c[2].min()) > 0.5 and not bool(cr.near_plane(f_c).any())
    np.testing.assert_allclose(f_c.cpu().numpy(), f_h.cpu().numpy(), **TOL)


def _with_params(env, **fields):
    """The env of ``env``'s id made with its Params with ``fields`` replaced."""
    factory = tpuquad.make_force_ground if env.name == "MujocoQuadForce-v0" else tpuquad.make_quat
    return factory(env.params._replace(**fields))
