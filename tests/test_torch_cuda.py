"""Kernel K1 on the card: the CUDA kernel against its plain PyTorch twin
(reinmav_tpu_torch.ops.rollout), and the public entry point dispatching
to it.  Every test needs a CUDA device and the ``nvcc`` that builds the
kernel, and skips without a device.

This file imports no JAX, so that it runs where only PyTorch is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are the JAX kernel tests' own (tests/test_pallas_rollout.py):
rtol 2e-4 / atol 2e-5 on float32 final states, rtol 1e-4 on the reward
total.  With auto-reset, an env whose done test lands within rounding of
its threshold may branch differently in the two, so that leg counts the
envs that disagree and allows 0.1%.
"""

import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.envs import quadrotor3d
from reinmav_tpu_torch.ops import rollout as ro

KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
]
RTOL, ATOL, RTOL_REWARD = 2e-4, 2e-5, 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _states_t(seed, batch, scale, device):
    s = np.random.default_rng(seed).uniform(-1, 1, (batch, 10)) * scale
    return torch.tensor(s.T, dtype=torch.float32, device=device).contiguous()


@pytest.mark.parametrize("ctr,key,expected", KAT)
def test_philox_known_answers(cuda, ctr, key, expected):
    got = ro.philox4x32_10(torch.tensor([ctr], device=cuda), torch.tensor([key], device=cuda))
    assert tuple(got[0].tolist()) == expected


def test_kernel_matches_twin_without_reset(cuda):
    st = _states_t(10, 4096 + 37, 0.1, cuda)  # a ragged tail
    before = ro.quad3d_rollout_autoreset.launches
    f, r = ro.quad3d_rollout_autoreset(st, 3, 200, autoreset=False)
    torch.cuda.synchronize()
    assert ro.quad3d_rollout_autoreset.launches == before + 1
    f_ref, r_ref = ro.quad3d_rollout_reference(st, 3, 200, autoreset=False)
    np.testing.assert_allclose(f.cpu().numpy(), f_ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(r.sum()), float(r_ref.sum()), rtol=RTOL_REWARD)


def test_kernel_matches_twin_with_reset(cuda):
    st = _states_t(11, 8192, 1.0, cuda)
    f, r = ro.quad3d_rollout_autoreset(st, 5, 300)
    f_ref, r_ref = ro.quad3d_rollout_reference(st, 5, 300)
    close = torch.isclose(f, f_ref, rtol=RTOL, atol=ATOL).all(dim=0)
    assert float(close.float().mean()) >= 0.999, int((~close).sum())
    np.testing.assert_allclose(float(r.sum()), float(r_ref.sum()), rtol=1e-3)
    f2, r2 = ro.quad3d_rollout_autoreset(st, 5, 300)
    assert torch.equal(f, f2) and torch.equal(r, r2)
    assert float(f[0:3].norm(dim=0).max()) < 3.5


def test_kernel_takes_live_params(cuda):
    params = quadrotor3d.Params(ref_x=0.5, ref_z=1.5, mass=1.2, tau=0.4)
    pv = ro.quad3d_params_vec(params)
    st = _states_t(12, 2048, 0.3, cuda)
    f, r = ro.quad3d_rollout_autoreset(st, 0, 150, params_vec=pv, autoreset=False)
    f_ref, r_ref = ro.quad3d_rollout_reference(st, 0, 150, params_vec=pv, autoreset=False)
    np.testing.assert_allclose(f.cpu().numpy(), f_ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(r.sum()), float(r_ref.sum()), rtol=RTOL_REWARD)


def test_throughput_rollout_auto_runs_the_kernel(cuda):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    gen = torch.Generator(device=cuda).manual_seed(0)
    states = env.vreset(gen, 4096) * 0.1
    before = ro.quad3d_rollout_autoreset.launches
    f, r = reinmav_tpu_torch.throughput_rollout(env, states, gen, 100)
    assert ro.quad3d_rollout_autoreset.launches == before + 1
    f_scan, r_scan = reinmav_tpu_torch.throughput_rollout(env, states, gen, 100, backend="scan")
    np.testing.assert_allclose(f.cpu().numpy(), f_scan.cpu().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(r.sum()), float(r_scan.sum()), rtol=RTOL_REWARD)
