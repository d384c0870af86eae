"""The port's quaternion math (reinmav_tpu_torch.ops.quadmath) against the
JAX package's (reinmav_tpu.ops.quadmath), float64 on the CPU.

Inputs come from a NumPy seed and go through both functions; the two
compute the same expressions in the same order, so they agree to a few
ulp: rtol 1e-12, atol 1e-14."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinmav_tpu.ops import quadmath as jqm
from reinmav_tpu_torch.ops import quadmath as tqm

RTOL, ATOL = 1e-12, 1e-14


def _quats(rng, n, unit=False):
    q = rng.uniform(-1.0, 1.0, size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True) if unit else q


def _rotmats(rng, n):
    return np.asarray(jqm.quat_to_rotmat(jnp.asarray(_quats(rng, n, unit=True))))


def _both(fn_name, *arrays):
    """Run ``fn_name`` of both modules on the same float64 inputs."""
    got = getattr(tqm, fn_name)(*(torch.tensor(a, dtype=torch.float64) for a in arrays))
    ref = getattr(jqm, fn_name)(*(jnp.asarray(a) for a in arrays))
    if isinstance(got, tuple):
        return [g.numpy() for g in got], [np.asarray(r) for r in ref]
    return got.numpy(), np.asarray(ref)


# name -> input maker (rng -> tuple of arrays)
_CASES = {
    "quat_mul": lambda rng: (_quats(rng, 64), _quats(rng, 64)),
    "quat_conj": lambda rng: (_quats(rng, 64),),
    "quat_norm": lambda rng: (_quats(rng, 64),),
    "quat_normalize": lambda rng: (_quats(rng, 64),),
    "quat_to_rotmat": lambda rng: (_quats(rng, 64, unit=True),),
    "quat_to_rotmat_nonunit": lambda rng: (_quats(rng, 64) * 3.0,),
    "quat_derivative": lambda rng: (_quats(rng, 64), rng.uniform(-5, 5, (64, 3))),
    "quat_from_rotmat": lambda rng: (_rotmats(rng, 256),),
    "acc2quat": lambda rng: (rng.uniform(-10, 10, (64, 3)) + np.array([0.0, 0.0, 12.0]),),
    "rot_to_rpy_zxy": lambda rng: (_rotmats(rng, 64),),
    "quat_to_rpy": lambda rng: (_quats(rng, 64, unit=True),),
}


@pytest.mark.parametrize("fn_name", sorted(_CASES))
def test_matches_jax_float64(fn_name, rng):
    got, ref = _both(fn_name, *_CASES[fn_name](rng))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_quat_from_rotmat_covers_all_four_branches(rng):
    """pyquaternion's branch choice decides the sign: every branch is hit
    by the inputs and each agrees with the JAX select."""
    m = _rotmats(rng, 512)
    mt = np.swapaxes(m, -1, -2)
    neg = mt[:, 2, 2] < 0
    branches = {
        "A": neg & (mt[:, 0, 0] > mt[:, 1, 1]),
        "B": neg & ~(mt[:, 0, 0] > mt[:, 1, 1]),
        "C": ~neg & (mt[:, 0, 0] < -mt[:, 1, 1]),
        "D": ~neg & ~(mt[:, 0, 0] < -mt[:, 1, 1]),
    }
    got, ref = _both("quat_from_rotmat", m)
    for name, mask in branches.items():
        assert mask.sum() >= 10, f"branch {name} hit {mask.sum()} times"
        np.testing.assert_allclose(got[mask], ref[mask], rtol=RTOL, atol=ATOL)


def test_zero_quaternion():
    """|q| = 0: normalisation leaves it zero, the non-unit matrix is the
    identity, the norm is 0 — as in the JAX module."""
    zero = np.zeros((2, 4))
    for name in ("quat_normalize", "quat_norm", "quat_to_rotmat_nonunit"):
        got, ref = _both(name, zero)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(_both("quat_to_rotmat_nonunit", zero)[0], np.stack([np.eye(3)] * 2))


def test_float32_stays_float32_and_single_quaternion_works(rng):
    q = torch.tensor(_quats(rng, 1)[0], dtype=torch.float32)
    assert tqm.quat_to_rotmat(tqm.quat_normalize(q)).dtype == torch.float32
    assert tqm.quat_mul(q, q).shape == (4,)
    np.testing.assert_allclose(tqm.quat_mul(q, tqm.quat_conj(q)).numpy(),
                               [float(q.square().sum()), 0, 0, 0], atol=1e-6)
