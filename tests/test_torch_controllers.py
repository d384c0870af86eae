"""The port's standalone controllers (reinmav_tpu_torch.controllers.geometric
and .rpy_pid) against the JAX package's, on the CPU in float64.

Both run batched (a leading batch dimension) on seeded NumPy inputs, the
JAX functions vmapped over the same batch: rtol 1e-10 / atol 1e-12.  The
RPY PID also runs a 100-call sequence, its carry threaded, against the
NumPy oracle of the reference controller (reinmav_tpu/oracle/rpy_pid_ref.py)
at tests/test_controllers.py's rtol 1e-9 / atol 1e-11, batched: every
batch row is its own oracle instance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from reinmav_tpu.controllers import geometric as jgeo
from reinmav_tpu.controllers import rpy_pid as jpid
from reinmav_tpu.oracle.rpy_pid_ref import RpyControllerOracle
from reinmav_tpu_torch.controllers import geometric, rpy_pid

TOL = dict(rtol=1e-10, atol=1e-12)


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def test_geometric_matches_jax_batched(rng):
    B = 256
    pos, vel = rng.uniform(-2, 2, (B, 3)), rng.uniform(-2, 2, (B, 3))
    quat = rng.uniform(-1, 1, (B, 4))  # raw, unnormalised, as the envs keep it
    ref_pos, ref_vel = rng.uniform(-1, 1, (B, 3)), rng.uniform(-1, 1, (B, 3))
    ref_acc = rng.uniform(-1, 1, (B, 3))
    quat[0] = [0.0, 0.0, 0.0, 1.0]  # a 180 degree error: sign(qe0) = 0
    gains = geometric.Gains(kp=(-4.0, -5.0, -6.0), tau=0.25)
    jg = jgeo.Gains(*gains)
    for extra in ({}, {"ref_vel": ref_vel}, {"ref_vel": ref_vel, "ref_acc": ref_acc}):
        ref = jax.vmap(lambda p, q, v, rp, *e: jgeo.control(jg, p, q, v, rp, *e))(
            pos, quat, vel, ref_pos, *extra.values())
        got = geometric.control(gains, _t(pos), _t(quat), _t(vel), _t(ref_pos),
                                **{k: _t(v) for k, v in extra.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=str(list(extra)), **TOL)
    single = geometric.control(gains, _t(pos[3]), _t(quat[3]), _t(vel[3]), _t(ref_pos[3]))
    assert single.shape == (4,)
    t = np.linspace(0.0, 7.0, 50)
    np.testing.assert_allclose(
        geometric.circle_reference(_t(t), radius=0.7, omega=1.5, dtype=torch.float64).numpy(),
        np.asarray(jgeo.circle_reference(jnp.asarray(t), radius=0.7, omega=1.5,
                                         dtype=jnp.float64)), **TOL)


def test_rpy_pid_matches_jax_batched_and_the_oracle_over_a_sequence(rng):
    B, steps = 8, 100
    dt, mass, gravity = 0.01, 0.3, -9.81
    gains = rpy_pid.Gains()
    np.testing.assert_array_equal(rpy_pid.mixer_matrix(gains, torch.float64).numpy(),
                                  np.asarray(jpid.mixer_matrix(jpid.Gains(), jnp.float64)))
    oracles = [RpyControllerOracle(dt, mass, gravity) for _ in range(B)]
    carry = rpy_pid.init_carry(torch.float64, batch_shape=(B,))
    jcarry = jax.vmap(lambda _: jpid.init_carry(jnp.float64))(jnp.arange(B))
    jcontrol = jax.jit(jax.vmap(lambda c, p, q, pd, yd: jpid.control(
        jpid.Gains(), c, p, q, pd, yd, dt, mass, gravity)))
    for _ in range(steps):
        pos = rng.uniform(-1, 1, (B, 3))
        quat = rng.uniform(-1, 1, (B, 4))
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
        pos_d = rng.uniform(-1, 1, (B, 3))
        yaw_d = rng.uniform(-np.pi, np.pi, B)
        forces, carry = rpy_pid.control(gains, carry, _t(pos), _t(quat), _t(pos_d), _t(yaw_d),
                                        dt, mass, gravity)
        jforces, jcarry = jcontrol(jcarry, pos, quat, pos_d, yaw_d)
        np.testing.assert_allclose(forces.numpy(), np.asarray(jforces), **TOL)
        for a, b in zip(carry, jcarry):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        ref = np.stack([o.control(p, q, pd, yd)
                        for o, p, q, pd, yd in zip(oracles, pos, quat, pos_d, yaw_d)])
        np.testing.assert_allclose(forces.numpy(), ref, rtol=1e-9, atol=1e-11)


def test_rpy_pid_raw_quaternion_and_broadcast_targets(rng):
    """A non-unit quaternion goes through inv(quat_to_rotmat(raw)), as the
    JAX function and the reference; one target broadcasts over a batch."""
    B = 16
    pos, quat = rng.uniform(-1, 1, (B, 3)), rng.uniform(-1, 1, (B, 4)) * 1.3
    pos_d, yaw_d = np.array([0.5, -0.2, 1.0]), 0.4
    carry = rpy_pid.init_carry(torch.float64, batch_shape=(B,))
    forces, new = rpy_pid.control(rpy_pid.Gains(), carry, _t(pos), _t(quat), _t(pos_d), yaw_d,
                                  0.02, 0.5)
    jforces, jnew = jax.vmap(lambda p, q: jpid.control(
        jpid.Gains(), jpid.init_carry(jnp.float64), p, q, jnp.asarray(pos_d), yaw_d, 0.02,
        0.5))(pos, quat)
    np.testing.assert_allclose(forces.numpy(), np.asarray(jforces), **TOL)
    np.testing.assert_allclose(new.zrpy_error_int.numpy(), np.asarray(jnew.zrpy_error_int), **TOL)
