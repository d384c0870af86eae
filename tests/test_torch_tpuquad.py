"""The port's tpuquad family (reinmav_tpu_torch.envs.tpuquad: the hover task
MujocoQuadForce-v1, MujocoQuadForce-v0, MujocoQuadQuat-v0) and the env
core's controller-less paths, against the JAX package, float64 on the CPU.

Inputs come from a NumPy seed and go through both packages: states near
the hover pose, drops onto the plane, tilted drops, and tilts steep enough
that the arm boxes' corners touch the plane (the 48-candidate tier of the
contact solve).  Over 50 steps of random actions, states and rewards
agree to 1e-9 and done exactly: the port writes the JAX env's formulas in
the same order, and the 120-sweep contact solve is a contraction, so only
the order of a few sums differs.

The contact solve's two tiers, 16 candidates (core and thruster caps) and
48 (with the arm corners), are the same solve when no arm corner is below
the plane (inactive candidates add exact zeros): pinned here at 1e-13,
the rounding of sums taken over 16 or 48 entries.  With nothing below the
plane the contact force is exactly zero.
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
from reinmav_tpu.envs import tpuquad as jtq
from reinmav_tpu_torch.envs import core, tpuquad
from reinmav_tpu_torch.ops import quadmath as qm

F64 = torch.float64
IDS = ["MujocoQuadForce-v1", "MujocoQuadForce-v0", "MujocoQuadQuat-v0"]
STEPS = 50


@pytest.fixture(autouse=True)
def one_thread():
    """The contact solve is thousands of tiny tensor ops: threads only add
    overhead, and the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _states(rng, n_each=1):
    """``(6 n_each, 13)`` float64 states: hover pose, drop, tilted drop and
    arm contact, each perturbed."""
    def block(z_lo, z_hi, tilt, vel):
        s = np.zeros((n_each, 13))
        s[:, 2] = rng.uniform(z_lo, z_hi, n_each)
        axis = rng.normal(size=(n_each, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        ang = rng.uniform(0.5 * tilt, tilt, n_each)
        s[:, 3] = np.cos(ang / 2)
        s[:, 4:7] = axis * np.sin(ang / 2)[:, None]
        s[:, 7:13] = rng.uniform(-vel, vel, (n_each, 6))
        return s

    return np.concatenate([
        block(0.6, 1.2, 0.3, 0.5),     # airborne, near the hover pose
        block(0.03, 0.12, 0.05, 0.2),  # a level drop onto the plane
        block(0.05, 0.15, 0.6, 0.3),   # a tilted drop
        block(0.0, 0.02, 1.2, 0.2),    # steep tilt at the plane: arm corners touch
        block(-0.005, 0.01, 0.2, 0.1),  # resting in the plane
        block(0.2, 0.4, 0.9, 1.0),     # tumbling above the plane
    ])


def _actions(rng, env_id, n):
    if env_id == "MujocoQuadQuat-v0":
        return rng.uniform([-0.5, -1.5, -1.5, -1.5], [4.5, 1.5, 1.5, 1.5], (STEPS, n, 4))
    return rng.uniform(-0.2, 1.2, (STEPS, n, 4))  # outside [0, 1]: the raw-action reward


@pytest.mark.parametrize("env_id", IDS)
def test_step_matches_jax_over_50_steps(env_id, rng):
    jenv, tenv = reinmav_tpu.make(env_id), reinmav_tpu_torch.make(env_id)
    s0 = _states(rng)
    if env_id == "MujocoQuadForce-v1":
        # The hover task shares Force-v0's physics, contact included; its
        # own parts are the reward and done, so it flies the airborne states.
        s0 = np.concatenate([_states(rng)[[0, 5]] for _ in range(3)])
    acts = _actions(rng, env_id, s0.shape[0])

    def run(s, a):
        def body(s, a_t):
            out = jenv.vstep(s, a_t)
            return out.state, (out.state, out.obs, out.reward, out.done)
        return jax.lax.scan(body, s, a)

    _, (j_s, j_o, j_r, j_d) = jax.jit(run)(jnp.asarray(s0), jnp.asarray(acts))
    s, rows = _t(s0), []
    for a in acts:
        out = tenv.vstep(s, _t(a))
        rows.append(out)
        s = out.state
    got = core._stack(rows)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(j_s), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(j_o), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(j_r), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(j_d))
    if env_id == "MujocoQuadForce-v1":
        assert got.done.any() and not got.done.all()
    else:  # the scenarios reach the plane, with the arm corners on it in some
        z = tpuquad.candidate_z(_t(s0)[:, :3],
                                qm.quat_to_rotmat(qm.quat_normalize(_t(s0)[:, 3:7])))
        assert bool((z < 0).any()) and bool((z[:, tpuquad.N_SMALL:] < 0).any())


def test_single_env_step_matches_batched(rng):
    env = reinmav_tpu_torch.make("MujocoQuadForce-v0")
    s = _t(_states(rng, 1))
    a = _t(rng.uniform(0, 1, (s.shape[0], 4)))
    batched = env.vstep(s, a)
    for i in range(s.shape[0]):
        one = env.step(s[i], a[i])
        assert one.state.shape == (13,) and one.reward.shape == ()
        np.testing.assert_allclose(one.state.numpy(), batched.state[i].numpy(), rtol=1e-13,
                                   atol=1e-15)


def _contact_inputs(rng, n, z, tilt):
    pos = np.zeros((n, 3))
    pos[:, :2] = rng.uniform(-0.1, 0.1, (n, 2))
    pos[:, 2] = z
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    quat = np.concatenate([np.cos(tilt / 2)[:, None], axis * np.sin(tilt / 2)[:, None]], axis=1)
    rot = qm.quat_to_rotmat(_t(quat))
    vel, omega, acc0, alpha0 = (_t(rng.normal(0, 0.3, (n, 3))) for _ in range(4))
    return _t(pos), vel, omega, rot, acc0, alpha0, _t(quat)


def test_contact_tiers_agree_without_arm_contact(rng):
    """16-candidate solve == 48-candidate solve where no arm corner is
    below the plane (ROADMAP queue 1 item 11's tier equivalence)."""
    n = 16
    pos, vel, omega, rot, acc0, alpha0, _ = _contact_inputs(
        rng, n, rng.uniform(0.01, 0.02, n), rng.uniform(0.0, 0.05, n))
    z = tpuquad.candidate_z(pos, rot)
    assert bool((z[:, :tpuquad.N_SMALL] < 0).any(dim=1).all())
    assert not bool((z[:, tpuquad.N_SMALL:] < 0).any())
    p = tpuquad.Params()
    f16, t16 = tpuquad._contact_solve(p, pos, vel, omega, rot, acc0, alpha0, n_cand=16)
    f48, t48 = tpuquad._contact_solve(p, pos, vel, omega, rot, acc0, alpha0, n_cand=48)
    assert float(f16[:, 2].min()) > 0.0  # the plane pushes up
    np.testing.assert_allclose(f16.numpy(), f48.numpy(), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(t16.numpy(), t48.numpy(), rtol=1e-13, atol=1e-15)
    # The gated wrench takes the 16 tier here, and matches the JAX env's.
    fg, tg = tpuquad._contact_wrench(p, pos, vel, omega, rot, acc0, alpha0)
    assert torch.equal(fg, f16) and torch.equal(tg, t16)
    jf, jt = jax.jit(jax.vmap(lambda *x: jtq._contact_solve(jtq.Params(), *x, n_cand=48)))(
        *(jnp.asarray(x.numpy()) for x in (pos, vel, omega, rot, acc0, alpha0)))
    np.testing.assert_allclose(fg.numpy(), np.asarray(jf), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jt), rtol=1e-10, atol=1e-12)


def test_no_penetration_gives_exactly_zero_contact(rng):
    n = 32
    pos, vel, omega, rot, acc0, alpha0, quat = _contact_inputs(
        rng, n, rng.uniform(0.16, 2.0, n), rng.uniform(0.0, 3.0, n))
    assert not bool((tpuquad.candidate_z(pos, rot) < 0).any())
    f, t = tpuquad._contact_wrench(tpuquad.Params(), pos, vel, omega, rot, acc0, alpha0)
    assert torch.equal(f, torch.zeros_like(f)) and torch.equal(t, torch.zeros_like(t))
    # So the gate changes nothing for an airborne batch: contact on == off.
    state = torch.cat([pos, quat, vel, omega], dim=1)
    thrust = _t(rng.uniform(0, 1, (n, 4)))
    yaw, zero = torch.zeros(n, dtype=F64), torch.zeros((n, 3), dtype=F64)
    on = tpuquad._physics_step(tpuquad.Params(), state, thrust, yaw, zero)
    off = tpuquad._physics_step(tpuquad.Params(contact_enabled=False), state, thrust, yaw, zero)
    assert torch.equal(on, off)


def test_candidate_z_is_the_world_points_z(rng):
    n = 8
    pos, _, _, rot, _, _, _ = _contact_inputs(rng, n, rng.uniform(-0.1, 0.3, n),
                                              rng.uniform(0.0, 3.0, n))
    pts = tpuquad._contact_points(pos, rot, tpuquad.N_CANDIDATES)
    np.testing.assert_allclose(tpuquad.candidate_z(pos, rot).numpy(), pts[..., 2].numpy(),
                               rtol=1e-14, atol=1e-16)
    for i in range(n):
        ref = jtq._contact_candidates(jnp.asarray(pos[i].numpy()), jnp.asarray(rot[i].numpy()))
        np.testing.assert_allclose(pts[i].numpy(), np.asarray(ref), rtol=1e-13, atol=1e-15)


def test_resets_are_deterministic_and_tagged():
    for env_id, z in (("MujocoQuadForce-v1", 1.0), ("MujocoQuadForce-v0", 0.0),
                      ("MujocoQuadQuat-v0", 0.0)):
        env = reinmav_tpu_torch.make(env_id)
        assert env.deterministic_reset and env.control_fn is None and env.obs_dim == 13
        a = env.vreset(torch.Generator().manual_seed(0), 3, dtype=F64)
        b = env.vreset(torch.Generator().manual_seed(1), 3, dtype=F64)
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a[0].numpy(), [0, 0, z, 1] + [0] * 9)
        assert env.reset_fn.det_reset_init_z == z
    assert not reinmav_tpu_torch.make("quadrotor3d-v0").deterministic_reset
    low = tpuquad.make_hovering(tpuquad.Params(init_z=0.7))
    assert low.reset_fn is not tpuquad.hovering_reset and low.reset_fn.det_reset_init_z == 0.7


def test_params_from_jax_round_trip():
    jp = jtq.Params(mass=0.35, init_z=0.8, frame_skip=3, contact_enabled=False,
                    inertia_diag=(0.002, 0.002, 0.004))
    tp = tpuquad.params_from_jax(jp)
    assert type(tp) is tpuquad.Params and tuple(tp) == tuple(jp)
    assert tpuquad.params_from_jax(jtq.Params(init_z=1.0)) == tpuquad.Params(init_z=1.0)
    assert tpuquad.params_from_jax(jtq.QuatParams()) == tpuquad.QuatParams()
    as_numpy = {k: np.asarray(v) for k, v in jp._asdict().items()}
    assert tpuquad.params_from_jax(as_numpy) == tp
    with pytest.raises(ValueError, match="fields"):
        tpuquad.params_from_jax(dict(reversed(list(as_numpy.items()))))
    # Non-default params step as the JAX env with the same params.
    s = np.tile([0.1, -0.1, 0.9, 1, 0, 0, 0, 0.1, 0, -0.2, 0.3, 0, 0.1], (4, 1))
    a = np.full((4, 4), 0.6)
    got = tpuquad.make_hovering(tp).vstep(_t(s), _t(a))
    ref = jtq.make_hovering(jp).vstep(jnp.asarray(s), jnp.asarray(a))
    np.testing.assert_allclose(got.state.numpy(), np.asarray(ref.state), rtol=1e-12, atol=1e-14)


def test_zero_action_throughput_matches_jax_scan(rng, caplog):
    """throughput_rollout of a controller-less env steps zero actions with
    the fused auto-reset (the JAX package's _zero_action_rollout); on the
    CPU "auto" says why no kernel ran."""
    s0 = np.concatenate([_states(rng)[:1], _states(rng)[-1:]] * 2)  # airborne
    jenv, tenv = reinmav_tpu.make("MujocoQuadForce-v1"), reinmav_tpu_torch.make("MujocoQuadForce-v1")
    j_final, j_rew = jax.jit(lambda s: reinmav_tpu.throughput_rollout(
        jenv, s, jax.random.PRNGKey(0), 30, backend="scan", dense8=False))(jnp.asarray(s0))
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        t_final, t_rew = reinmav_tpu_torch.throughput_rollout(
            tenv, _t(s0), torch.Generator().manual_seed(0), 30)
    assert "eager loop" in caplog.text and "needs a CUDA tensor" in caplog.text
    np.testing.assert_allclose(t_final.numpy(), np.asarray(j_final), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), rtol=1e-9, atol=1e-9)
    # Zero thrust: every env fell through z = 0.3 and reset to the hover pose.
    assert float(t_final[:, 2].min()) > 0.3 and float(t_final[:, 7:].abs().max()) < 3.0
    for env_id in ("MujocoQuadForce-v1", "MujocoQuadForce-v0"):
        with pytest.raises(ValueError, match="refused"):
            reinmav_tpu_torch.throughput_rollout(reinmav_tpu_torch.make(env_id), _t(s0),
                                                 torch.Generator(), 3, backend="kernel")
    caplog.clear()
    ground = reinmav_tpu_torch.make("MujocoQuadForce-v0")
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        final, rew = reinmav_tpu_torch.throughput_rollout(ground, _t(s0), torch.Generator(), 2)
    assert "eager loop" in caplog.text and "needs a CUDA tensor" in caplog.text
    assert torch.equal(rew, torch.zeros_like(rew)) and bool(torch.isfinite(final).all())


def test_fused_kernel_mismatch_of_the_hover_task():
    env = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    assert core.fused_kernel_mismatch(env) is None
    # Another init_z is a new reset closure whose tag matches the params.
    assert core.fused_kernel_mismatch(tpuquad.make_hovering(tpuquad.Params(init_z=0.5))) is None
    # The registry's reset with params of another init_z would reset elsewhere.
    mixed = dataclasses.replace(env, params=tpuquad.Params(init_z=0.5))
    assert "wrapped" in core.fused_kernel_mismatch(mixed)
    wrapped = dataclasses.replace(env, step_fn=lambda p, s, a: tpuquad.hovering_step(p, s, a))
    assert "wrapped" in core.fused_kernel_mismatch(wrapped)
    untagged = dataclasses.replace(env, reset_fn=lambda *a: tpuquad.hovering_reset(*a))
    assert "wrapped" in core.fused_kernel_mismatch(untagged)
    quat = dataclasses.replace(env, params=tpuquad.QuatParams(init_z=1.0))
    assert "not the kernel's Params" in core.fused_kernel_mismatch(quat)
    assert "non-default" in core.fused_kernel_mismatch(
        tpuquad.make_hovering(tpuquad.Params(init_z=1.0, mass=0.4)), packed_params=False)
    # The contact envs have their kernel, K11, which cannot switch the
    # contact off.
    for env_id in ("MujocoQuadForce-v0", "MujocoQuadQuat-v0"):
        contact = reinmav_tpu_torch.make(env_id)
        assert core.fused_kernel_mismatch(contact) is None
        off = dataclasses.replace(contact, params=contact.params._replace(contact_enabled=False))
        assert "K11" in core.fused_kernel_mismatch(off)
