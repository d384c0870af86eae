"""K1 in the closed-loop template, the taut counts of K6 and K7, and
reinmav-v0's reward anchor, on the CPU.

- K1's controller: pyquaternion's ``_from_matrix`` branch select of the
  twin (``ops.rollout.geometric_control``, all four candidates and a
  select, as the kernel's ``Quad3dLoop`` takes one branch) against
  ``tilt_controller_tiles`` on states from every corner of the reset box
  and far beyond it.  Only branches B and D are reachable: ``m11 =
  |(zbz, zbx)| >= 0`` and ``m00 = zbz / |(zbz, zbx)|`` has the sign of
  ``m22 = zbz``, so branch A (``m22 < 0``, ``m00 > m11``) and branch C
  (``m22 >= 0``, ``m00 < -m11``) contradict; NaN falls to D.
- The taut counts of K6 and K7 (their counting instances' twins): a
  recount step by step from the states, the tether test bitwise K8/K9's
  twin's, the outputs with counts bitwise the outputs without.
- reinmav-v0's kernel branch of ``throughput_rollout``: ``90 * horizon +
  0 * x``, NaN for an env whose state went non-finite, as the JAX kernel
  path's (the device check lifted, so that the branch runs the twin here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu.ops import pallas_rollout
from reinmav_tpu_torch.envs import core
from reinmav_tpu_torch.ops import closed_loop_rollout as cl
from reinmav_tpu_torch.ops import offpolicy as op
from reinmav_tpu_torch.ops import ppo_rollout as pr
from reinmav_tpu_torch.ops import reinmav_rollout as rr
from reinmav_tpu_torch.ops import rollout as ro
from reinmav_tpu_torch.rl import networks, sac

SLUNG = list(cl.TAUT_KINDS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _quad3d_states(batch=4096, seed=0):
    """(10, B) float32: positions and velocities from the reset box to ten
    times it (the desired acceleration points up and down), random
    unnormalised quaternions."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1.0, 1.0, (10, batch)).astype(np.float32)
    s[[0, 1, 2, 7, 8, 9]] *= rng.choice([1.0, 3.0, 10.0], (6, batch)).astype(np.float32)
    return torch.from_numpy(s)


def _branches(s, p):
    """pyquaternion's branch of each env, from the frame as the kernel and
    both twins form it: 0 A, 1 B, 2 C, 3 D."""
    ax = p.kp * (s[0] - p.ref_x) + p.kv * s[7]
    ay = p.kp * (s[1] - p.ref_y) + p.kv * s[8]
    az = p.kp * (s[2] - p.ref_z) + p.kv * s[9] - p.gravity
    an = torch.rsqrt(ax * ax + ay * ay + az * az)
    zbx, zbz = ax * an, az * an
    xn = torch.rsqrt(zbz * zbz + zbx * zbx)
    m00, m22 = zbz * xn, zbz
    m11 = zbz * (zbz * xn) - zbx * (-zbx * xn)
    return torch.where(m22 < 0.0, torch.where(m00 > m11, 0, 1), torch.where(m00 < -m11, 2, 3))


def test_from_matrix_branches_and_the_controller_against_jax():
    """Branches B and D both taken, A and C never; the twin's command and
    body frame against tilt_controller_tiles on every env."""
    p = reinmav_tpu_torch.make("quadrotor3d-v0").params
    s = _quad3d_states()
    s[:, :8] = torch.tensor([0.0, 0.0, 30.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])[:, None]
    s[:, 8:16] = torch.tensor([0.0, 0.0, -30.0, 0.3, 0.1, -0.2, 0.5, 0.0, 0.0, 20.0])[:, None]
    branch = _branches(s, p)
    counts = torch.bincount(branch, minlength=4).tolist()
    assert counts[0] == 0 and counts[2] == 0 and counts[1] > 100 and counts[3] > 100, counts
    c = dict(kp=p.kp, kv=p.kv, ref_x=p.ref_x, ref_y=p.ref_y, ref_z=p.ref_z, gz=p.gravity)
    two_over_tau = float(np.float32(2.0) / np.float32(p.tau))
    thrust, wx, wy, wz, bz = ro.geometric_control(s, c["kp"], c["kv"], c["ref_x"], c["ref_y"],
                                                  c["ref_z"], c["gz"], two_over_tau)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = jax.jit(lambda *x: pallas_rollout.tilt_controller_tiles(
            *x, ref_z=p.ref_z, kp=p.kp, kv=p.kv, tau=p.tau, gz=p.gravity, ref_x=p.ref_x,
            ref_y=p.ref_y))(*(jnp.asarray(r) for r in s.numpy()))
    ours = (thrust, wx, wy, wz, bz[1], bz[2], bz[3], bz[0])
    for k, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5,
                                   err_msg=f"output {k}")
    # The rate command's sign: sign(0) = 0, and the twin's select is bitwise
    # the kernel's branch bodies (additions only after the frame).
    assert bool(torch.isfinite(thrust).all()) and bool(torch.isfinite(wx).all())


def test_k1_twin_through_both_reachable_branches():
    """The K1 twin from states on both reachable branches, 20 steps without
    reset, against the JAX kernel in interpret mode (tests/test_
    torch_rollout.py's tolerances, at the states here)."""
    from jax.experimental.pallas import tpu as pltpu

    s = _quad3d_states(256, seed=1)
    branch = _branches(s, reinmav_tpu_torch.make("quadrotor3d-v0").params)
    assert int((branch == 1).sum()) > 10 and int((branch == 3).sum()) > 10
    final, rew = ro.quad3d_rollout_reference(s, 3, 20, autoreset=False)
    with pltpu.force_tpu_interpret_mode():
        jf, jr = pallas_rollout.quad3d_rollout_pallas(jnp.asarray(s.numpy()), 20, tile=256)
    ok = torch.isfinite(final).all(dim=0).numpy()
    np.testing.assert_allclose(final.numpy()[:, ok], np.asarray(jf)[:, ok], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(rew.numpy()[ok], np.asarray(jr)[ok], rtol=2e-4, atol=2e-4)


def _k6_args(kind, batch=96, seed=0):
    """A slung-load kind's K6 arguments: a random 2x64 net, identity obs
    normalisation (so the obs rows are the raw states), tethers straddling
    L."""
    env = reinmav_tpu_torch.make(kind)
    d, a = env.obs_dim, env.action_dim
    g = torch.Generator().manual_seed(seed)
    net = torch.randn(networks.Layout(d, a, pr.HIDDEN).size, generator=g) * 0.2
    consts = torch.cat([torch.zeros(d), torch.ones(d), torch.full((a,), 0.5),
                        torch.tensor([0.0, 1.0, 0.99])])
    s = env.vreset(g, batch).T.contiguous()
    k = 2 + SLUNG.index(kind)
    s[d - 2 * k:d - k] = s[0:k] + torch.randn((k, batch), generator=g) * 0.6
    return env, (s, torch.zeros(batch), 5, net, consts), dict(params_vec=pr.env_params_vec(env),
                                                             env_kind=kind)


@pytest.mark.parametrize("kind", SLUNG)
def test_k6_taut_counts_are_a_recount(kind):
    """K6's twin with counts: bitwise the outputs without, and each env's
    count the number of steps whose start state had a taut tether,
    recounted from the trajectory's obs rows (the raw states under the
    identity normalisation); the tether test bitwise K8/K9's twin's."""
    env, args, kw = _k6_args(kind)
    counts = torch.zeros(args[0].shape[1], dtype=torch.int32)
    out = pr.ppo_rollout(*args, 12, counts=counts, **kw)
    plain = pr.ppo_rollout(*args, 12, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert float(out.obs.abs().max()) < 10.0  # no obs clipped: the rows are the states
    taut = cl.taut_twin(kind, kw["params_vec"])
    recount = sum(taut(out.obs[t]).to(torch.int32) for t in range(12))
    assert torch.equal(counts, recount)
    assert 0 < int(counts.sum()) < 12 * counts.numel()
    c = cl._scalars(cl.KINDS[kind].fields, kw["params_vec"])
    act = torch.randn((env.action_dim, args[0].shape[1]),
                      generator=torch.Generator().manual_seed(2))
    assert torch.equal(taut(args[0]), cl.LOOP_STEPS[kind](args[0], act, c)[3])


@pytest.mark.parametrize("kind", SLUNG)
def test_k7_taut_counts_add_up(kind):
    """K7's twin with counts adds each env's taut tether at the start of the
    step and leaves the outputs bitwise the outputs without counts."""
    env = reinmav_tpu_torch.make(kind)
    d, a = env.obs_dim, env.action_dim
    layout = sac.MlpLayout((d, 32, 32, 2 * a))
    w = op.actor_kernel_args(layout.layers(sac.init_mlp(layout, torch.Generator().manual_seed(3))))
    consts = sac.collect_consts(env, torch.tensor(False), 0.0)
    _, (s, *_), kw = _k6_args(kind, 64, seed=4)
    counts = torch.full((64,), 7, dtype=torch.int32)
    new, block = op.collect_step(kind, "sac", s, 9, consts, kw["params_vec"], *w, counts=counts)
    new0, block0 = op.collect_step(kind, "sac", s, 9, consts, kw["params_vec"], *w)
    assert torch.equal(new, new0) and torch.equal(block, block0)
    assert torch.equal(counts - 7, cl.taut_twin(kind, kw["params_vec"])(s).to(torch.int32))


def test_counts_are_refused_where_nothing_is_counted():
    env, args, kw = _k6_args("quadrotor2d-slungload-v0", 8)
    counts = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="normalisers"):
        pr.ppo_rollout(*args, 2, counts=counts, normalize_obs=False, **kw)
    quad = reinmav_tpu_torch.make("quadrotor2d-v0")
    s = quad.vreset(torch.Generator(), 8).T.contiguous()
    layout = sac.MlpLayout((5, 32, 32, 4))
    w = op.actor_kernel_args(layout.layers(sac.init_mlp(layout, torch.Generator())))
    with pytest.raises(ValueError, match="taut counts"):
        op.collect_step("quadrotor2d-v0", "sac", s, 1, sac.collect_consts(quad, torch.tensor(False),
                        0.0), pr.env_params_vec(quad), *w, counts=counts)
    with pytest.raises(ValueError, match="int32"):
        pr.ppo_rollout(*args, 2, counts=torch.zeros(8), **kw)


def test_reinmav_kernel_branch_reward_is_anchored(monkeypatch):
    """throughput_rollout's K10 branch returns 90 * horizon + 0 * x: NaN for
    an env whose state went non-finite, 90 * horizon for the others.  On
    the CPU the wrapper runs the twin; the device check is lifted so that
    the branch runs here."""
    monkeypatch.setattr(core, "_kernel_refusal", lambda env, s: core.fused_kernel_mismatch(env))
    env = reinmav_tpu_torch.make("reinmav-v0")
    s = env.vreset(torch.Generator().manual_seed(0), 4)
    s[2, 0] = float("nan")
    before = rr.reinmav_rollout.launches
    final, rew = reinmav_tpu_torch.throughput_rollout(env, s, torch.Generator(), 3,
                                                      backend="kernel")
    assert rr.reinmav_rollout.launches == before  # the twin, not a launch
    assert bool(rew[2].isnan()) and bool(final[2, 0].isnan())
    assert torch.equal(rew[[0, 1, 3]], torch.full((3,), 270.0))
