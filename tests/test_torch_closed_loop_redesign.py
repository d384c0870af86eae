"""The closed-loop template's redesign (K8/K9, csrc/closed_loop_rollout.cu),
on the CPU: what its CUDA code does that the JAX kernels' tests cannot see.

- The branch-free tether body: the twin's slung-load steps
  (``ops.closed_loop_rollout.LOOP_STEPS``) against the two-branch form of
  ``pallas_slungload.py``'s steps written out in float32 (both branches,
  then a select per lane), bit for bit on every lane of random states, the
  slack lanes with non-finite tether directions included.
- The optional counts: the twin's per-env counts against a recount, step by
  step, from the states themselves.

Exact comparisons: no tolerance.
"""

import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.ops import closed_loop_rollout as cl
from reinmav_tpu_torch.ops.rollout import reset_draws

SLUNG = ["quadrotor2d-slungload-v0", "quadrotor3d-slungload-v0"]
KINDS = ["quadrotor2d-v0", *SLUNG]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Where ``a`` and ``b`` hold the same float32 bits (any NaN equal to any NaN)."""
    return (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())


def _consts(kind):
    return cl._scalars(cl.KINDS[kind].fields, cl.KINDS[kind].pack(None))


def _slung_states(kind, batch, seed):
    """Random states, tether norms straddling L, and eight rows whose tether
    direction is NaN (quad and load at +inf on x: a slack NaN norm) or whose
    tether overflows (an infinite norm: taut, a NaN direction)."""
    rng = np.random.default_rng(seed)
    env = reinmav_tpu_torch.make(kind)
    d, k = env.state_dim, (3 if kind.startswith("quadrotor3d") else 2)
    s = rng.uniform(-1.0, 1.0, (d, batch)).astype(np.float32)
    L = env.params.tether_length
    s[d - 2 * k:d - k] = s[0:k] + rng.normal(size=(k, batch)) * 1.1 * L / np.sqrt(k)
    s[0, :4] = s[d - 2 * k, :4] = np.inf
    s[0, 4:8], s[d - 2 * k, 4:8] = -3e38, 3e38
    return torch.from_numpy(s), torch.from_numpy(
        rng.normal(0.0, 3.0, (env.action_dim, batch)).astype(np.float32))


def two_branch_slung2d(s, act, c):
    """``_slung2d_step_tiles``'s dynamics (pallas_slungload.py:229-296) as
    written there: the taut and the slack branch, then a select, in float32
    with the kernel's products by 1 / m."""
    x, z, th, vx, vz, lx, lz, lvx, lvz = s.unbind(0)
    thrust, w = act[0], act[1]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    m, ml, dt, gz, L = (f32(c[k]) for k in ("mass", "load_mass", "dt", "gravity",
                                             "tether_length"))
    inv_m, inv_msum = f32(c["inv_m"]), f32(c["inv_mml"])
    hx, hz = torch.cos(th + cl._HALF_PI), torch.sin(th + cl._HALF_PI)
    tx, tz = lx - x, lz - z
    tn = torch.sqrt(tx * tx + tz * tz)
    inv_tn = 1.0 / torch.where(tn > 0.0, tn, 1.0)
    ux, uz = tx * inv_tn, tz * inv_tn
    taut = tn >= L
    tvx, tvz = thrust * hx, thrust * hz
    cc = m * L * (lvx * lvx + lvz * lvz)
    proj = ux * (tvx - cc) + uz * (tvz - cc)
    lax_ = proj * ux * inv_msum
    laz_ = proj * uz * inv_msum + gz
    lvx_t, lvz_t = lvx + lax_ * dt, lvz + laz_ * dt
    lpx_t = lx + lvx_t * dt + 0.5 * lax_ * dt * dt
    lpz_t = lz + lvz_t * dt + 0.5 * laz_ * dt * dt
    tmag = ml * torch.sqrt(lax_ * lax_ + (laz_ - gz) * (laz_ - gz))
    ax_t = thrust * inv_m * hx + tmag * ux * inv_m
    az_t = thrust * inv_m * hz + gz + tmag * uz * inv_m
    vx_t, vz_t = vx + ax_t * dt, vz + az_t * dt
    px_t = x + vx_t * dt + 0.5 * ax_t * dt * dt
    pz_t = z + vz_t * dt + 0.5 * az_t * dt * dt
    dx, dz = lpx_t - px_t, lpz_t - pz_t
    dn = torch.sqrt(dx * dx + dz * dz)
    inv_dn = 1.0 / torch.where(dn > 0.0, dn, 1.0)
    ddx, ddz = dx * inv_dn, dz * inv_dn
    lpx_t, lpz_t = px_t + ddx * L, pz_t + ddz * L
    rad = (lvx_t - vx_t) * ddx + (lvz_t - vz_t) * ddz
    lvx_t, lvz_t = lvx_t - rad * ddx, lvz_t - rad * ddz
    lvx_s, lvz_s = lvx, lvz + gz * dt
    lpx_s = lx + lvx_s * dt
    lpz_s = lz + lvz_s * dt + 0.5 * gz * dt * dt
    ax_s, az_s = thrust * inv_m * hx, thrust * inv_m * hz + gz
    vx_s, vz_s = vx + ax_s * dt, vz + az_s * dt
    px_s = x + vx_s * dt + 0.5 * ax_s * dt * dt
    pz_s = z + vz_s * dt + 0.5 * az_s * dt * dt
    sel = lambda a, b: torch.where(taut, a, b)  # noqa: E731
    return torch.stack([sel(px_t, px_s), sel(pz_t, pz_s), th + w * dt, sel(vx_t, vx_s),
                        sel(vz_t, vz_s), sel(lpx_t, lpx_s), sel(lpz_t, lpz_s),
                        sel(lvx_t, lvx_s), sel(lvz_t, lvz_s)]), taut


def two_branch_slung3d(s, act, c):
    """``_slung3d_step_tiles``'s dynamics (pallas_slungload.py:101-185) as
    written there, in float32; the quaternion update and the body axis are
    the twin's own (no branch there)."""
    (px, py, pz, qw, qx, qy, qz, vx, vy, vz, lx, ly, lz, lvx, lvy, lvz) = s.unbind(0)
    thrust, wx, wy, wz = act.unbind(0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    m, ml, dt, gz, L = (f32(c[k]) for k in ("mass", "load_mass", "dt", "gravity",
                                             "tether_length"))
    inv_m, inv_msum = f32(c["inv_m"]), f32(c["inv_mml"])
    _, bzx, bzy, bzz = cl.body_z(s)
    tx, ty, tz = lx - px, ly - py, lz - pz
    tn = torch.sqrt(tx * tx + ty * ty + tz * tz)
    inv_tn = 1.0 / torch.where(tn > 0.0, tn, 1.0)
    ux, uy, uz = tx * inv_tn, ty * inv_tn, tz * inv_tn
    taut = tn >= L
    tvx, tvy, tvz = thrust * bzx, thrust * bzy, thrust * bzz
    cc = m * L * (lvx * lvx + lvy * lvy + lvz * lvz)
    proj = ux * (tvx - cc) + uy * (tvy - cc) + uz * (tvz - cc)
    lax_, lay_ = proj * ux * inv_msum, proj * uy * inv_msum
    laz_ = proj * uz * inv_msum + gz
    lpx_t = lx + lvx * dt + 0.5 * lax_ * dt * dt
    lpy_t = ly + lvy * dt + 0.5 * lay_ * dt * dt
    lpz_t = lz + lvz * dt + 0.5 * laz_ * dt * dt
    lvx_t, lvy_t, lvz_t = lvx + lax_ * dt, lvy + lay_ * dt, lvz + laz_ * dt
    tmag = ml * torch.sqrt(lax_ * lax_ + lay_ * lay_ + (laz_ - gz) * (laz_ - gz))
    ax_t = thrust * inv_m * bzx + tmag * ux * inv_m
    ay_t = thrust * inv_m * bzy + tmag * uy * inv_m
    az_t = thrust * inv_m * bzz + gz + tmag * uz * inv_m
    px_t = px + vx * dt + 0.5 * ax_t * dt * dt
    py_t = py + vy * dt + 0.5 * ay_t * dt * dt
    pz_t = pz + vz * dt + 0.5 * az_t * dt * dt
    vx_t, vy_t, vz_t = vx + ax_t * dt, vy + ay_t * dt, vz + az_t * dt
    dx, dy, dz = lpx_t - px_t, lpy_t - py_t, lpz_t - pz_t
    dn = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv_dn = 1.0 / torch.where(dn > 0.0, dn, 1.0)
    ddx, ddy, ddz = dx * inv_dn, dy * inv_dn, dz * inv_dn
    lpx_t, lpy_t, lpz_t = px_t + ddx * L, py_t + ddy * L, pz_t + ddz * L
    rad = (lvx_t - vx_t) * ddx + (lvy_t - vy_t) * ddy + (lvz_t - vz_t) * ddz
    lvx_t, lvy_t, lvz_t = lvx_t - rad * ddx, lvy_t - rad * ddy, lvz_t - rad * ddz
    lpx_s, lpy_s = lx + lvx * dt, ly + lvy * dt
    lpz_s = lz + lvz * dt + 0.5 * gz * dt * dt
    lvx_s, lvy_s, lvz_s = lvx, lvy, lvz + gz * dt
    ax_s, ay_s = thrust * inv_m * bzx, thrust * inv_m * bzy
    az_s = thrust * inv_m * bzz + gz
    px_s = px + vx * dt + 0.5 * ax_s * dt * dt
    py_s = py + vy * dt + 0.5 * ay_s * dt * dt
    pz_s = pz + vz * dt + 0.5 * az_s * dt * dt
    vx_s, vy_s, vz_s = vx + ax_s * dt, vy + ay_s * dt, vz + az_s * dt
    sel = lambda a, b: torch.where(taut, a, b)  # noqa: E731
    return torch.stack([sel(px_t, px_s), sel(py_t, py_s), sel(pz_t, pz_s), qw, qx, qy, qz,
                        sel(vx_t, vx_s), sel(vy_t, vy_s), sel(vz_t, vz_s), sel(lpx_t, lpx_s),
                        sel(lpy_t, lpy_s), sel(lpz_t, lpz_s), sel(lvx_t, lvx_s),
                        sel(lvy_t, lvy_s), sel(lvz_t, lvz_s)]), taut


@pytest.mark.parametrize("kind", SLUNG)
def test_branch_free_tether_is_bitwise_the_two_branch_form(kind):
    """On 2^16 random states with both branches populated, every lane of the
    twin's branch-free step holds the two-branch form's bits: the slack
    lanes (the load's acceleration selected to free fall, the pull on the
    quad to 0) and the taut ones (the same arithmetic); on the slack lanes
    whose tether direction is NaN the quad stays finite, which a pull
    multiplied by zero would not."""
    s, act = _slung_states(kind, 1 << 16, seed=11)
    c = _consts(kind)
    got, _, _, taut = cl.LOOP_STEPS[kind](s, act, c)
    want, taut_ref = (two_branch_slung2d if kind.startswith("quadrotor2d")
                      else two_branch_slung3d)(s, act, c)
    assert torch.equal(taut, taut_ref)
    slack = ~taut
    assert 0.2 < float(slack.float().mean()) < 0.8
    rows = [r for r in range(s.shape[0]) if not 3 <= r < 7] if kind.endswith(
        "3d-slungload-v0") else list(range(s.shape[0]))  # the quaternion: no branch
    bits = same_bits(got[rows], want[rows])
    assert bool(bits[:, slack].all()), int((~bits[:, slack]).sum())
    assert bool(bits.all()), int((~bits).sum())
    nan_dir = slack[:4]
    assert bool(nan_dir.all()) and bool(taut[4:8].all())
    vel = slice(3, 5) if kind.startswith("quadrotor2d") else slice(7, 10)
    assert bool(torch.isfinite(got[vel, :4]).all())


@pytest.mark.parametrize("kind", KINDS)
def test_twin_counts_match_a_recount(kind):
    """The twin's counts over 40 steps with resets on equal a recount from
    the states, step by step (the tether norm at the start of each step
    against L; for quad2d the steps whose reward is the done reward 1),
    and asking for counts changes no state bit."""
    env = reinmav_tpu_torch.make(kind)
    gen = torch.Generator().manual_seed(5)
    s = (env.vreset(gen, 512) * 1.5).T.contiguous()
    counts = torch.full((512,), -1, dtype=torch.int32)
    final, rew = cl.closed_loop_rollout(kind, s, 3, 40, counts=counts)
    plain, plain_rew = cl.closed_loop_rollout(kind, s, 3, 40)
    assert torch.equal(final, plain) and torch.equal(rew, plain_rew)

    c, k = _consts(kind), cl.KINDS[kind]
    x, recount = s.clone(), torch.zeros(512, dtype=torch.int32)
    for t in range(40):
        if kind == "quadrotor2d-v0":
            x, reward, done, _ = cl.LOOP_STEPS[kind](x, k.control(x, c), c)
            recount += (reward == 1.0).int()
        else:
            q = 3 if kind.startswith("quadrotor3d") else 2
            d = k.state_dim
            tether = x[d - 2 * q:d - q] - x[0:q]
            tn2 = tether[0] * tether[0] + tether[1] * tether[1]
            if q == 3:
                tn2 = tn2 + tether[2] * tether[2]
            recount += (torch.sqrt(tn2) >= c["tether_length"]).int()
            x, reward, done, _ = cl.LOOP_STEPS[kind](x, k.control(x, c), c)
        idx = torch.nonzero(done).squeeze(1)
        x[:, idx] = reset_draws(idx, t, 3, 0, k.state_dim)
    assert torch.equal(x, final)
    assert torch.equal(counts, recount)
    assert 0 < int(counts.sum()) < 512 * 40
    with pytest.raises(ValueError, match="counts"):
        cl.closed_loop_rollout(kind, s, 3, 1, counts=torch.zeros(512, dtype=torch.int64))
