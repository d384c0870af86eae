"""Kernel K11's plain twin (reinmav_tpu_torch.ops.contact_rollout) for
MujocoQuadForce-v0 and MujocoQuadQuat-v0 against the JAX package's contact
kernel (``pallas_tpuquad.contact_rollout_pallas8``, in interpret mode as
tests/test_pallas_tpuquad.py runs it) and against the port's eager env
step, on the CPU.

Against the JAX kernel, in float32 with ``_PGS_ITERS = 8`` on both sides
(as the JAX package's test lowers it: kernel and twin agreeing is a
property of each sweep's arithmetic, whatever their number): 64 envs from
the JAX test's contact-heavy states, 12 steps one at a time from the JAX
scan path's state, at that test's rtol 2e-4 / atol 2e-5; then, for the
force model (the same compiled kernel, 12 more calls), 12 free-running
steps, mean Σz within 1% and the bodies on the plane, as that test checks.
Against the eager env step in float64 at the full 120 sweeps, 20 steps, at
1e-9: the same solve in another algebra.  The 16-candidate tier bitwise
the 48-candidate sweep without arm contact.  The twin's rigid-body substep
bitwise the hover twin's in flight (csrc/contact_rollout.cu keeps its own
copy of csrc/hover_common.cuh's arithmetic; each kernel is held to its twin
on the card).  The kernel's lane schedule of a stage's four sums (the
half-warp's transposed butterfly) emulated in float32, bitwise
``candidate_sum``; and the pairing contract the kernel's two envs a warp
rely on: no env's result depends on its neighbour's, but for the sign of
a zero.
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
from reinmav_tpu.ops import pallas_tpuquad
from reinmav_tpu_torch.envs import core, tpuquad
from reinmav_tpu_torch.ops import contact_rollout as cr

MODELS = [("MujocoQuadForce-v0", "ground"), ("MujocoQuadQuat-v0", "quat")]
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _states(batch=64, seed=3, tilt=0.25, z_lo=0.0):
    """tests/test_pallas_tpuquad.py's contact-heavy states, (B, 13) float32
    (z from ``z_lo`` to 0.05)."""
    rng = np.random.default_rng(seed)
    base = np.tile(np.asarray(pallas_tpuquad._INIT0, np.float32), (batch, 1))
    base[:, 2] += rng.uniform(z_lo, 0.05, batch)
    base[:, 4:7] += rng.uniform(-tilt, tilt, (batch, 3))
    base[:, 7:13] += rng.uniform(-0.2, 0.2, (batch, 6))
    base[:, 3:7] /= np.linalg.norm(base[:, 3:7], axis=1, keepdims=True)
    return base


def _jax_zero_action_step(env):
    """One zero-action step of the JAX env with its auto-reset, jitted."""
    def step(s):
        out = env.autoreset_step(s, jnp.zeros((s.shape[0], 4), s.dtype), jax.random.PRNGKey(0))
        return out.state
    return jax.jit(step)


@pytest.mark.parametrize("env_id,model", MODELS)
def test_twin_matches_jax_kernel_in_interpret_mode(env_id, model, monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    for module in (jtq, pallas_tpuquad, cr):
        monkeypatch.setattr(module, "_PGS_ITERS", 8)
    vec = cr.contact_params_vec(reinmav_tpu_torch.make(env_id).params)

    def jax_kernel(s):
        with pltpu.force_tpu_interpret_mode():
            f, z = pallas_tpuquad.contact_rollout_pallas8(jnp.asarray(s).T, 1, model=model,
                                                           tile8=8)
        return np.asarray(f).T, np.asarray(z)

    def twin(s):
        f, z = cr.contact_rollout(torch.from_numpy(s.T.copy()), 1, params_vec=vec)
        return f.T.numpy(), z.numpy()

    # One step at a time from the scan path's state: the active test, the
    # f >= 0 projection and the spline's knot are knife edges that f32
    # reassociation flips, and a free run amplifies a flip.
    scan_step = _jax_zero_action_step(reinmav_tpu.make(env_id))
    s = _states()
    for t in range(12):
        (f_pal, z_pal), (f_tw, z_tw) = jax_kernel(s), twin(s)
        np.testing.assert_allclose(f_tw, f_pal, err_msg=f"{env_id} step {t}", **TOL)
        np.testing.assert_allclose(z_tw, z_pal, **TOL)
        s = np.asarray(scan_step(jnp.asarray(s)))

    # Free-running (loose): both settle the batch on the plane and agree on
    # the batch's mean Σz.  One model: the leg checks the rollout's
    # accumulation, which the models share.
    if model != "ground":
        return
    a = b = _states()
    z_a = z_b = 0.0
    for _ in range(12):
        (a, za), (b, zb) = jax_kernel(a), twin(b)
        z_a, z_b = z_a + za, z_b + zb
    np.testing.assert_allclose(float(np.mean(z_b)), float(np.mean(z_a)), rtol=1e-2)
    assert b[:, 2].min() > -0.1


@pytest.mark.parametrize("env_id", [m for m, _ in MODELS])
def test_twin_in_float64_matches_the_eager_env(env_id):
    """The full 120 sweeps, 20 steps, float64: the twin (the TPU kernel's
    arithmetic) and the env's own batched solve (another algebra) agree to
    1e-9, with arm contacts (tilts up to 0.25) among the envs."""
    env = reinmav_tpu_torch.make(env_id)
    vec = cr.contact_params_vec(env.params, dtype=torch.float64)
    s = torch.from_numpy(_states(32, 5).astype(np.float64))
    zero = torch.zeros((32, 4), dtype=torch.float64)
    arm_contacts = 0
    for _ in range(20):
        want = env.vstep(s, zero).state
        got, z = cr.contact_rollout_reference(s.T.contiguous(), 1, params_vec=vec)
        np.testing.assert_allclose(got.T.numpy(), want.numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(z.numpy(), want[:, 2].numpy(), rtol=1e-9, atol=1e-9)
        rot = tpuquad.qm.quat_to_rotmat(tpuquad.qm.quat_normalize(s[:, 3:7]))
        arm_contacts += int((tpuquad.candidate_z(s[:, 0:3], rot)[:, 16:] < 0).any(dim=1).sum())
        s = want
    assert arm_contacts > 0


@pytest.mark.parametrize("env_id", [m for m, _ in MODELS])
def test_tiers_are_bitwise_without_arm_contact(env_id):
    """Nearly level bodies low on the plane touch with core corners only,
    no arm corner: the gated twin (16 candidates) and the forced
    48-candidate sweep are bitwise equal, in float32 and float64."""
    env = reinmav_tpu_torch.make(env_id)
    for dtype in (torch.float32, torch.float64):
        vec = cr.contact_params_vec(env.params, dtype=dtype)
        s = torch.from_numpy(_states(16, 6, tilt=0.02, z_lo=0.015).T.copy()).to(dtype)
        gated = cr.contact_rollout_reference(s, 3, params_vec=vec, record_tiers=True)
        forced = cr.contact_rollout_reference(s, 3, params_vec=vec, force48=True,
                                              record_tiers=True)
        assert torch.equal(gated[0], forced[0]) and torch.equal(gated[1], forced[1])
        # Every substep of every env in contact ran 16 candidates, or 48 forced.
        assert torch.equal(gated[2][:, 1] + gated[2][:, 0], torch.full((16,), 6, dtype=torch.int32))
        assert torch.equal(forced[2][:, 2], gated[2][:, 1]) and int(gated[2][:, 2].sum()) == 0
    for x in (s, gated[0]):
        rot = tpuquad.qm.quat_to_rotmat(tpuquad.qm.quat_normalize(x.T[:, 3:7]))
        z = tpuquad.candidate_z(x.T[:, 0:3], rot)
        assert bool((z[:, :16] < 0).any()) and not bool((z[:, 16:] < 0).any())


def test_candidate_sum_is_the_jax_halving_order():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((5, 48)).astype(np.float32))
    want = np.asarray(pallas_tpuquad._candidate_sum(jnp.asarray(
        np.repeat(x.numpy().T, 8, axis=0))))[0]
    np.testing.assert_array_equal(cr.candidate_sum(x).numpy(), want)
    np.testing.assert_array_equal(cr.candidate_sum(x[:, :16]).numpy(), np.asarray(
        pallas_tpuquad._candidate_sum(jnp.asarray(np.repeat(x[:, :16].numpy().T, 8, axis=0))))[0])


@pytest.mark.parametrize("env_id", [m for m, _ in MODELS])
def test_nonfinite_states_reset_to_rest(env_id):
    """A non-finite env resets to (0, 0, init_z) at rest after its step, its
    Σz taking the non-finite z; the others step on (init_z from the
    Params)."""
    factory = tpuquad.make_force_ground if env_id == "MujocoQuadForce-v0" else tpuquad.make_quat
    env = factory(reinmav_tpu_torch.make(env_id).params._replace(init_z=0.2))
    vec = cr.contact_params_vec(env.params)
    s = _states(4, 8)
    s[1, 8] = np.nan
    s[2, 11] = np.inf
    final, z = cr.contact_rollout(torch.from_numpy(s.T.copy()), 1, params_vec=vec)
    rest = np.asarray([0.0, 0.0, 0.2, 1.0] + [0.0] * 9, np.float32)
    np.testing.assert_array_equal(final[:, 1].numpy(), rest)
    np.testing.assert_array_equal(final[:, 2].numpy(), rest)
    assert not np.isfinite(z[1].item()) and not np.isfinite(z[2].item())
    assert bool(torch.isfinite(final[:, [0, 3]]).all()) and bool(torch.isfinite(z[[0, 3]]).all())
    # The eager env's auto-reset agrees on the reset pose.
    out = env.autoreset_step(torch.from_numpy(s), torch.zeros((4, 4)), torch.Generator())
    np.testing.assert_array_equal(out.state[1].numpy(), rest)


@pytest.mark.parametrize("env_id", [m for m, _ in MODELS])
def test_z_sum_and_the_cpu_throughput_path(env_id, caplog):
    """Σz is the sum of z after each step; throughput_rollout on the CPU runs
    the eager loop and says why, with the env's zero reward; the kernel path
    refuses contact_enabled=False by name."""
    env = reinmav_tpu_torch.make(env_id)
    vec = cr.contact_params_vec(env.params)
    s = torch.from_numpy(_states(8, 9).T.copy())
    final, z = cr.contact_rollout(s, 3, params_vec=vec)
    x, total = s, torch.zeros(8)
    for _ in range(3):
        x, z1 = cr.contact_rollout(x, 1, params_vec=vec)
        total = total + x[2]
        assert torch.equal(z1, x[2])
    assert torch.equal(x, final) and torch.equal(total, z)
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        f_e, r_e = reinmav_tpu_torch.throughput_rollout(env, s.T.contiguous(), torch.Generator(), 3)
    assert "eager loop (states on cpu, the kernel needs a CUDA tensor)" in caplog.text
    assert torch.equal(r_e, torch.zeros(8))
    np.testing.assert_allclose(f_e.numpy(), final.T.numpy(), rtol=2e-4, atol=2e-5)
    assert core.fused_kernel_mismatch(env) is None
    off = dataclasses.replace(env, params=env.params._replace(contact_enabled=False))
    assert "contact_enabled=False" in core.fused_kernel_mismatch(off)
    with pytest.raises(ValueError, match="contact_enabled"):
        cr.contact_params_vec(off.params)


@pytest.mark.parametrize("env_id", [m for m, _ in MODELS])
def test_kernel_dispatch_reward_is_zero_times_z_sum(env_id, monkeypatch):
    """throughput_rollout's K11 branch returns 0 * Σz as the reward sums,
    as the JAX kernel path does: NaN for an env whose z went non-finite, 0
    for the others.  On the CPU the wrapper runs the twin; the device check
    is lifted so that the branch runs here."""
    monkeypatch.setattr(core, "_kernel_refusal", lambda env, s: core.fused_kernel_mismatch(env))
    env = reinmav_tpu_torch.make(env_id)
    s = torch.from_numpy(_states(4, 10))
    s[2, 2] = float("nan")
    before = cr.contact_rollout.launches
    final, rew = reinmav_tpu_torch.throughput_rollout(env, s, torch.Generator(), 2,
                                                      backend="kernel")
    assert cr.contact_rollout.launches == before  # the twin, not a launch
    assert bool(rew[2].isnan()) and torch.equal(rew[[0, 1, 3]], torch.zeros(3))
    assert bool(torch.isfinite(final).all())  # the bad env reset and stepped on


def test_rigid_substep_is_the_hover_substep():
    """Bodies in flight (no candidate below the plane, so the contact
    solve adds nothing): the twin's substep with the hover twin's constants
    is bitwise hover_rollout's substep, over 20 substeps under a constant
    action."""
    from reinmav_tpu_torch.ops import hover_rollout as hr

    p = tpuquad.Params(init_z=1.0)
    h = hr.hover_consts(hr.hover_params_vec(p))
    wrench = tuple(float(v) for v in hr.hover_wrench([0.8, 0.7, 0.75, 0.72], h))
    c, points = cr._consts(cr.contact_params_vec(p))
    c.update(kv=h["kv"], kt=h["kt"], fdx=h["fx"], fdy=h["fy"], fdz=h["fz"], tdx=h["tx"],
             tdy=h["ty"], tdz=h["tz"], gm=float(np.float32(h["gravity"]) * np.float32(h["mass"])),
             total=wrench[0], mx=wrench[1], my=wrench[2], mz=wrench[3])
    for k in ("mass", "ix", "iy", "iz", "dt"):
        assert c[k] == h[k]
    assert c["cz"] == h["com_z"]
    x = torch.from_numpy(_states(64, 11).T.copy())
    x[2] += 1.0
    a = b = list(x.unbind(0))
    for _ in range(20):
        a, tier = cr.contact_substep(a, c, points)
        b = hr.hover_substep(b, h, wrench)
        assert int(tier.sum()) == 0
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    assert float(a[2].min()) > 0.5


def test_params_vec_and_wrapper_checks():
    vec = cr.contact_params_vec().numpy()
    c = dict(zip(cr.SCALAR_FIELDS, vec))
    assert len(vec) == cr.N_PARAMS and c["servo"] == 0.0 and c["total"] == 0.0
    assert c["gm"] == np.float32(-9.81 * 0.3) and c["kappa"] == np.float32(2.0 * 2.0 / 0.3)
    np.testing.assert_array_equal(vec[len(cr.SCALAR_FIELDS):].reshape(48, 3)[16:],
                                  np.asarray(tpuquad._ARM_CORNERS, np.float32))
    # The constant action's wrench: the force model's motor mix, the quat
    # model's clipped thrust and rate commands.
    f = dict(zip(cr.SCALAR_FIELDS, cr.contact_params_vec(tpuquad.Params(),
                                                         (0.5, 2.0, 0.0, 0.25)).numpy()))
    assert f["total"] == np.float32(1.75) and f["mx"] == np.float32(0.1 * (0.5 - 1.0 + 0.25))
    q = dict(zip(cr.SCALAR_FIELDS, cr.contact_params_vec(tpuquad.QuatParams(),
                                                         (5.0, 2.0, -0.5, 0.0)).numpy()))
    assert (q["total"], q["servo"], q["cmd0"], q["cmd1"]) == (4.0, 1.0, 1.0, -0.5)
    with pytest.raises(ValueError, match="tpuquad.Params or QuatParams"):
        cr.contact_params_vec(jtq.Params())
    s = torch.from_numpy(_states(8).T.copy())
    with pytest.raises(TypeError, match="float32"):
        cr.contact_rollout(s.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        cr.contact_rollout(s.T.contiguous().T, 2)
    with pytest.raises(ValueError, match=r"\(13, B\)"):
        cr.contact_rollout(s[:10].contiguous(), 2)
    with pytest.raises(ValueError, match="frame_skip"):
        cr.contact_rollout(s, 2, frame_skip=0)
    with pytest.raises(ValueError, match="params_vec"):
        cr.contact_rollout(s, 2, params_vec=torch.zeros(5))
    f0, z0 = cr.contact_rollout(s[:, :3].contiguous(), 0)
    assert torch.equal(f0, s[:, :3]) and torch.equal(z0, torch.zeros(3))


def _halving16(v: torch.Tensor) -> torch.Tensor:
    """csrc/contact_rollout.cu::halving16, lane by lane: ``v`` ``(..., 4,
    16)`` holds the four values of the half's 16 lanes; returns ``(...,
    16)``, lane l's finished sum 2 * bit3(l) + bit2(l)."""
    lane = torch.arange(16)
    b3, b2 = (lane & 8) != 0, (lane & 4) != 0

    def shfl_xor(x, off):
        return x[..., lane ^ off]

    keep0, keep1 = torch.where(b3, v[..., 2, :], v[..., 0, :]), torch.where(b3, v[..., 3, :], v[..., 1, :])
    send0, send1 = torch.where(b3, v[..., 0, :], v[..., 2, :]), torch.where(b3, v[..., 1, :], v[..., 3, :])
    p0, p1 = keep0 + shfl_xor(send0, 8), keep1 + shfl_xor(send1, 8)
    q = torch.where(b2, p1, p0) + shfl_xor(torch.where(b2, p0, p1), 4)
    q = q + shfl_xor(q, 2)
    return q + shfl_xor(q, 1)


def _kernel_sums(x: torch.Tensor) -> torch.Tensor:
    """The kernel's four sums of a stage over ``x`` ``(..., 4, nc)`` (nc 16
    or 48; lane l holds candidates l, 16 + l and 32 + l): ``(..., 16)`` per
    lane before the broadcast, then the four broadcast sums ``(..., 4)``."""
    if x.shape[-1] == 16:
        q = _halving16(x)
    else:
        q = _halving16(x[..., :16] + x[..., 16:32]) + _halving16(x[..., 32:])
    return q, q[..., [0, 4, 8, 12]]


def _bits(x):
    return x.view(torch.int32)


def _same_bits(a, b) -> bool:
    """Bit for bit equal, except that +0 and -0 count as equal: the twin
    adds a zero contact wrench to an env without contact when another env
    of its batch has one (the TPU kernel: when another env of its tile has
    one), and -0 + 0 is +0."""
    return bool(((_bits(a) == _bits(b)) | ((a == 0) & (b == 0))).all())


@pytest.mark.parametrize("nc", [16, 48])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_half_warp_butterfly_is_candidate_sum(nc, seed):
    """The transposed butterfly's exact lane schedule (sends, keeps, selects
    on lane bits 3 and 2, the width-16 broadcast from lanes 0, 4, 8, 12) is
    bitwise candidate_sum's halving tree, for 16 and for 48 candidates, on
    seeded inputs with +-0, +-inf and NaN among them; every lane that holds
    a sum holds the same bits.  NaN results are compared as NaN: their
    payload is not part of IEEE addition's commutativity on the host (the
    card returns its canonical NaN)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((256, 4, nc)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-30, 30, x.shape).astype(np.float32)
    special = rng.random(x.shape)
    x[special < 0.15] = 0.0
    x[(special >= 0.15) & (special < 0.25)] = -0.0
    rows = rng.random(256)
    hot = rng.random(x.shape) < 0.05
    x[(rows[:, None, None] < 0.2) & hot] = np.inf
    x[(rows[:, None, None] >= 0.2) & (rows[:, None, None] < 0.35) & hot] = -np.inf
    x[(rows[:, None, None] >= 0.35) & (rows[:, None, None] < 0.45) & hot] = np.nan
    zeros = (rows > 0.85) & (rows <= 0.92)
    x[zeros] = np.where(rng.random((int(zeros.sum()), 4, nc)) < 0.5, 0.0, -0.0)
    x[rows > 0.92] = -0.0
    x = torch.from_numpy(x)
    lanes, got = _kernel_sums(x)
    want = cr.candidate_sum(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])
    for j, lane in enumerate((0, 4, 8, 12)):  # the lanes that hold sum j agree
        held = lanes[..., [lane, lane + 1, lane + 2, lane + 3]]
        ok = ~torch.isnan(held[..., :1]).expand_as(held)
        assert torch.equal(_bits(held)[ok], _bits(held[..., :1].expand_as(held))[ok])
    assert int(nan.sum()) > 0 and int((_bits(want) == _bits(torch.tensor(-0.0))).sum()) > 0


def _kind_states(kind: str, n: int, seed: int) -> torch.Tensor:
    """``(13, n)`` float32 states whose first substep has no contact
    ("none": in flight), core or cap contacts only ("16"), or an arm corner
    below the plane ("48")."""
    if kind == "none":
        s = _states(n, seed)
        s[:, 2] += 1.0
        return torch.from_numpy(s.T.copy())
    if kind == "16":
        return torch.from_numpy(_states(n, seed, tilt=0.02, z_lo=0.015).T.copy())
    pool = torch.from_numpy(_states(16 * n, seed).T.copy())
    _, _, tiers = cr.contact_rollout_reference(pool, 1, frame_skip=1, record_tiers=True)
    pick = torch.nonzero(tiers[:, 2] == 1).squeeze(1)[:n]
    assert pick.numel() == n
    return pool[:, pick].contiguous()


@pytest.mark.parametrize("env_id", [m for m, _ in MODELS])
def test_twin_env_results_do_not_depend_on_the_neighbour(env_id, monkeypatch):
    """The pairing contract of K11's two envs a warp: a batch of envs with
    no contact, on the 16- and on the 48-candidate tier, in every ordered
    pair of neighbours (envs 2i and 2i + 1 share a warp), and its prefixes
    of odd length (the last env's half-warp without a neighbour), give each
    env's state, Σz and tier counts bitwise, the sign of a zero aside, as
    that env run alone.  8 sweeps a substep, as the JAX comparison lowers
    them."""
    monkeypatch.setattr(cr, "_PGS_ITERS", 8)
    vec = cr.contact_params_vec(reinmav_tpu_torch.make(env_id).params)
    kinds = ("none", "16", "48")
    pool = {k: _kind_states(k, 9, 20 + i) for i, k in enumerate(kinds)}
    cols, used = [], {k: 0 for k in kinds}
    for a in kinds:
        for b in kinds:
            for k in (a, b):
                cols.append(pool[k][:, used[k]])
                used[k] += 1
    batch = torch.stack(cols, dim=1).contiguous()
    alone = [cr.contact_rollout(batch[:, i:i + 1].contiguous(), 3, params_vec=vec,
                                record_tiers=True) for i in range(batch.shape[1])]
    for n in (batch.shape[1], 1, 3, 5, 7):
        f, z, t = cr.contact_rollout(batch[:, :n].contiguous(), 3, params_vec=vec,
                                     record_tiers=True)
        for i in range(n):
            fa, za, ta = alone[i]
            assert _same_bits(f[:, i], fa[:, 0]), (n, i)
            assert _same_bits(z[i:i + 1], za) and torch.equal(t[i], ta[0])
    mix = torch.stack([t[0] for _, _, t in alone]).sum(dim=0)
    assert bool((mix > 0).all()), mix  # substeps with no solve, on 16 and on 48
