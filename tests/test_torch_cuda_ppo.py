"""Kernels K2/K6 (the fused PPO rollout), K3 (the fused PPO loss gradient)
and K4 (the one-launch PPO update) on the card, against their plain
PyTorch twins, and the PPO learner launching them.  Every test needs a
CUDA device and the ``nvcc`` that builds the kernels, and skips without a
device.

This file imports no JAX, so that it runs where only PyTorch is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_ppo.py

Tolerances:

- K2: rtol 2e-4 / atol 2e-5 per value (the JAX kernel tests' float32
  tolerances).  An env whose done test lands within rounding of its
  threshold may reset in one and not the other, so the comparison counts
  the envs whose trajectory disagrees anywhere and allows 0.1%.
- K3: gradients rtol 2e-3 / atol 2e-6, metrics rtol 2e-4 / atol 1e-6
  (tests/test_pallas_ppo.py's own): the kernel sums 16k samples in another
  order than the twin.  A rerun must be bitwise equal.
- K4, over a whole update of 4 epochs x 4 minibatches: params rtol 2e-4 /
  atol 1e-6, Adam moments rtol 2e-4 / atol 5e-8, metrics rtol 1e-4 / atol
  1e-6 (tests/test_pallas_ppo_update.py's own) against the K3 loop, whose
  per-pass sums are K4's, and against the twin in every mode at lr 3e-4.
  At lr 1e-3 the critic moves far enough that a sample lands within
  rounding of the value-clip boundary |v - v_old| = value_clip_eps and is
  clipped in one summation order and not in the other; clip-by-global-norm
  then carries the changed critic gradient into every entry's scale.
  The pair of lr 1e-3 cases shows it: with value clipping, a few percent
  of the params leave the JAX tolerance, nearly all of them the critic's
  (held at atol 1e-4, moments at atol 2e-5); the same inputs with value
  clipping off match at the JAX tolerances.  Pass 0's gradient is bitwise
  equal to one K3 launch (the same per-CTA body and reduction order) and
  within K3's gradient tolerance of the twin's; a rerun is bitwise equal.
- K2/K6's bf16 instance (compute_dtype "bfloat16", products on the tensor
  cores) at every kind, against the bf16 twin one step at a time from the
  twin's state (chip_smoke.py's phase 34): rtol 2e-4 / atol 2e-5, no env
  outside on the slung-load kinds (the env-steps within 1e-4 of the tether
  sphere skipped), at most 0.1% on the others; bitwise on a rerun.  Free-
  running, a last-bit difference of the env step moves an obs or a hidden
  unit across a bf16 rounding edge now and then: reported, not compared.
- The bf16 instances of K3 and K4 (compute_dtype "bfloat16", products on
  the tensor cores) at every (obs, action) pair the kernels are built for,
  against the bf16 twin: K3 at K3's tolerances; K4 resynchronised, each
  pass a one-pass launch from the twin's state after the pass before, on
  the pass's minibatch with the samples within 16 ulps of the ratio or
  value clip (on the twin's forward) replaced, at K3's gradient and K4's
  params and moments tolerances; both bitwise on a rerun, K4's pass 0
  bitwise one K3 launch.  The tensor cores sum in their own order, so the
  forward is not the twin's bit for bit, and a free-running update carries
  a weight across a bf16 rounding edge now and then: not compared.
- The wide instances of K3 and K4 (two equal hidden widths other than the
  64-wide instances', here 16, 100, 128 and 256, at (10, 4) and at the
  largest dims they take, (32, 8)), float32 and bf16, clip and KL: K3
  against its twin of the same dtype at K3's tolerances, with
  the samples within 16 ulps of the ratio or value clip on the twin's
  forward replaced (counted), on a grid that the sub-blocks do not divide
  and on a ragged minibatch; K4 resynchronised as the bf16 instance above,
  pass 0 bitwise one K3 wide launch; both bitwise on a rerun.  The PPO
  learner at (128, 128) launches K4 wide once an update and K3 never, and
  ``fused_update="on"`` at (512, 512) raises naming the width.
"""

import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.ops import ppo_loss as pl
from reinmav_tpu_torch.ops import ppo_rollout as pr
from reinmav_tpu_torch.ops import ppo_update as pu
from reinmav_tpu_torch.ops import rollout as ro
from reinmav_tpu_torch.envs import quadrotor3d
from reinmav_tpu_torch.rl import networks, ppo
from reinmav_tpu_torch.utils import checkpoint as ckpt

TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-6)
METRIC_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
MOMENT_TOL = dict(rtol=2e-4, atol=5e-8)
UPDATE_METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
# After a value-clip flip at lr 1e-3 (see the module docstring).
FLIPPED_PARAM_TOL = dict(rtol=2e-4, atol=1e-4)
FLIPPED_MOMENT_TOL = dict(rtol=2e-4, atol=2e-5)
MAX_FLIPPED_OUTSIDE = 0.05
BF16 = "bfloat16"
#: The env of each (obs, action) pair of the K3/K4 kernels (its K2/K6 kind).
DIMS_ENV = {(10, 4): "quadrotor3d-v0", (13, 4): "MujocoQuadForce-v1", (5, 2): "quadrotor2d-v0",
            (9, 2): "quadrotor2d-slungload-v0", (16, 4): "quadrotor3d-slungload-v0"}
DIMS = [pytest.param(d, a, id=f"{d}x{a}") for d, a in pl.KERNEL_DIMS]
RESYNC_ULPS = 16

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rollout_args(device, batch, seed=0, scale=1.0):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=batch, rollout_len=16)
    st = ppo.init_train_state(env, cfg, seed, device=device)
    # Warmed normalisers and a spread of running returns, as the JAX tests.
    obs_norm = ppo.ObsNorm(torch.linspace(-0.1, 0.1, 10, device=device),
                           torch.linspace(0.5, 2.0, 10, device=device),
                           torch.tensor(100.0, device=device))
    ret_norm = ppo.RetNorm(torch.tensor(4.0, device=device), torch.tensor(100.0, device=device))
    consts = ppo._rollout_consts(st.params, networks.Layout(10, 4), obs_norm, ret_norm, 0.99)
    rets = torch.linspace(-1.0, 1.0, batch, device=device)
    return (st.env_states.T.contiguous() * scale, rets, 5, st.params, consts)


def _mismatched(a: pr.RolloutOut, b: pr.RolloutOut) -> torch.Tensor:
    """The envs whose trajectory, final state or return differ anywhere."""
    bad = torch.zeros(a.returns.shape[0], dtype=torch.bool, device=a.returns.device)
    for x, y in zip(a[:5], b[:5]):
        close = torch.isclose(x, y, **TOL)
        bad |= ~close.reshape(-1, close.shape[-1]).all(dim=0)
    bad |= (a.done != b.done).any(dim=0)
    bad |= ~torch.isclose(a.final_states, b.final_states, **TOL).all(dim=0)
    bad |= ~torch.isclose(a.returns, b.returns, **TOL)
    return bad


def _mismatched_envs(a: pr.RolloutOut, b: pr.RolloutOut) -> int:
    """How many envs' trajectory, final state or return differ anywhere."""
    return int(_mismatched(a, b).sum())


def test_k2_matches_twin_with_noise_and_resets(cuda):
    args = _rollout_args(cuda, 4096 + 37, scale=2.5)  # a ragged tail; envs beyond |p| = 3 reset
    before = pr.ppo_rollout.launches
    k = pr.ppo_rollout(*args, 16)
    torch.cuda.synchronize()
    assert pr.ppo_rollout.launches == before + 1
    p = pr.ppo_rollout_reference(*args, 16)
    assert bool(p.done.any()), "no env reset: the leg does not test the reset stream"
    bad = _mismatched_envs(k, p)
    assert bad <= 0.001 * k.returns.shape[0], bad
    np.testing.assert_allclose(k.stats.cpu().numpy(), p.stats.cpu().numpy(), rtol=1e-4, atol=1e-2)
    k2 = pr.ppo_rollout(*args, 16)
    for x, y in zip(k, k2):
        assert torch.equal(x, y)


@pytest.mark.parametrize("norm_obs,norm_rew", [(False, False), (True, False), (False, True)])
def test_k2_switches_match_twin(cuda, norm_obs, norm_rew):
    args = _rollout_args(cuda, 2048, seed=1, scale=0.2)
    k = pr.ppo_rollout(*args, 8, normalize_obs=norm_obs, normalize_rewards=norm_rew)
    p = pr.ppo_rollout_reference(*args, 8, normalize_obs=norm_obs, normalize_rewards=norm_rew)
    assert _mismatched_envs(k, p) == 0
    np.testing.assert_allclose(k.stats.cpu().numpy(), p.stats.cpu().numpy(), rtol=1e-4, atol=1e-2)


def test_k2_takes_live_params(cuda):
    pv = ro.quad3d_params_vec(quadrotor3d.Params(ref_x=0.5, ref_z=1.5, mass=1.2, tau=0.4))
    args = _rollout_args(cuda, 2048, seed=2, scale=0.2)
    k = pr.ppo_rollout(*args, 8, params_vec=pv)
    p = pr.ppo_rollout_reference(*args, 8, params_vec=pv)
    assert _mismatched_envs(k, p) == 0
    default = pr.ppo_rollout(*args, 8)
    assert not torch.equal(k.reward, default.reward)


#: The slung-load kinds, by their position dims: an env-step that starts
#: within KNIFE of the tether sphere is a knife edge (chip_smoke.py's phase
#: 34 skips it).
TETHER = {"quadrotor2d-slungload-v0": 2, "quadrotor3d-slungload-v0": 3}
KNIFE = 1e-4
K2_KINDS = [pytest.param(name, id=name) for name in pr.ENVS]


def _k2_bf16_inputs(device, env_id, batch):
    """K2/K6's inputs for a kind, as chip_smoke.py's phase 34 makes them:
    quadrotor3d states twice a reset's spread (the envs past |p| = 3 reset
    at once), hover states between z = 0.35 and 1, the other kinds'
    U(-1, 1) times 1.5 (the loads about 1.1 tether lengths from the quad);
    warmed normalisers, log_std -0.5, a spread of running returns."""
    env = reinmav_tpu_torch.make(env_id)
    gen = torch.Generator(device=device).manual_seed(34)
    d, a = env.obs_dim, env.action_dim
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)  # noqa: E731
    if env_id == "quadrotor3d-v0":
        s = env.vreset(gen, batch).T * 2.0
    elif env_id == "MujocoQuadForce-v1":
        s = torch.zeros((13, batch), device=device)
        s[0:2] = (u(2, batch) * 2.0 - 1.0) * 0.3
        s[2] = 0.35 + 0.65 * u(batch)
        s[3] = 1.0
        s[7:13] = (u(6, batch) * 2.0 - 1.0) * 0.5
    else:
        s = (u(d, batch) * 2.0 - 1.0) * 1.5
        k = TETHER.get(env_id)
        if k is not None:
            s[d - 2 * k:d - k] = s[0:k] + torch.randn((k, batch), generator=gen, device=device) * (
                1.1 * env.params.tether_length / k ** 0.5)
    cfg = ppo.PpoConfig(num_envs=batch, rollout_len=16)
    layout = networks.Layout(d, a, cfg.hidden)
    params = ppo.init_train_state(env, cfg, 3, device=device).params.clone()
    params[layout.slices[("log_std",)]] = -0.5
    obs_norm = ppo.ObsNorm(torch.linspace(-0.1, 0.1, d, device=device),
                           torch.linspace(0.5, 2.0, d, device=device),
                           torch.tensor(100.0, device=device))
    ret_var = 4.0 * (98.0 / 1.4) ** 2 if env_id == "MujocoQuadForce-v1" else 4.0
    ret_norm = ppo.RetNorm(torch.tensor(ret_var, device=device), torch.tensor(100.0, device=device))
    consts = ppo._rollout_consts(params, layout, obs_norm, ret_norm, cfg.gamma)
    rets = torch.linspace(-1.0, 1.0, batch, device=device)
    kw = dict(params_vec=pr.env_params_vec(env), env_kind=env_id, compute_dtype=BF16)
    return env, (s.contiguous(), rets, 21, params, consts), kw


def _off_sphere(env, s_t):
    """The envs of ``(D, B)`` states farther than KNIFE from the tether
    sphere (every env of a kind without a tether)."""
    k = TETHER.get(env.name)
    if k is None:
        return torch.ones(s_t.shape[1], dtype=torch.bool, device=s_t.device)
    d = s_t.shape[0]
    return ((s_t[d - 2 * k:d - k] - s_t[0:k]).norm(dim=0) - env.params.tether_length).abs() > KNIFE


@pytest.mark.parametrize("env_id", K2_KINDS)
def test_k2_bf16_resynchronised_against_twin_and_repeats_bitwise(cuda, env_id):
    """K2/K6's bf16 instance (products on the tensor cores) against its
    bf16 twin, as phase 34 holds it: one step at a time from the twin's
    state, each step within rtol 2e-4 / atol 2e-5 on every env (the
    slung-load kinds, off the tether sphere) or on all but 0.1% of them
    (the others, over the horizon), the moment sums within 1e-3; one launch
    counted, bitwise on a rerun and the probe's outputs bitwise its own,
    with no bf16 h apart from the twin's unless recomputed (no miss); a
    batch that does not divide the 128-env CTA; the free-running horizon's
    envs apart reported, not gated."""
    batch, horizon = 4096 + 37, 16
    env, args, kw = _k2_bf16_inputs(cuda, env_id, batch)
    before = pr.ppo_rollout.launches
    k = pr.ppo_rollout(*args, horizon, **kw)
    torch.cuda.synchronize()
    assert pr.ppo_rollout.launches == before + 1
    again = pr.ppo_rollout(*args, horizon, **kw)
    assert all(torch.equal(x, y) for x, y in zip(k, again))
    probed, counts = pr.ppo_rollout_bf16_probe(*args, horizon, kw["params_vec"], env_id)
    assert all(torch.equal(x, y) for x, y in zip(k, probed))
    x, r, outside, knife = args[0], args[1], 0, 0
    for t in range(horizon):
        ks = pr.ppo_rollout(x, r, 21 + t, args[3], args[4], 1, **kw)
        ps = pr.ppo_rollout_reference(x, r, 21 + t, args[3], args[4], 1, **kw)
        safe = _off_sphere(env, x)
        outside += int((_mismatched(ks, ps) & safe).sum())
        knife += int((~safe).sum())
        rel = (ks.stats - ps.stats).abs() / ps.stats.abs().clamp_min(1.0)
        assert float(rel.max()) <= 1e-3, (t, float(rel.max()))
        x, r = ps.final_states, ps.returns
    free = _mismatched_envs(k, pr.ppo_rollout_reference(*args, horizon, **kw))
    limit = 0 if env_id in TETHER else int(0.001 * batch)
    print(f"K2/K6 bf16 {env_id}: resynchronised over {horizon} steps, {outside} env-steps "
          f"outside (limit {limit}), {knife} near the tether sphere skipped; free-running "
          f"{free} of {batch} envs apart (reported); probe {counts}")
    assert outside <= limit, outside
    assert counts["h1_missed"] == counts["h2_missed"] == 0, counts


def _loss_batch(device, n, seed, d=10, adim=4, hidden=64):
    rng = np.random.default_rng(seed)
    layout = networks.Layout(d, adim, (hidden, hidden))
    net = networks.init_params(layout, torch.Generator().manual_seed(seed))
    net[layout.slices[("log_std",)]] = torch.tensor([-0.5, 0.0, 0.3, -1.0, -0.2, 0.1, -0.7,
                                                     0.2])[:adim]
    data = np.concatenate([rng.normal(size=(d, n)), rng.normal(size=(adim, n)),
                           rng.normal(-1.0 * adim, 1.0, size=(1, n)), rng.normal(size=(1, n)),
                           rng.normal(size=(1, n)), rng.normal(size=(1, n))]).astype(np.float32)
    return (torch.tensor(data, device=device), net.to(device),
            torch.tensor(rng.permutation(n // 128)[: n // 512], dtype=torch.int32, device=device))


def _check_k3(cuda, kl_mode, d=10, adim=4, compute_dtype=None):
    """K3 against its twin of the same dtype on a 16,384-sample minibatch,
    one launch counted; bitwise on a rerun."""
    data, net, perm = _loss_batch(cuda, 65536, 3, d, adim)
    adv_stats = torch.tensor([0.1, 0.9, 0.5, 0.0], device=cuda)
    cfg = dict(d=d, adim=adim, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, tile=128,
               kl_mode=kl_mode, compute_dtype=compute_dtype)
    before = pl.ppo_loss_grads_gather.launches
    g_k, m_k = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.01, **cfg)
    torch.cuda.synchronize()
    assert pl.ppo_loss_grads_gather.launches == before + 1
    sums = pl.ppo_loss_grads_reference(data, adv_stats, perm, net, **cfg)
    g_p, m_p = pl._finish(sums, perm.shape[0] * 128, 0.01, networks.Layout(d, adim))
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(), **GRAD_TOL)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(m_k[name]), float(m_p[name]), **METRIC_TOL,
                                   err_msg=name)
    g_k2, m_k2 = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.01, **cfg)
    assert torch.equal(g_k, g_k2)
    assert all(torch.equal(m_k[k], m_k2[k]) for k in pl.METRICS)


@pytest.mark.parametrize("kl_mode", [False, True], ids=["clip", "kl"])
def test_k3_matches_twin_and_repeats_bitwise(cuda, kl_mode):
    _check_k3(cuda, kl_mode)


@pytest.mark.parametrize("kl_mode", [False, True], ids=["clip", "kl"])
@pytest.mark.parametrize("d,adim", DIMS)
def test_k3_bf16_matches_twin_and_repeats_bitwise(cuda, d, adim, kl_mode):
    _check_k3(cuda, kl_mode, d, adim, BF16)


def _check_k3_sub_blocks(cuda, d=10, adim=4, compute_dtype=None):
    """A minibatch of 201 sub-blocks of 128 samples (more than one per CTA
    on some CTAs of the grid, one on the others), in both modes, against the
    twin at the same tolerances; bitwise on a rerun."""
    data, net, _ = _loss_batch(cuda, 128 * 300, 5, d, adim)
    perm = torch.tensor(np.random.default_rng(5).permutation(300)[:201], dtype=torch.int32,
                        device=cuda)
    for kl_mode in (False, True):
        adv_stats = torch.tensor([0.1, 0.9, 0.5, 0.0], device=cuda)
        cfg = dict(d=d, adim=adim, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, tile=128,
                   kl_mode=kl_mode, compute_dtype=compute_dtype)
        g_k, m_k = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.01, **cfg)
        sums = pl.ppo_loss_grads_reference(data, adv_stats, perm, net, **cfg)
        g_p, m_p = pl._finish(sums, 201 * 128, 0.01, networks.Layout(d, adim))
        np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(), **GRAD_TOL)
        for name in pl.METRICS:
            np.testing.assert_allclose(float(m_k[name]), float(m_p[name]), **METRIC_TOL,
                                       err_msg=name)
        g_k2, _ = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.01, **cfg)
        assert torch.equal(g_k, g_k2)


def test_k3_sub_blocks_not_dividing_the_grid(cuda):
    _check_k3_sub_blocks(cuda)


@pytest.mark.parametrize("d,adim", DIMS)
def test_k3_bf16_sub_blocks_not_dividing_the_grid(cuda, d, adim):
    _check_k3_sub_blocks(cuda, d, adim, BF16)


def _check_k3_ragged(cuda, d=10, adim=4, compute_dtype=None):
    """A minibatch that is not a multiple of the kernel's sub-block, against
    the twin on the CPU."""
    data, net, _ = _loss_batch(cuda, 4096, 4, d, adim)
    perm = torch.tensor([5, 0, 31, 7, 12], dtype=torch.int32, device=cuda)
    adv_stats = torch.tensor([0.0, 1.0, 0.0, 0.0], device=cuda)
    cfg = dict(d=d, adim=adim, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, tile=32,
               compute_dtype=compute_dtype)
    g_k, m_k = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.0, **cfg)
    g_p, m_p = pl.ppo_loss_grads_gather(data.cpu(), adv_stats.cpu(), perm.cpu(), net.cpu(),
                                        ent_coef=0.0, **cfg)
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.numpy(), **GRAD_TOL)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(m_k[name]), float(m_p[name]), **METRIC_TOL)


def test_k3_ragged_minibatch(cuda):
    _check_k3_ragged(cuda)


@pytest.mark.parametrize("d,adim", DIMS)
def test_k3_bf16_ragged_minibatch(cuda, d, adim):
    _check_k3_ragged(cuda, d, adim, BF16)


def test_train_step_launches_both_kernels(cuda, caplog):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=2048, rollout_len=16, fused_update="off")
    state = ppo.init_train_state(env, cfg, 0, device=cuda)
    k2, k3, k4 = pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches, pu.ppo_update.launches
    with caplog.at_level("INFO", logger="reinmav_tpu_torch.rl.ppo"):
        state, summary = ppo.train_step(env, cfg, state)
    torch.cuda.synchronize()
    assert pr.ppo_rollout.launches == k2 + 1
    assert pl.ppo_loss_grads_gather.launches == k3 + cfg.num_epochs * cfg.num_minibatches
    assert pu.ppo_update.launches == k4
    assert "K2 CUDA kernel" in caplog.text and "K3 CUDA kernel" in caplog.text
    assert all(bool(torch.isfinite(v)) for v in summary.values()), summary
    assert state.params.device.type == "cuda" and state.update_step == 1
    # fused_update="on" on the card launches K4 (it no longer raises).
    state, summary = ppo.train_step(env, cfg._replace(fused_update="on"), state)
    torch.cuda.synchronize()
    assert pu.ppo_update.launches == k4 + 1
    assert all(bool(torch.isfinite(v)) for v in summary.values()), summary


def test_train_step_default_launches_k4_once_and_k3_never(cuda, caplog):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=2048, rollout_len=16)  # fused_update="auto"
    state = ppo.init_train_state(env, cfg, 0, device=cuda)
    k2, k3, k4 = pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches, pu.ppo_update.launches
    with caplog.at_level("INFO", logger="reinmav_tpu_torch.rl.ppo"):
        for _ in range(2):
            state, summary = ppo.train_step(env, cfg, state)
    torch.cuda.synchronize()
    assert (pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches,
            pu.ppo_update.launches) == (k2 + 2, k3, k4 + 2)
    assert "K4 CUDA kernel, 1 launch" in caplog.text
    assert int(state.opt_state.count) == 2 * cfg.num_epochs * cfg.num_minibatches
    assert all(bool(torch.isfinite(v)) for v in summary.values()), summary


def _leaves(tree):
    """Every tensor and scalar of a state tree, a generator as its state."""
    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if isinstance(tree, tuple):
        return [leaf for field in tree for leaf in _leaves(field)]
    return [tree]


def test_bitwise_resume_on_the_card(cuda, tmp_path):
    """4 updates of the default path (K2 + K4) uninterrupted, against 2, a
    checkpoint, a restore into a state of another seed, and 2 more."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=2048, rollout_len=16)
    ref = ppo.init_train_state(env, cfg, 5, device=cuda)
    for _ in range(4):
        ref, _ = ppo.train_step(env, cfg, ref)
    state = ppo.init_train_state(env, cfg, 5, device=cuda)
    for _ in range(2):
        state, _ = ppo.train_step(env, cfg, state)
    ckpt.save(str(tmp_path / "mid"), state)
    del state
    restored = ckpt.restore(str(tmp_path / "mid"), ppo.init_train_state(env, cfg, 99, device=cuda))
    assert restored.params.device.type == "cuda" and restored.opt_state.count.device.type == "cuda"
    before = pu.ppo_update.launches
    for _ in range(2):
        restored, _ = ppo.train_step(env, cfg, restored)
    assert pu.ppo_update.launches == before + 2
    assert restored.update_step == ref.update_step == 4
    assert int(restored.opt_state.count) == 4 * cfg.num_epochs * cfg.num_minibatches
    for a, b in zip(_leaves(ref), _leaves(restored), strict=True):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        else:
            assert a == b


def _update_inputs(device, kl_mode=False, floor=None, ent_coef=0.0, value_clip_eps=0.2, lr=3e-4,
                   num_envs=4096, env_id="quadrotor3d-v0"):
    """One K2/K6 rollout of ``num_envs`` envs x 16 steps of ``env_id``,
    stacked as K4 takes it, with 4 epochs x 4 minibatches of tiles of 128,
    and the kernel's keywords."""
    env = reinmav_tpu_torch.make(env_id)
    d, adim = env.obs_dim, env.action_dim
    cfg = ppo.PpoConfig(num_envs=num_envs, rollout_len=16)
    state = ppo.init_train_state(env, cfg, 7, device=device)
    ro_ = ppo.collect_rollout_kernel(env, cfg, state.params, state.obs_norm, state.ret_norm,
                                     state.env_states, state.env_returns, 13)
    layout = networks.Layout(d, adim)
    n = num_envs * 16
    with torch.no_grad():
        _, _, last_value = networks.apply_t(layout.unflatten(state.params),
                                            ppo._normalize_t(ro_.final_states.T, state.obs_norm))
        adv, ret = ppo.compute_gae(cfg, ro_.traj, last_value)
    flat = lambda x: x.permute(1, 0, 2).reshape(x.shape[1], n)  # noqa: E731
    data = pl.stack_batch(flat(ro_.traj.obs), flat(ro_.traj.action), ro_.traj.log_prob.reshape(n),
                          ro_.traj.value.reshape(n), adv.reshape(n), ret.reshape(n))
    tile, n_tiles = ppo._tiling(cfg, n)
    gen = torch.Generator().manual_seed(2)
    perm_all = torch.cat([ppo._shuffle_indices(gen, n_tiles) for _ in range(4)]).to(
        device=device, dtype=torch.int32)
    adv_stats = ppo.pass_adv_stats(adv.reshape(n), perm_all, tile, 16, True)
    kw = dict(d=d, adim=adim, tile=tile, n_minibatches=4, n_epochs=4, clip_eps=0.2,
              value_clip_eps=value_clip_eps, value_coef=0.5, ent_coef=ent_coef, lr=lr,
              max_grad_norm=0.5, log_std_floor=floor, kl_mode=kl_mode)
    beta = torch.tensor(0.7, device=device) if kl_mode else None
    return data, adv_stats, perm_all, state.params, state.opt_state, beta, kw


@pytest.mark.parametrize("mode", ["clip", "kl", "floor-entropy", "value-clip-lr1e-3",
                                  "no-value-clip-lr1e-3"])
def test_k4_matches_twin_k3_and_repeats_bitwise(cuda, mode):
    extra = {"clip": {}, "kl": {"kl_mode": True},
             "floor-entropy": {"floor": -0.05, "ent_coef": 0.01},
             "value-clip-lr1e-3": {"lr": 1e-3},
             "no-value-clip-lr1e-3": {"lr": 1e-3, "value_clip_eps": 1e9}}[mode]
    _check_k4(cuda, mode, **extra)


def test_k4_sub_blocks_not_dividing_the_grid(cuda):
    """6432 envs x 16 steps: minibatches of 201 sub-blocks of 128 samples,
    more than one per CTA on some CTAs of the grid (one CTA per SM, at most
    132 on an H100) and one on the others; the same checks as the clip mode
    at the same tolerances."""
    _check_k4(cuda, "clip", num_envs=6432)


def _check_k4(cuda, mode, **extra):
    """K4 against its twin at the JAX tolerances (the flipped ones after a
    value-clip flip), pass 0 bitwise one K3 launch, a bitwise rerun."""
    data, stats, perm_all, params, opt, beta, kw = _update_inputs(cuda, **extra)
    before = pu.ppo_update.launches
    k = pu.ppo_update(data, stats, perm_all, params, opt, beta, keep_grad0=True, **kw)
    torch.cuda.synchronize()
    assert pu.ppo_update.launches == before + 1
    p_params, p_opt, p_sums, p_grad0 = pu.ppo_update_reference(data, stats, perm_all, params, opt,
                                                               beta, **kw)
    leaves = (("params", k.params, p_params, PARAM_TOL, FLIPPED_PARAM_TOL),
              ("mu", k.opt_state.mu, p_opt.mu, MOMENT_TOL, FLIPPED_MOMENT_TOL),
              ("nu", k.opt_state.nu, p_opt.nu, MOMENT_TOL, MOMENT_TOL))
    outside = {name: ~torch.isclose(a, b, **tol) for name, a, b, tol, _ in leaves}
    print(f"K4 vs twin, {mode}: of {k.params.numel()} entries outside the JAX tolerances "
          f"{ {name: int(m.sum()) for name, m in outside.items()} }; max |err| "
          + ", ".join(f"{name} {float((a - b).abs().max()):.3e}" for name, a, b, _, _ in leaves))
    if mode == "value-clip-lr1e-3":
        # A value-clip flip: the entries that leave the tolerance are few,
        # and most of them are the critic's.
        critic = torch.zeros_like(outside["params"])
        for key, sl in networks.Layout(10, 4).slices.items():
            critic[sl] = key[0].startswith("vf")
        n_out, n_critic = int(outside["params"].sum()), int((outside["params"] & critic).sum())
        print(f"K4 vs twin, {mode}: {n_critic} of the {n_out} params outside are the critic's")
        assert 0 < n_out <= MAX_FLIPPED_OUTSIDE * k.params.numel(), n_out
        assert n_critic >= 0.9 * n_out, (n_critic, n_out)
    for name, a, b, tol, flipped in leaves:
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   **(flipped if mode == "value-clip-lr1e-3" else tol), err_msg=name)
    assert int(k.opt_state.count) == int(p_opt.count) == int(opt.count) + 16
    means = pu._metric_means(p_sums, 16, 4, perm_all.numel() // 16 * kw["tile"], kw["kl_mode"])
    for name, v in means.items():
        np.testing.assert_allclose(float(k.metrics[name]), float(v), **UPDATE_METRIC_TOL,
                                   err_msg=name)
    # Pass 0's gradient, bitwise one K3 launch on the same minibatch.
    tpm = perm_all.numel() // 16
    k3_stats = torch.stack([stats[0, 0], stats[0, 1], beta if beta is not None else stats[0, 0] * 0,
                            stats[0, 0] * 0]).contiguous()
    g3, _ = pl.ppo_loss_grads_gather(data, k3_stats, perm_all[:tpm].contiguous(), params,
                                     d=10, adim=4, clip_eps=0.2,
                                     value_clip_eps=kw["value_clip_eps"], value_coef=0.5,
                                     ent_coef=kw["ent_coef"], tile=kw["tile"],
                                     kl_mode=kw["kl_mode"])
    assert torch.equal(k.grad0, g3)
    np.testing.assert_allclose(k.grad0.cpu().numpy(), p_grad0.cpu().numpy(), **GRAD_TOL)
    again = pu.ppo_update(data, stats, perm_all, params, opt, beta, **kw)
    assert torch.equal(k.params, again.params)
    assert all(torch.equal(a, b) for a, b in zip(k.opt_state, again.opt_state))
    assert all(torch.equal(k.metrics[n], again.metrics[n]) for n in k.metrics)


def _twin_edges(batch, net, d, adim, clip_eps, value_clip_eps, hidden=64, bf16=True):
    """The samples of ``batch`` within RESYNC_ULPS ulps of the ratio clip
    (1 +- clip_eps) or of the value clip (|value - old value| =
    value_clip_eps, or the two squared errors equal outside it), on the
    twin's forward of the dtype (ops/ppo_loss.py's rounding), bf16 by
    default."""
    r = networks.bf16_round if bf16 else (lambda t: t)  # noqa: E731
    p = networks.Layout(d, adim, (hidden, hidden)).unflatten(net)
    acts = {}
    for tower in ("pi", "vf"):
        h = batch[:d]
        for layer in p[tower]:
            h = torch.tanh(r(layer["w"].T) @ r(h) + layer["b"][:, None])
        acts[tower] = h
    mean = r(p["pi_out"]["w"].T) @ r(acts["pi"]) + p["pi_out"]["b"][:, None]
    value = pl.value_head(r(acts["vf"]), r(p["vf_out"]["w"][:, 0]), p["vf_out"]["b"][0])
    ls = p["log_std"]
    ratio = pl.logp_ratio(batch[d:d + adim] - mean, torch.exp(2.0 * ls)[:, None], ls,
                          batch[d + adim])[2].double()
    f32 = torch.finfo(torch.float32).eps
    eps = torch.tensor(clip_eps, dtype=torch.float32)
    ulp = torch.where(ratio < 1.0, 2.0 ** -24, 2.0 ** -23)
    near = torch.minimum((ratio - float(1.0 - eps)).abs(),
                         (ratio - float(1.0 + eps)).abs()) <= RESYNC_ULPS * ulp
    veps = float(torch.tensor(value_clip_eps, dtype=torch.float32))
    old_value, ret = batch[d + adim + 1], batch[d + adim + 3]
    vdiff = value - old_value
    sq1 = (value - ret) ** 2
    sq2 = (old_value + torch.clamp(vdiff, -veps, veps) - ret) ** 2
    vclip = (vdiff.abs().double() - veps).abs() <= RESYNC_ULPS * f32 * veps
    vtie = (vdiff.abs() >= veps) & ((sq1.double() - sq2.double()).abs() <= RESYNC_ULPS * f32 *
                                    torch.maximum(sq1, sq2).double().clamp_min(1e-30))
    return near | vclip | vtie


def _check_k4_bf16(cuda, env_id, kl_mode=False, num_envs=4096):
    """K4's bf16 instance: one launch counted, bitwise on a rerun, pass 0
    bitwise one K3 bf16 launch, and resynchronised against the bf16 twin
    (the module docstring)."""
    data, stats, perm_all, params, opt, beta, kw = _update_inputs(
        cuda, kl_mode=kl_mode, num_envs=num_envs, env_id=env_id)
    d, adim, tile = kw["d"], kw["adim"], kw["tile"]
    before = pu.ppo_update.launches
    k = pu.ppo_update(data, stats, perm_all, params, opt, beta, keep_grad0=True,
                      compute_dtype=BF16, **kw)
    torch.cuda.synchronize()
    assert pu.ppo_update.launches == before + 1
    assert int(k.opt_state.count) == int(opt.count) + 16 and bool(torch.isfinite(k.params).all())
    again = pu.ppo_update(data, stats, perm_all, params, opt, beta, keep_grad0=True,
                          compute_dtype=BF16, **kw)
    assert torch.equal(k.params, again.params) and torch.equal(k.grad0, again.grad0)
    assert all(torch.equal(a, b) for a, b in zip(k.opt_state, again.opt_state))
    assert all(torch.equal(k.metrics[n], again.metrics[n]) for n in k.metrics)
    tpm = perm_all.numel() // 16
    k3_stats = torch.stack([stats[0, 0], stats[0, 1], beta if beta is not None else stats[0, 0] * 0,
                            stats[0, 0] * 0]).contiguous()
    g3, _ = pl.ppo_loss_grads_gather(data, k3_stats, perm_all[:tpm].contiguous(), params, d=d,
                                     adim=adim, clip_eps=0.2, value_clip_eps=kw["value_clip_eps"],
                                     value_coef=0.5, ent_coef=kw["ent_coef"], tile=tile,
                                     kl_mode=kl_mode, compute_dtype=BF16)
    assert torch.equal(k.grad0, g3)
    # Resynchronised: each pass from the twin's state, the edge samples replaced.
    one = {**kw, "n_epochs": 1, "n_minibatches": 1}
    ident = torch.arange(tpm, dtype=torch.int32, device=cuda)
    net, state, replaced = params, opt, 0
    for q in range(16):
        perm = perm_all[q * tpm:(q + 1) * tpm].contiguous()
        batch = data[:, pl._gather_columns(perm, tile)].contiguous()
        edge = _twin_edges(batch, net, d, adim, 0.2, kw["value_clip_eps"])
        if bool(edge.any()):
            keep = int((~edge).nonzero()[0, 0])
            batch[:, edge] = batch[:, keep:keep + 1]
            replaced += int(edge.sum())
        st = stats[q:q + 1].contiguous()
        kq = pu.ppo_update(batch, st, ident, net, state, beta, keep_grad0=True,
                           compute_dtype=BF16, **one)
        t_params, t_state, _, t_grad = pu.ppo_update_reference(batch, st, ident, net, state, beta,
                                                               compute_dtype=BF16, **one)
        for name, a, b, tol in (("grad", kq.grad0, t_grad, GRAD_TOL),
                                ("params", kq.params, t_params, PARAM_TOL),
                                ("mu", kq.opt_state.mu, t_state.mu, MOMENT_TOL),
                                ("nu", kq.opt_state.nu, t_state.nu, MOMENT_TOL)):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol,
                                       err_msg=f"pass {q} {name}")
        assert int(kq.opt_state.count) == int(t_state.count)
        net, state, _, _ = pu.ppo_update_reference(data, st, perm, net, state, beta,
                                                   compute_dtype=BF16, **one)
    print(f"K4 bf16 {env_id} ({'kl' if kl_mode else 'clip'}): resynchronised over 16 passes, "
          f"{replaced} edge samples replaced")


@pytest.mark.parametrize("kl_mode", [False, True], ids=["clip", "kl"])
@pytest.mark.parametrize("d,adim", DIMS)
def test_k4_bf16_resynchronised_against_twin_and_repeats_bitwise(cuda, d, adim, kl_mode):
    _check_k4_bf16(cuda, DIMS_ENV[(d, adim)], kl_mode)


@pytest.mark.parametrize("d,adim", DIMS)
def test_k4_bf16_sub_blocks_not_dividing_the_grid(cuda, d, adim):
    """As test_k4_sub_blocks_not_dividing_the_grid, for the bf16 instance
    (its sub-blocks are 64 samples: 402 a minibatch)."""
    _check_k4_bf16(cuda, DIMS_ENV[(d, adim)], num_envs=6432)


@pytest.mark.parametrize("mode", ["clip", "floor-entropy"])
def test_k4_update_phase_matches_the_k3_loop(cuda, mode):
    """One update phase on the card: every pass in K4, and the loop of 16
    K3 launches + ClipAdam, from the same rollout and permutations."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    extra = {"clip": {}, "floor-entropy": {"log_std_floor": -0.05, "entropy_coef": 0.01}}[mode]
    cfg = ppo.PpoConfig(num_envs=4096, rollout_len=16, **extra)
    state = ppo.init_train_state(env, cfg, 0, device=cuda)
    rollout = ppo.collect_rollout_kernel(env, cfg, state.params, state.obs_norm, state.ret_norm,
                                         state.env_states, state.env_returns, 11)
    _, n_tiles = ppo._tiling(cfg, 4096 * 16)
    gen = torch.Generator().manual_seed(0)
    perms = [ppo._shuffle_indices(gen, n_tiles, cuda) for _ in range(cfg.num_epochs)]
    k4, m4 = ppo.update_phase(env, cfg, state, rollout, perms, False, True)
    k3, m3 = ppo.update_phase(env, cfg, state, rollout, perms, True, False)
    np.testing.assert_allclose(k4.params.cpu().numpy(), k3.params.cpu().numpy(), **PARAM_TOL)
    for got, ref in zip(k4.opt_state[1:], k3.opt_state[1:]):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **MOMENT_TOL)
    for name in m3:
        np.testing.assert_allclose(float(m4[name]), float(m3[name]), **UPDATE_METRIC_TOL,
                                   err_msg=name)


def test_update_phase_kernel_matches_twin(cuda):
    """One update phase on the same K2 rollout, its 16 minibatch gradients
    through K3 on the card and through K3's twin on the CPU.  Params after
    16 Adam steps at rtol 1e-4 / atol 1e-5: Adam divides each gradient
    entry by its own running RMS, so an entry near zero carries the
    kernel's different summation order into a step of up to lr."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=2048, rollout_len=16)
    state = ppo.init_train_state(env, cfg, 0, device=cuda)
    rollout = ppo.collect_rollout_kernel(env, cfg, state.params, state.obs_norm, state.ret_norm,
                                         state.env_states, state.env_returns, 11)
    _, n_tiles = ppo._tiling(cfg, 2048 * 16)
    gen = torch.Generator().manual_seed(0)
    perms = [ppo._shuffle_indices(gen, n_tiles) for _ in range(cfg.num_epochs)]
    on_card, s_k = ppo.update_phase(env, cfg, state, rollout, [p.to(cuda) for p in perms], True)
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731
    state_cpu = ppo.TrainState(*(
        type(f)(*map(cpu, f)) if isinstance(f, tuple) else cpu(f) for f in state))
    rollout_cpu = ppo.Rollout(*(
        type(f)(*map(cpu, f)) if isinstance(f, tuple) else cpu(f) for f in rollout))
    on_cpu, s_p = ppo.update_phase(env, cfg, state_cpu, rollout_cpu, perms, True)
    np.testing.assert_allclose(on_card.params.cpu().numpy(), on_cpu.params.numpy(),
                               rtol=1e-4, atol=1e-5)
    for name in ("pg_loss", "v_loss", "approx_kl"):
        np.testing.assert_allclose(float(s_k[name]), float(s_p[name]), rtol=1e-3, atol=1e-5,
                                   err_msg=name)


# The wide instances of K3 and K4 (ppo_loss_wide.cu, ppo_update_wide.cu).
WIDE = [pytest.param(h, id=f"h{h}") for h in (16, 100, 128, 256)]
DTYPES = [pytest.param(None, id="f32"), pytest.param(BF16, id="bf16")]


def _replace_edges(batch, net, d, adim, hidden, compute_dtype, value_clip_eps=0.2):
    """``batch`` with its samples on a knife edge of the twin's forward
    (:func:`_twin_edges`) replaced by a copy of its first sample that is
    not; the count replaced."""
    edge = _twin_edges(batch, net, d, adim, 0.2, value_clip_eps, hidden, compute_dtype == BF16)
    n = int(edge.sum())
    if n:
        keep = int((~edge).nonzero()[0, 0])
        batch[:, edge] = batch[:, keep:keep + 1]
    return n


def _check_k3_wide(cuda, hidden, compute_dtype, kl_mode, n=65536, n_tiles=128, tile=128, d=10,
                   adim=4):
    """K3 wide against its twin of the same dtype on the gathered minibatch
    of ``n_tiles`` tiles, its knife-edge samples replaced; one launch
    counted, the 64-wide kernel's count unchanged; bitwise on a rerun.  In
    bf16, the h's recomputed in the twin's order (near a bf16 midpoint)
    are counted on a launch of their own and reported."""
    data, net, _ = _loss_batch(cuda, n, 3, d, adim, hidden)
    perm = torch.tensor(np.random.default_rng(7).permutation(n // tile)[:n_tiles],
                        dtype=torch.int32, device=cuda)
    batch = data[:, pl._gather_columns(perm, tile)].contiguous()
    replaced = _replace_edges(batch, net, d, adim, hidden, compute_dtype)
    ident = torch.arange(n_tiles, dtype=torch.int32, device=cuda)
    adv_stats = torch.tensor([0.1, 0.9, 0.5, 0.0], device=cuda)
    cfg = dict(d=d, adim=adim, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, tile=tile,
               kl_mode=kl_mode, hidden=hidden, compute_dtype=compute_dtype)
    before, narrow = pl._launch_wide.launches, pl.ppo_loss_grads_gather.launches
    g_k, m_k = pl.ppo_loss_grads_gather(batch, adv_stats, ident, net, ent_coef=0.01, **cfg)
    torch.cuda.synchronize()
    assert pl._launch_wide.launches == before + 1
    assert pl.ppo_loss_grads_gather.launches == narrow
    sums = pl.ppo_loss_grads_reference(batch, adv_stats, ident, net, **cfg)
    g_p, m_p = pl._finish(sums, n_tiles * tile, 0.01, networks.Layout(d, adim, (hidden, hidden)))
    recomputed = ""
    if compute_dtype == BF16:
        counts = torch.zeros(2, dtype=torch.int64, device=cuda)
        sums_c = pl._launch_wide(batch, adv_stats, ident, net,
                                 networks.Layout(d, adim, (hidden, hidden)), rec_counts=counts,
                                 **cfg)  # counted apart from the launch above
        torch.cuda.synchronize()
        layout = networks.Layout(d, adim, (hidden, hidden))
        assert torch.equal(pl._finish(sums_c, n_tiles * tile, 0.01, layout)[0], g_k)
        h1, h2 = counts.tolist()
        units = n_tiles * tile * hidden * 2  # a layer's h's, both towers
        assert 0 <= h1 <= units // 10 and 0 <= h2 <= units // 10, (h1, h2, units)
        recomputed = (f", h's recomputed in the twin's order: h1 {h1}, h2 {h2} of {units} a "
                      f"layer")
    print(f"K3 wide H={hidden} ({d}, {adim}) {compute_dtype or 'float32'} "
          f"{'kl' if kl_mode else 'clip'}: {replaced} edge samples replaced, grads max |err| "
          f"{float((g_k - g_p).abs().max()):.3e}{recomputed}")
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(), **GRAD_TOL)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(m_k[name]), float(m_p[name]), **METRIC_TOL,
                                   err_msg=name)
    g_k2, m_k2 = pl.ppo_loss_grads_gather(batch, adv_stats, ident, net, ent_coef=0.01, **cfg)
    assert torch.equal(g_k, g_k2)
    assert all(torch.equal(m_k[k], m_k2[k]) for k in pl.METRICS)


@pytest.mark.parametrize("kl_mode", [False, True], ids=["clip", "kl"])
@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("hidden", WIDE)
def test_k3_wide_matches_twin_and_repeats_bitwise(cuda, hidden, compute_dtype, kl_mode):
    _check_k3_wide(cuda, hidden, compute_dtype, kl_mode)


@pytest.mark.parametrize("kl_mode", [False, True], ids=["clip", "kl"])
@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("hidden", WIDE)
def test_k3_wide_at_the_largest_dims(cuda, hidden, compute_dtype, kl_mode):
    """Obs dim 32 and action dim 8, the largest the wide instances take
    (two obs row blocks of 16 in dW1, the widest heads)."""
    _check_k3_wide(cuda, hidden, compute_dtype, kl_mode, d=32, adim=8)


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("hidden", [pytest.param(100, id="h100"), pytest.param(256, id="h256")])
def test_k3_wide_sub_blocks_not_dividing_the_grid(cuda, hidden, compute_dtype):
    """A minibatch of 201 tiles of 128 (402 sub-blocks of 64 samples a
    tower over 66 CTAs a tower on 132 SMs, not a multiple of them) and a
    ragged one (5 tiles of 32: 160 samples, the last sub-block partly
    empty), at the obs dim of the slung 3D env and A = 4."""
    _check_k3_wide(cuda, hidden, compute_dtype, False, n=128 * 300, n_tiles=201, d=16)
    _check_k3_wide(cuda, hidden, compute_dtype, False, n=4096, n_tiles=5, tile=32, d=16)


def _wide_update_inputs(device, hidden, kl_mode=False, num_envs=4096, compute_dtype=None):
    """One eager rollout of ``num_envs`` quadrotor3d envs x 16 steps with
    a net of two layers of width ``hidden``, stacked as K4 takes it, 4
    epochs x 4 minibatches of tiles of 128, and the kernel's keywords."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=num_envs, rollout_len=16, hidden=(hidden, hidden),
                        compute_dtype=compute_dtype or "float32")
    state = ppo.init_train_state(env, cfg, 7, device=device)
    ro_ = ppo.collect_rollout(env, cfg, state.params, state.obs_norm, state.ret_norm,
                              state.env_states, state.env_returns,
                              torch.Generator(device=device).manual_seed(13))
    layout = networks.Layout(10, 4, (hidden, hidden))
    n = num_envs * 16
    with torch.no_grad():
        _, _, last_value = networks.apply_t(layout.unflatten(state.params),
                                            ppo._normalize_t(ro_.final_states.T, state.obs_norm))
        adv, ret = ppo.compute_gae(cfg, ro_.traj, last_value)
    flat = lambda x: x.permute(1, 0, 2).reshape(x.shape[1], n)  # noqa: E731
    data = pl.stack_batch(flat(ro_.traj.obs), flat(ro_.traj.action), ro_.traj.log_prob.reshape(n),
                          ro_.traj.value.reshape(n), adv.reshape(n), ret.reshape(n))
    tile, n_tiles = ppo._tiling(cfg, n)
    gen = torch.Generator().manual_seed(2)
    perm_all = torch.cat([ppo._shuffle_indices(gen, n_tiles) for _ in range(4)]).to(
        device=device, dtype=torch.int32)
    adv_stats = ppo.pass_adv_stats(adv.reshape(n), perm_all, tile, 16, True)
    # The params perturbed, so that the ratios leave 1 and some samples clip.
    params = state.params + 0.02 * torch.randn(state.params.shape, device=device,
                                               generator=torch.Generator(device=device).manual_seed(8))
    kw = dict(d=10, adim=4, tile=tile, n_minibatches=4, n_epochs=4, clip_eps=0.2,
              value_clip_eps=0.2, value_coef=0.5, ent_coef=0.01, lr=3e-4, max_grad_norm=0.5,
              kl_mode=kl_mode, hidden=hidden)
    beta = torch.tensor(0.7, device=device) if kl_mode else None
    return data, adv_stats, perm_all, params.contiguous(), state.opt_state, beta, kw


def _synthetic_update_inputs(device, hidden, d, adim, n=65536, kl_mode=False):
    """:func:`_loss_batch`'s batch at obs and action dims (d, adim) stacked as
    K4 takes it, 4 epochs x 4 minibatches of tiles of 128 (seed 2), fresh
    Adam moments and the kernel's keywords."""
    data, net, _ = _loss_batch(device, n, 5, d, adim, hidden)
    gen = torch.Generator().manual_seed(2)
    perm_all = torch.cat([ppo._shuffle_indices(gen, n // 128) for _ in range(4)]).to(
        device=device, dtype=torch.int32)
    adv_stats = ppo.pass_adv_stats(data[d + adim + 2], perm_all, 128, 16, True)
    opt = ppo.AdamState(torch.zeros((), dtype=torch.int32, device=device),
                        torch.zeros_like(net), torch.zeros_like(net))
    kw = dict(d=d, adim=adim, tile=128, n_minibatches=4, n_epochs=4, clip_eps=0.2,
              value_clip_eps=0.2, value_coef=0.5, ent_coef=0.01, lr=3e-4, max_grad_norm=0.5,
              kl_mode=kl_mode, hidden=hidden)
    beta = torch.tensor(0.7, device=device) if kl_mode else None
    return data, adv_stats, perm_all, net.contiguous(), opt, beta, kw


def _wide_grid_text(cuda, d, adim, hidden, mb, compute_dtype, kl_mode):
    """The grid K4 wide takes for a minibatch of mb samples: its CTAs, the
    CTAs a tower, their resident CTAs an SM (the cooperative launch needs 1)
    and the body's plan."""
    import ctypes

    from reinmav_tpu_torch import _build

    lib = _build.load_library()
    blocks = lib.ppo_loss_wide_blocks(mb)
    per_sm = ctypes.c_int()
    assert lib.ppo_update_wide_occupancy(d, adim, hidden, int(kl_mode),
                                         int(compute_dtype == BF16), ctypes.byref(per_sm)) == 0
    assert per_sm.value >= 1
    plan = pl.check_wide_plan(lib, d, adim, hidden, compute_dtype == BF16, mb, blocks)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    return (f"grid {blocks} CTAs on {sms} SMs ({blocks // 2} a tower), {per_sm.value} resident "
            f"an SM, {plan['samples']} samples a sub-block, up to {plan['groups']} a CTA, "
            f"{plan['smem_bytes']} B of shared memory")


def _check_k4_wide(cuda, hidden, compute_dtype, kl_mode=False, num_envs=4096, dims=None):
    """K4 wide: one launch counted (the 64-wide kernel's count unchanged),
    bitwise on a rerun, pass 0 bitwise one K3 wide launch, and every pass
    resynchronised against the twin of the same dtype; the grid printed.
    ``dims`` (d, adim): a synthetic batch at those dims, else the eager
    rollout of quadrotor3d-v0."""
    if dims is None:
        data, stats, perm_all, params, opt, beta, kw = _wide_update_inputs(
            cuda, hidden, kl_mode, num_envs, compute_dtype)
    else:
        data, stats, perm_all, params, opt, beta, kw = _synthetic_update_inputs(
            cuda, hidden, *dims, kl_mode=kl_mode)
    d, adim, tile = kw["d"], kw["adim"], kw["tile"]
    before, narrow = pu._launch_wide.launches, pu.ppo_update.launches
    k = pu.ppo_update(data, stats, perm_all, params, opt, beta, keep_grad0=True,
                      compute_dtype=compute_dtype, **kw)
    torch.cuda.synchronize()
    assert pu._launch_wide.launches == before + 1 and pu.ppo_update.launches == narrow
    assert int(k.opt_state.count) == int(opt.count) + 16 and bool(torch.isfinite(k.params).all())
    again = pu.ppo_update(data, stats, perm_all, params, opt, beta, keep_grad0=True,
                          compute_dtype=compute_dtype, **kw)
    assert torch.equal(k.params, again.params) and torch.equal(k.grad0, again.grad0)
    assert all(torch.equal(a, b) for a, b in zip(k.opt_state, again.opt_state))
    assert all(torch.equal(k.metrics[n], again.metrics[n]) for n in k.metrics)
    tpm = perm_all.numel() // 16
    k3_stats = torch.stack([stats[0, 0], stats[0, 1], beta if beta is not None else stats[0, 0] * 0,
                            stats[0, 0] * 0]).contiguous()
    g3, _ = pl.ppo_loss_grads_gather(data, k3_stats, perm_all[:tpm].contiguous(), params, d=d,
                                     adim=adim, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5,
                                     ent_coef=kw["ent_coef"], tile=tile, kl_mode=kl_mode,
                                     hidden=hidden, compute_dtype=compute_dtype)
    assert torch.equal(k.grad0, g3)
    one = {**kw, "n_epochs": 1, "n_minibatches": 1}
    ident = torch.arange(tpm, dtype=torch.int32, device=cuda)
    net, state, replaced = params, opt, 0
    for q in range(16):
        perm = perm_all[q * tpm:(q + 1) * tpm].contiguous()
        batch = data[:, pl._gather_columns(perm, tile)].contiguous()
        replaced += _replace_edges(batch, net, d, adim, hidden, compute_dtype)
        st = stats[q:q + 1].contiguous()
        kq = pu.ppo_update(batch, st, ident, net, state, beta, keep_grad0=True,
                           compute_dtype=compute_dtype, **one)
        t_params, t_state, _, t_grad = pu.ppo_update_reference(
            batch, st, ident, net, state, beta, compute_dtype=compute_dtype, **one)
        for name, a, b, tol in (("grad", kq.grad0, t_grad, GRAD_TOL),
                                ("params", kq.params, t_params, PARAM_TOL),
                                ("mu", kq.opt_state.mu, t_state.mu, MOMENT_TOL),
                                ("nu", kq.opt_state.nu, t_state.nu, MOMENT_TOL)):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol,
                                       err_msg=f"pass {q} {name}")
        assert int(kq.opt_state.count) == int(t_state.count)
        net, state, _, _ = pu.ppo_update_reference(data, st, perm, net, state, beta,
                                                   compute_dtype=compute_dtype, **one)
    print(f"K4 wide H={hidden} ({d}, {adim}) {compute_dtype or 'float32'} "
          f"{'kl' if kl_mode else 'clip'}: resynchronised over 16 passes, {replaced} edge samples "
          f"replaced; {_wide_grid_text(cuda, d, adim, hidden, tpm * tile, compute_dtype, kl_mode)}")


@pytest.mark.parametrize("kl_mode", [False, True], ids=["clip", "kl"])
@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("hidden", WIDE)
def test_k4_wide_resynchronised_against_twin_and_repeats_bitwise(cuda, hidden, compute_dtype,
                                                                 kl_mode):
    _check_k4_wide(cuda, hidden, compute_dtype, kl_mode)


@pytest.mark.parametrize("kl_mode", [False, True], ids=["clip", "kl"])
@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("hidden", [pytest.param(100, id="h100"), pytest.param(256, id="h256")])
def test_k4_wide_at_the_largest_dims(cuda, hidden, compute_dtype, kl_mode):
    """K4 wide at obs dim 32 and action dim 8 on a synthetic batch of
    65,536 samples."""
    _check_k4_wide(cuda, hidden, compute_dtype, kl_mode, dims=(32, 8))


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_k4_wide_sub_blocks_not_dividing_the_grid(cuda, compute_dtype):
    """6432 envs x 16 steps at H = 256: minibatches of 402 sub-blocks of 64
    samples a tower over the grid's CTAs (66 a tower on 132 SMs), not a
    multiple of them."""
    _check_k4_wide(cuda, 256, compute_dtype, num_envs=6432)


def test_train_step_wide_launches_k4_wide_once_and_k3_never(cuda, caplog):
    """The default path at hidden (128, 128): the eager rollout (K2/K6 are
    2 x 64 only, as the JAX package's), then one K4 wide launch an update;
    neither K3 nor the 64-wide K4 launches; the K3 loop at that width
    launches K3 wide once a minibatch; (512, 512) with fused_update="on"
    raises naming the width, "auto" takes autograd."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=2048, rollout_len=16, hidden=(128, 128))
    state = ppo.init_train_state(env, cfg, 0, device=cuda)
    counts = lambda: (pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches,  # noqa: E731
                      pl._launch_wide.launches, pu.ppo_update.launches,
                      pu._launch_wide.launches)
    before = counts()
    with caplog.at_level("INFO", logger="reinmav_tpu_torch.rl.ppo"):
        for _ in range(2):
            state, summary = ppo.train_step(env, cfg, state)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2], before[3], before[4] + 2)
    assert "K4 CUDA kernel (wide, H=128), 1 launch" in caplog.text
    assert int(state.opt_state.count) == 2 * cfg.num_epochs * cfg.num_minibatches
    assert all(bool(torch.isfinite(v)) for v in summary.values()), summary
    before = counts()
    with caplog.at_level("INFO", logger="reinmav_tpu_torch.rl.ppo"):
        state, summary = ppo.train_step(env, cfg._replace(fused_update="off"), state)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 16, before[3], before[4])
    assert "K3 CUDA kernel (wide, H=128), 16 launches" in caplog.text
    wide = cfg._replace(hidden=(512, 512), fused_update="on")
    big = ppo.init_train_state(env, wide, 0, device=cuda)
    with pytest.raises(ValueError, match=r"hidden \(512, 512\)"):
        ppo.train_step(env, wide, big)
    before = counts()
    big, summary = ppo.train_step(env, wide._replace(fused_update="auto"), big)
    assert counts()[1:] == before[1:] and bool(torch.isfinite(summary["v_loss"]))
