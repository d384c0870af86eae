"""The hover task's kernels on the card, against their plain PyTorch twins:
K5 (the constant-action throughput rollout), K6-hover (the fused PPO
rollout of MujocoQuadForce-v1), and K3/K4 built for the 13-dim
observation; and the learner launching them.  Every test needs a CUDA
device and the ``nvcc`` that builds the kernels, and skips without a
device.

This file imports no JAX, so that it runs where only PyTorch is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_hover.py

Tolerances:

- K5 and K6-hover: rtol 2e-4 / atol 2e-5 per value (the JAX kernel tests'
  float32 tolerances).  The hover task's done test (z <= 0.3, |x| or |y|
  >= 2) is a knife edge: an env whose state lands within rounding of it
  resets in one and not the other (nvcc contracts products into FMAs, the
  twin does not), so the comparison counts the envs that disagree anywhere
  and allows 0.1%.  K5's reward total rtol 1e-3.
- K3 at D = 13: gradients rtol 2e-3 / atol 2e-6, metrics rtol 2e-4 / atol
  1e-6 (tests/test_pallas_ppo.py's own); a rerun bitwise equal.
- K4 at D = 13, one update of 4 epochs x 4 minibatches at lr 3e-4: params
  rtol 2e-4 / atol 1e-6, Adam moments rtol 2e-4 / atol 5e-8, metrics rtol
  1e-4 / atol 1e-6 against the twin and against the K3 loop; pass 0's
  gradient bitwise one K3 launch; a rerun bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.envs import tpuquad
from reinmav_tpu_torch.ops import hover_rollout as hr
from reinmav_tpu_torch.ops import ppo_loss as pl
from reinmav_tpu_torch.ops import ppo_rollout as pr
from reinmav_tpu_torch.ops import ppo_update as pu
from reinmav_tpu_torch.rl import networks, ppo

TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-6)
METRIC_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
MOMENT_TOL = dict(rtol=2e-4, atol=5e-8)
UPDATE_METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
HOVER = "MujocoQuadForce-v1"

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _hover_states(device, batch, seed, z_lo=0.7, z_hi=1.3):
    """Perturbed hover states, ``(13, B)`` float32."""
    rng = np.random.default_rng(seed)
    s = np.zeros((13, batch), np.float32)
    s[0:2] = rng.uniform(-0.3, 0.3, (2, batch))
    s[2] = rng.uniform(z_lo, z_hi, batch)
    s[3] = 1.0
    s[7:13] = rng.uniform(-0.5, 0.5, (6, batch))
    return torch.tensor(s, device=device)


@pytest.mark.parametrize("action", [(0.0, 0.0, 0.0, 0.0), (0.75, 0.73, 0.74, 0.76)])
def test_k5_matches_twin_through_resets(cuda, action):
    states = _hover_states(cuda, 4096 + 37, 0)  # a ragged tail
    before = hr.hover_rollout.launches
    f_k, r_k = hr.hover_rollout(states, 300, action=action)
    torch.cuda.synchronize()
    assert hr.hover_rollout.launches == before + 1
    f_p, r_p = hr.hover_rollout_reference(states, 300, action=action)
    bad = ~torch.isclose(f_k, f_p, **TOL).all(dim=0) | ~torch.isclose(r_k, r_p, rtol=2e-4,
                                                                      atol=1e-2)
    assert int(bad.sum()) <= 0.001 * states.shape[1], int(bad.sum())
    total_rel = abs(float(r_k.double().sum() - r_p.double().sum())) / abs(float(r_p.double().sum()))
    assert total_rel <= 1e-3, total_rel
    f_k2, r_k2 = hr.hover_rollout(states, 300, action=action)
    assert torch.equal(f_k, f_k2) and torch.equal(r_k, r_k2)


def test_k5_takes_live_params_and_frame_skip(cuda):
    params = tpuquad.Params(init_z=0.8, mass=0.32, dt=0.008, frame_skip=3)
    states = _hover_states(cuda, 2048, 1)
    kw = dict(params_vec=hr.hover_params_vec(params), frame_skip=params.frame_skip)
    f_k, r_k = hr.hover_rollout(states, 100, **kw)
    f_p, r_p = hr.hover_rollout_reference(states, 100, **kw)
    bad = ~torch.isclose(f_k, f_p, **TOL).all(dim=0)
    assert int(bad.sum()) <= 0.001 * states.shape[1]
    assert not torch.equal(f_k, hr.hover_rollout(states, 100)[0])


def test_throughput_rollout_launches_k5(cuda, caplog):
    env = reinmav_tpu_torch.make(HOVER)
    gen = torch.Generator(device=cuda).manual_seed(0)
    states = env.vreset(gen, 8192)
    before = hr.hover_rollout.launches
    with caplog.at_level("INFO", logger="reinmav_tpu_torch.envs.core"):
        final, rew = reinmav_tpu_torch.throughput_rollout(env, states, gen, 200)
    torch.cuda.synchronize()
    assert hr.hover_rollout.launches == before + 1 and "fused CUDA kernel" in caplog.text
    f_e, r_e = reinmav_tpu_torch.throughput_rollout(env, states, gen, 200, backend="scan")
    np.testing.assert_allclose(final.cpu().numpy(), f_e.cpu().numpy(), **TOL)
    np.testing.assert_allclose(rew.cpu().numpy(), r_e.cpu().numpy(), rtol=2e-4, atol=1e-2)
    # The contact env launches its own kernel, K11, once, and not K5.
    from reinmav_tpu_torch.ops import contact_rollout as cr

    ground = reinmav_tpu_torch.make("MujocoQuadForce-v0")
    k11_before = cr.contact_rollout.launches
    reinmav_tpu_torch.throughput_rollout(ground, ground.vreset(gen, 64), gen, 2)
    assert cr.contact_rollout.launches == k11_before + 1
    assert hr.hover_rollout.launches == before + 1


def _rollout_args(device, batch, seed, params=None):
    env = tpuquad.make_hovering(params)
    cfg = ppo.PpoConfig(num_envs=batch, rollout_len=16)
    st = ppo.init_train_state(env, cfg, seed, device=device)
    layout = networks.Layout(13, 4)
    obs_norm = ppo.ObsNorm(torch.linspace(-0.1, 0.1, 13, device=device),
                           torch.linspace(0.5, 2.0, 13, device=device),
                           torch.tensor(100.0, device=device))
    ret_norm = ppo.RetNorm(torch.tensor(4.0, device=device), torch.tensor(100.0, device=device))
    net = st.params.clone()
    net[layout.slices[("log_std",)]] = -0.5
    consts = ppo._rollout_consts(net, layout, obs_norm, ret_norm, 0.99)
    rets = torch.linspace(-1.0, 1.0, batch, device=device)
    states = _hover_states(device, batch, seed, z_lo=0.35, z_hi=1.0)
    return (states, rets, 5, net, consts), pr.env_params_vec(env)


def _mismatched_envs(a, b) -> int:
    bad = (a.done != b.done).any(dim=0)
    for x, y in zip((*a[:5], a.final_states), (*b[:5], b.final_states)):
        close = torch.isclose(x, y, **TOL)
        bad |= ~close.reshape(-1, close.shape[-1]).all(dim=0)
    bad |= ~torch.isclose(a.returns, b.returns, **TOL)
    return int(bad.sum())


def test_k6_hover_matches_twin_with_noise_and_resets(cuda):
    args, pv = _rollout_args(cuda, 4096 + 37, 0)
    before = pr.ppo_rollout.launches
    k = pr.ppo_rollout(*args, 16, params_vec=pv, env_kind=HOVER)
    torch.cuda.synchronize()
    assert pr.ppo_rollout.launches == before + 1
    p = pr.ppo_rollout_reference(*args, 16, params_vec=pv, env_kind=HOVER)
    assert int(p.done.sum()) > 1000, "too few resets"
    bad = _mismatched_envs(k, p)
    assert bad <= 0.001 * k.returns.shape[0], bad
    np.testing.assert_allclose(k.stats.cpu().numpy(), p.stats.cpu().numpy(), rtol=1e-4, atol=1e-2)
    again = pr.ppo_rollout(*args, 16, params_vec=pv, env_kind=HOVER)
    assert all(torch.equal(x, y) for x, y in zip(k, again))


@pytest.mark.parametrize("norm_obs,norm_rew", [(False, False), (True, False), (False, True)])
def test_k6_hover_switches_and_live_params(cuda, norm_obs, norm_rew):
    args, pv = _rollout_args(cuda, 2048, 1, tpuquad.Params(init_z=0.9, mass=0.31, arm_xy=0.11))
    kw = dict(params_vec=pv, env_kind=HOVER, normalize_obs=norm_obs, normalize_rewards=norm_rew)
    k = pr.ppo_rollout(*args, 8, **kw)
    p = pr.ppo_rollout_reference(*args, 8, **kw)
    assert _mismatched_envs(k, p) <= 0.001 * 2048
    np.testing.assert_allclose(k.stats.cpu().numpy(), p.stats.cpu().numpy(), rtol=1e-4, atol=1e-2)


def _hover_batch(device, seed):
    """One K6-hover rollout of 4096 envs x 16 steps, stacked as K3/K4 take
    it, with 4 epochs x 4 minibatches of tiles of 128."""
    env = reinmav_tpu_torch.make(HOVER)
    cfg = ppo.PpoConfig(num_envs=4096, rollout_len=16)
    state = ppo.init_train_state(env, cfg, seed, device=device)
    ro_ = ppo.collect_rollout_kernel(env, cfg, state.params, state.obs_norm, state.ret_norm,
                                     state.env_states, state.env_returns, 13)
    layout = networks.Layout(13, 4)
    n = 4096 * 16
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
    return data, adv, adv_stats, perm_all, tile, state


@pytest.mark.parametrize("kl_mode", [False, True], ids=["clip", "kl"])
def test_k3_at_obs_dim_13_matches_twin_and_repeats_bitwise(cuda, kl_mode):
    data, adv, _, perm_all, tile, state = _hover_batch(cuda, 3)
    perm = perm_all[:perm_all.numel() // 16].contiguous()
    gen = torch.Generator(device=cuda).manual_seed(8)
    net = (state.params + 0.02 * torch.randn(state.params.shape, generator=gen,
                                             device=cuda)).contiguous()
    adv_stats = torch.tensor([0.1, 0.9, 0.5, 0.0], device=cuda)
    cfg = dict(d=13, adim=4, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, tile=tile,
               kl_mode=kl_mode)
    before = pl.ppo_loss_grads_gather.launches
    g_k, m_k = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.01, **cfg)
    torch.cuda.synchronize()
    assert pl.ppo_loss_grads_gather.launches == before + 1
    sums = pl.ppo_loss_grads_reference(data, adv_stats, perm, net, **cfg)
    g_p, m_p = pl._finish(sums, perm.numel() * tile, 0.01, networks.Layout(13, 4))
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(), **GRAD_TOL)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(m_k[name]), float(m_p[name]), **METRIC_TOL, err_msg=name)
    g_k2, m_k2 = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.01, **cfg)
    assert torch.equal(g_k, g_k2) and all(torch.equal(m_k[x], m_k2[x]) for x in pl.METRICS)


@pytest.mark.parametrize("mode", ["clip", "floor-entropy"])
def test_k4_at_obs_dim_13_matches_twin_k3_and_repeats_bitwise(cuda, mode):
    extra = {"clip": {}, "floor-entropy": {"log_std_floor": -0.05, "ent_coef": 0.01}}[mode]
    data, _, adv_stats, perm_all, tile, state = _hover_batch(cuda, 7)
    kw = dict(d=13, adim=4, tile=tile, n_minibatches=4, n_epochs=4, clip_eps=0.2,
              value_clip_eps=0.2, value_coef=0.5, ent_coef=extra.get("ent_coef", 0.0), lr=3e-4,
              max_grad_norm=0.5, log_std_floor=extra.get("log_std_floor"))
    params, opt = state.params, state.opt_state
    before = pu.ppo_update.launches
    k = pu.ppo_update(data, adv_stats, perm_all, params, opt, None, keep_grad0=True, **kw)
    torch.cuda.synchronize()
    assert pu.ppo_update.launches == before + 1
    p_params, p_opt, p_sums, p_grad0 = pu.ppo_update_reference(data, adv_stats, perm_all, params,
                                                               opt, None, **kw)
    np.testing.assert_allclose(k.params.cpu().numpy(), p_params.cpu().numpy(), **PARAM_TOL)
    for got, ref in zip(k.opt_state[1:], p_opt[1:]):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **MOMENT_TOL)
    assert int(k.opt_state.count) == int(p_opt.count) == 16
    means = pu._metric_means(p_sums, 16, 4, perm_all.numel() // 16 * tile, False)
    for name, v in means.items():
        np.testing.assert_allclose(float(k.metrics[name]), float(v), **UPDATE_METRIC_TOL,
                                   err_msg=name)
    tpm = perm_all.numel() // 16
    zero = adv_stats[0, 0] * 0
    k3_stats = torch.stack([adv_stats[0, 0], adv_stats[0, 1], zero, zero]).contiguous()
    g3, _ = pl.ppo_loss_grads_gather(data, k3_stats, perm_all[:tpm].contiguous(), params, d=13,
                                     adim=4, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5,
                                     ent_coef=kw["ent_coef"], tile=tile)
    assert torch.equal(k.grad0, g3)
    np.testing.assert_allclose(k.grad0.cpu().numpy(), p_grad0.cpu().numpy(), **GRAD_TOL)
    again = pu.ppo_update(data, adv_stats, perm_all, params, opt, None, **kw)
    assert torch.equal(k.params, again.params)
    assert all(torch.equal(a, b) for a, b in zip(k.opt_state, again.opt_state))


def test_train_step_on_hover_launches_k6_hover_and_k4(cuda, caplog):
    env = reinmav_tpu_torch.make(HOVER)
    cfg = ppo.PpoConfig(num_envs=2048, rollout_len=16)  # the default paths
    state = ppo.init_train_state(env, cfg, 0, device=cuda)
    k2, k3, k4 = pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches, pu.ppo_update.launches
    with caplog.at_level("INFO", logger="reinmav_tpu_torch.rl.ppo"):
        for _ in range(2):
            state, summary = ppo.train_step(env, cfg, state)
    torch.cuda.synchronize()
    assert (pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches,
            pu.ppo_update.launches) == (k2 + 2, k3, k4 + 2)
    assert "rollout: K6-hover CUDA kernel" in caplog.text
    assert "K4 CUDA kernel, 1 launch" in caplog.text
    assert all(bool(torch.isfinite(v)) for v in summary.values()), summary
    assert 50.0 < float(summary["mean_reward"]) < 100.0


def test_train_step_with_dims_no_kernel_is_built_for_takes_the_loop(cuda, caplog):
    """An env whose obs dims no K2/K3/K4 build takes: "auto" logs each
    refusal and runs the eager rollout and the autograd loop; it does not
    raise."""
    env = dataclasses.replace(reinmav_tpu_torch.make(HOVER), obs_dim=7)
    cfg = ppo.PpoConfig(num_envs=256, rollout_len=8, num_epochs=1, num_minibatches=2)
    state = ppo.init_train_state(env, cfg, 0, device=cuda)
    counts = (pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches, pu.ppo_update.launches)
    with caplog.at_level("INFO", logger="reinmav_tpu_torch.rl.ppo"):
        state, summary = ppo.train_step(env, cfg, state)
    torch.cuda.synchronize()
    assert (pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches,
            pu.ppo_update.launches) == counts
    assert "eager loop" in caplog.text and "(10, 4), (13, 4)" in caplog.text
    assert "loss gradient autograd" in caplog.text
    assert all(bool(torch.isfinite(v)) for v in summary.values()), summary
