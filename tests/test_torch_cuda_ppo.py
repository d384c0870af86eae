"""Kernels K2 (the fused PPO rollout) and K3 (the fused PPO loss gradient)
on the card, against their plain PyTorch twins, and the PPO learner
launching both.  Every test needs a CUDA device and the ``nvcc`` that
builds the kernels, and skips without a device.

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
"""

import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.ops import ppo_loss as pl
from reinmav_tpu_torch.ops import ppo_rollout as pr
from reinmav_tpu_torch.ops import rollout as ro
from reinmav_tpu_torch.envs import quadrotor3d
from reinmav_tpu_torch.rl import networks, ppo

TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-6)
METRIC_TOL = dict(rtol=2e-4, atol=1e-6)

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


def _mismatched_envs(a: pr.RolloutOut, b: pr.RolloutOut) -> int:
    """Envs whose trajectory, final state or return differ anywhere."""
    bad = torch.zeros(a.returns.shape[0], dtype=torch.bool, device=a.returns.device)
    for x, y in zip(a[:5], b[:5]):
        close = torch.isclose(x, y, **TOL)
        bad |= ~close.reshape(-1, close.shape[-1]).all(dim=0)
    bad |= (a.done != b.done).any(dim=0)
    bad |= ~torch.isclose(a.final_states, b.final_states, **TOL).all(dim=0)
    bad |= ~torch.isclose(a.returns, b.returns, **TOL)
    return int(bad.sum())


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


def _loss_batch(device, n, seed):
    rng = np.random.default_rng(seed)
    layout = networks.Layout(10, 4)
    net = networks.init_params(layout, torch.Generator().manual_seed(seed))
    net[layout.slices[("log_std",)]] = torch.tensor([-0.5, 0.0, 0.3, -1.0])
    data = np.concatenate([rng.normal(size=(10, n)), rng.normal(size=(4, n)),
                           rng.normal(-4.0, 1.0, size=(1, n)), rng.normal(size=(1, n)),
                           rng.normal(size=(1, n)), rng.normal(size=(1, n))]).astype(np.float32)
    return (torch.tensor(data, device=device), net.to(device),
            torch.tensor(rng.permutation(n // 128)[: n // 512], dtype=torch.int32, device=device))


@pytest.mark.parametrize("kl_mode", [False, True], ids=["clip", "kl"])
def test_k3_matches_twin_and_repeats_bitwise(cuda, kl_mode):
    data, net, perm = _loss_batch(cuda, 65536, 3)
    adv_stats = torch.tensor([0.1, 0.9, 0.5, 0.0], device=cuda)
    cfg = dict(d=10, adim=4, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, tile=128,
               kl_mode=kl_mode)
    before = pl.ppo_loss_grads_gather.launches
    g_k, m_k = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.01, **cfg)
    torch.cuda.synchronize()
    assert pl.ppo_loss_grads_gather.launches == before + 1
    sums = pl.ppo_loss_grads_reference(data, adv_stats, perm, net, **cfg)
    g_p, m_p = pl._finish(sums, perm.shape[0] * 128, 0.01, networks.Layout(10, 4))
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(), **GRAD_TOL)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(m_k[name]), float(m_p[name]), **METRIC_TOL,
                                   err_msg=name)
    g_k2, m_k2 = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.01, **cfg)
    assert torch.equal(g_k, g_k2)
    assert all(torch.equal(m_k[k], m_k2[k]) for k in pl.METRICS)


def test_k3_ragged_minibatch(cuda):
    """A minibatch that is not a multiple of the kernel's 128-sample sub-block."""
    data, net, _ = _loss_batch(cuda, 4096, 4)
    perm = torch.tensor([5, 0, 31, 7, 12], dtype=torch.int32, device=cuda)
    adv_stats = torch.tensor([0.0, 1.0, 0.0, 0.0], device=cuda)
    cfg = dict(d=10, adim=4, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, tile=32)
    g_k, m_k = pl.ppo_loss_grads_gather(data, adv_stats, perm, net, ent_coef=0.0, **cfg)
    g_p, m_p = pl.ppo_loss_grads_gather(data.cpu(), adv_stats.cpu(), perm.cpu(), net.cpu(),
                                        ent_coef=0.0, **cfg)
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.numpy(), **GRAD_TOL)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(m_k[name]), float(m_p[name]), **METRIC_TOL)


def test_train_step_launches_both_kernels(cuda, caplog):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=2048, rollout_len=16, fused_update="off")
    state = ppo.init_train_state(env, cfg, 0, device=cuda)
    k2, k3 = pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches
    with caplog.at_level("INFO", logger="reinmav_tpu_torch.rl.ppo"):
        state, summary = ppo.train_step(env, cfg, state)
    torch.cuda.synchronize()
    assert pr.ppo_rollout.launches == k2 + 1
    assert pl.ppo_loss_grads_gather.launches == k3 + cfg.num_epochs * cfg.num_minibatches
    assert "K2 CUDA kernel" in caplog.text and "K3 CUDA kernel" in caplog.text
    assert all(bool(torch.isfinite(v)) for v in summary.values()), summary
    assert state.params.device.type == "cuda" and state.update_step == 1
    with pytest.raises(NotImplementedError, match="K4"):
        ppo.train_step(env, cfg._replace(fused_update="on"), state)


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
