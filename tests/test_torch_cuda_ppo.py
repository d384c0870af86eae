"""Kernels K2 (the fused PPO rollout), K3 (the fused PPO loss gradient)
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


def _update_inputs(device, kl_mode=False, floor=None, ent_coef=0.0, value_clip_eps=0.2, lr=3e-4):
    """One K2 rollout of 4096 envs x 16 steps, stacked as K4 takes it, with
    4 epochs x 4 minibatches of tiles of 128, and the kernel's keywords."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=4096, rollout_len=16)
    state = ppo.init_train_state(env, cfg, 7, device=device)
    ro_ = ppo.collect_rollout_kernel(env, cfg, state.params, state.obs_norm, state.ret_norm,
                                     state.env_states, state.env_returns, 13)
    layout = networks.Layout(10, 4)
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
    kw = dict(d=10, adim=4, tile=tile, n_minibatches=4, n_epochs=4, clip_eps=0.2,
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
