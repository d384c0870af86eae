"""The kernels of quadrotor2d-v0 and the slung-load envs on the card against
their plain PyTorch twins: K8/K9 (the closed loops), K6-rest (the fused PPO
rollout of those kinds), K3/K4 at (5, 2), (9, 2) and (16, 4), and K7 on
those kinds; and the learners and throughput_rollout launching them.
Every test needs a CUDA device and the ``nvcc`` that builds the kernels,
and skips without a device.

This file imports no JAX, so that it runs where only PyTorch is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_native2d.py

Tolerances: rtol 2e-4 / atol 2e-5 per value (the JAX kernel tests'
float32 tolerances); K3's gradients rtol 2e-3 / atol 2e-6, K4's params
rtol 2e-4 / atol 1e-6.  nvcc contracts products into FMAs, which the
twin's separate operations do not, so a free-running env that meets a
knife edge (quad2d's done test, the slung-load tether sphere) may take
another branch in the two: quad2d allows 0.1% of its envs to disagree,
and the slung-load kinds are compared one step at a time from the twin's
state, skipping the lanes within 1e-4 of the sphere, as the JAX package's
slung-load tests do.  A rerun is bitwise equal.
"""

import logging

import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.envs import quadrotor2d, quadrotor2d_slungload, quadrotor3d_slungload
from reinmav_tpu_torch.ops import closed_loop_rollout as cl
from reinmav_tpu_torch.ops import offpolicy as op
from reinmav_tpu_torch.ops import ppo_loss as pl
from reinmav_tpu_torch.ops import ppo_rollout as pr
from reinmav_tpu_torch.ops import ppo_update as pu
from reinmav_tpu_torch.rl import networks, ppo, sac, td3

TOL = dict(rtol=2e-4, atol=2e-5)
IDS = ["quadrotor2d-v0", "quadrotor2d-slungload-v0", "quadrotor3d-slungload-v0"]
SLUNG = IDS[1:]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _knife_safe(env_id, s_t):
    """Envs of ``(D, B)`` states away from the tether sphere (all envs of
    quadrotor2d-v0)."""
    if env_id == "quadrotor2d-v0":
        return torch.ones(s_t.shape[1], dtype=torch.bool, device=s_t.device)
    k = 3 if env_id.startswith("quadrotor3d") else 2
    d = s_t.shape[0]
    L = reinmav_tpu_torch.make(env_id).params.tether_length
    return ((s_t[d - 2 * k:d - k] - s_t[0:k]).norm(dim=0) - L).abs() > 1e-4


def _states(env_id, device, batch, scale=1.0, seed=0):
    """``(D, B)`` states: U(-1, 1) times ``scale``, the slung loads at
    1.1 L-ish offsets (both tether branches), the first 1% far out (they
    end at once)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    env = reinmav_tpu_torch.make(env_id)
    d = env.state_dim
    s = (torch.rand((d, batch), generator=gen, device=device) * 2 - 1) * scale
    if env_id != "quadrotor2d-v0":
        k = 3 if d == 16 else 2
        L = env.params.tether_length
        s[d - 2 * k:d - k] = s[0:k] + torch.randn((k, batch), generator=gen, device=device) * (
            1.1 * L / k ** 0.5)
    far = batch // 100
    s[0:2, :far] *= 6.0
    if env_id != "quadrotor2d-v0":
        s[d - 2 * k:d - k, :far] = s[0:k, :far]
    return s.contiguous()


def _mismatched(a, b):
    return int((~torch.isclose(a, b, **TOL).reshape(-1, a.shape[-1]).all(dim=0)).sum())


@pytest.mark.parametrize("env_id", IDS)
def test_closed_loop_kernel_against_twin(cuda, env_id):
    """K8/K9 with resets on: quad2d free-running (<= 0.1% of envs apart),
    the slung-load kinds one step at a time on the envs off the sphere;
    bitwise reruns; the no-reset form."""
    s = _states(env_id, cuda, 16384)
    if env_id == "quadrotor2d-v0":
        f_k, r_k = cl.closed_loop_rollout(env_id, s, 5, 300)
        f_p, r_p = cl.closed_loop_rollout_reference(env_id, s, 5, 300)
        assert _mismatched(f_k, f_p) <= 16
    else:
        x = s
        for t in range(20):
            f_k, r_k = cl.closed_loop_rollout(env_id, x, 5 + t, 1)
            f_p, r_p = cl.closed_loop_rollout_reference(env_id, x, 5 + t, 1)
            safe = _knife_safe(env_id, x)
            assert int(safe.sum()) > 1000
            assert _mismatched(f_k[:, safe], f_p[:, safe]) == 0, t
            torch.testing.assert_close(r_k[safe], r_p[safe], **TOL)
            x = f_p
    again = cl.closed_loop_rollout(env_id, s, 5, 300)
    first = cl.closed_loop_rollout(env_id, s, 5, 300)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    tame = (s * 0.1).contiguous()
    f_k, _ = cl.closed_loop_rollout(env_id, tame, 5, 20, autoreset=False)
    f_p, _ = cl.closed_loop_rollout_reference(env_id, tame, 5, 20, autoreset=False)
    safe = _knife_safe(env_id, tame)
    assert _mismatched(f_k[:, safe], f_p[:, safe]) <= 16


@pytest.mark.parametrize("env_id", IDS)
def test_throughput_rollout_launches_the_closed_loop_kernel(cuda, env_id, caplog):
    """backend="auto" runs K8/K9 with the env's live Params (a sweep), once,
    and says so; a wrapped env takes the eager loop and says why."""
    mod = {"quadrotor2d-v0": quadrotor2d, "quadrotor2d-slungload-v0": quadrotor2d_slungload,
           "quadrotor3d-slungload-v0": quadrotor3d_slungload}[env_id]
    env = mod.make(mod.Params(mass=1.2, dt=0.02, kp=-4.0))
    gen = torch.Generator(device=cuda).manual_seed(0)
    states = env.vreset(gen, 8192)
    before = cl.closed_loop_rollout.launches
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        final, rew = reinmav_tpu_torch.throughput_rollout(env, states, gen, 200)
    torch.cuda.synchronize()
    assert cl.closed_loop_rollout.launches == before + 1 and "fused CUDA kernel" in caplog.text
    assert final.shape == (8192, env.state_dim) and bool(torch.isfinite(rew).all())
    # The same step under the swept Params in kernel and twin.
    s = _states(env_id, cuda, 4096, seed=1)
    pvec = cl.KINDS[env_id].pack(env.params)
    f_k, _ = cl.closed_loop_rollout(env_id, s, 1, 1, params_vec=pvec, autoreset=False)
    f_p, _ = cl.closed_loop_rollout_reference(env_id, s, 1, 1, params_vec=pvec, autoreset=False)
    safe = _knife_safe(env_id, s)
    assert _mismatched(f_k[:, safe], f_p[:, safe]) == 0
    default, _ = cl.closed_loop_rollout(env_id, s, 1, 1, autoreset=False)
    assert not torch.equal(default, f_k)
    from reinmav_tpu_torch.envs import wrappers
    wrapped = wrappers.scale_reward(env, 0.5)
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        reinmav_tpu_torch.throughput_rollout(wrapped, states[:64], gen, 2)
    assert "wrapped or replaced" in caplog.text and cl.closed_loop_rollout.launches == before + 3


def _rollout_inputs(env_id, device, batch):
    env = reinmav_tpu_torch.make(env_id)
    d, a = env.obs_dim, env.action_dim
    layout = networks.Layout(d, a)
    net = networks.init_params(layout, torch.Generator().manual_seed(1)).to(device)
    net[layout.slices[("log_std",)]] = -0.5
    consts = torch.cat([torch.linspace(-0.1, 0.1, d), torch.linspace(0.5, 2.0, d),
                        torch.full((a,), 0.6065), torch.tensor([-0.5 * a, 0.5, 0.99])]).to(device)
    rets = torch.linspace(-1.0, 1.0, batch, device=device)
    return env, layout, net, consts, rets


@pytest.mark.parametrize("env_id", IDS)
def test_k6_rest_against_twin(cuda, env_id):
    """K6 at 4096 envs, noise and resets on: quad2d over 16 steps (<= 0.1%
    of envs apart), the slung-load kinds one step at a time from the twin's
    state on the envs off the sphere; a bitwise rerun."""
    batch = 4096
    env, layout, net, consts, rets = _rollout_inputs(env_id, cuda, batch)
    s = _states(env_id, cuda, batch, scale=1.5)
    kw = dict(params_vec=pr.env_params_vec(env), env_kind=env_id)
    if env_id == "quadrotor2d-v0":
        k = pr.ppo_rollout(s, rets, 3, net, consts, 16, **kw)
        p = pr.ppo_rollout_reference(s, rets, 3, net, consts, 16, **kw)
        bad = (k.done != p.done).any(dim=0)
        for x, y in zip((*k[:5], k.final_states), (*p[:5], p.final_states)):
            bad |= ~torch.isclose(x, y, **TOL).reshape(-1, batch).all(dim=0)
        assert int(bad.sum()) <= 4 and int(p.done.sum()) > 0
    else:
        x, r = s, rets
        for t in range(8):
            k = pr.ppo_rollout(x, r, 3 + t, net, consts, 1, **kw)
            p = pr.ppo_rollout_reference(x, r, 3 + t, net, consts, 1, **kw)
            safe = _knife_safe(env_id, x)
            for a, b in zip((*k[:5], k.final_states), (*p[:5], p.final_states)):
                assert _mismatched(a[..., safe], b[..., safe]) == 0, t
            assert torch.equal(k.done[:, safe], p.done[:, safe])
            x, r = p.final_states, p.returns
    again = pr.ppo_rollout(s, rets, 3, net, consts, 16, **kw)
    first = pr.ppo_rollout(s, rets, 3, net, consts, 16, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert first.action.shape == (16, env.action_dim, batch)


@pytest.mark.parametrize("env_id", IDS)
def test_k3_k4_at_the_kinds_dims_against_twins(cuda, env_id):
    env, layout, net, consts, rets = _rollout_inputs(env_id, cuda, 4096)
    d, a = env.obs_dim, env.action_dim
    out = pr.ppo_rollout(_states(env_id, cuda, 4096), rets, 3, net, consts, 16,
                         params_vec=pr.env_params_vec(env), env_kind=env_id)
    n = 4096 * 16
    gen = torch.Generator(device=cuda).manual_seed(2)
    data = pl.stack_batch(out.obs.permute(1, 0, 2).reshape(d, n),
                          out.action.permute(1, 0, 2).reshape(a, n), out.log_prob.reshape(n),
                          out.value.reshape(n), torch.randn(n, generator=gen, device=cuda),
                          torch.randn(n, generator=gen, device=cuda))
    stats = torch.tensor([0.1, 1.2, 0.0, 0.0], device=cuda)
    net2 = (net + 0.02 * torch.randn(net.shape, generator=gen, device=cuda)).contiguous()
    perm = torch.randperm(n // 128, device=cuda, generator=gen).to(torch.int32)
    kw = dict(d=d, adim=a, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, tile=128)
    mb = perm[:n // 512].contiguous()
    g_k, m_k = pl.ppo_loss_grads_gather(data, stats, mb, net2, ent_coef=0.01, **kw)
    g_p, m_p = pl._finish(pl.ppo_loss_grads_reference(data, stats, mb, net2, **kw),
                          mb.numel() * 128, 0.01, layout)
    torch.testing.assert_close(g_k, g_p, rtol=2e-3, atol=2e-6)
    for name in pl.METRICS:
        torch.testing.assert_close(m_k[name], m_p[name], rtol=2e-4, atol=1e-6)
    assert torch.equal(g_k, pl.ppo_loss_grads_gather(data, stats, mb, net2, ent_coef=0.01,
                                                     **kw)[0])
    perm_all = torch.cat([torch.randperm(n // 128, device=cuda, generator=gen)
                          for _ in range(4)]).to(torch.int32)
    adv = torch.tensor([[0.1, 1.1]] * 16, device=cuda)
    opt = ppo.make_optimizer(ppo.PpoConfig()).init(net)
    ukw = dict(d=d, adim=a, tile=128, n_minibatches=4, n_epochs=4, clip_eps=0.2,
               value_clip_eps=0.2, value_coef=0.5, ent_coef=0.01, lr=3e-4, max_grad_norm=0.5)
    u = pu.ppo_update(data, adv, perm_all, net, opt, None, keep_grad0=True, **ukw)
    p_params, p_opt, _, _ = pu.ppo_update_reference(data, adv, perm_all, net, opt, None, **ukw)
    torch.testing.assert_close(u.params, p_params, rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(u.opt_state.mu, p_opt.mu, rtol=2e-4, atol=5e-8)
    again = pu.ppo_update(data, adv, perm_all, net, opt, None, keep_grad0=True, **ukw)
    assert torch.equal(u.params, again.params)


@pytest.mark.parametrize("env_id", IDS)
@pytest.mark.parametrize("mode", ["sac", "td3", "sac_det", "td3_det"])
def test_k7_on_the_new_kinds_against_twin(cuda, env_id, mode):
    env = reinmav_tpu_torch.make(env_id)
    d, a = env.obs_dim, env.action_dim
    out = 2 * a if mode.startswith("sac") else a
    layout = sac.MlpLayout((d, 128, 128, out))
    flat = sac.init_mlp(layout, torch.Generator().manual_seed(31)).to(cuda)
    flat = flat + 0.05 * torch.randn(flat.shape, device=cuda,
                                     generator=torch.Generator(device=cuda).manual_seed(3))
    s = _states(env_id, cuda, 8192)
    consts = sac.collect_consts(env, torch.tensor(False, device=cuda), 0.3)
    args = (env_id, mode, s, 15, consts, pr.env_params_vec(env),
            *op.actor_kernel_args(layout.layers(flat)))
    new_k, blk_k = op.collect_step(*args)
    new_p, blk_p = op.collect_step_reference(*args)
    safe = _knife_safe(env_id, s)
    bad = ~(torch.isclose(new_k, new_p, **TOL).all(dim=0) & torch.isclose(blk_k, blk_p,
                                                                         **TOL).all(dim=0))
    assert int((bad & safe).sum()) <= 8
    assert int(blk_p[2 * d + a + 1].sum()) > 0  # envs ended and reset
    again = op.collect_step(*args)
    assert torch.equal(new_k, again[0]) and torch.equal(blk_k, again[1])


@pytest.mark.parametrize("env_id", IDS)
def test_learners_launch_the_kernels(cuda, env_id, caplog):
    """train_step's default path: one K6 and one K4 launch per update, K3
    never; SAC and TD3 train_iters: one K7 launch per iteration."""
    env = reinmav_tpu_torch.make(env_id)
    cfg = ppo.PpoConfig(num_envs=2048, rollout_len=16)
    state = ppo.init_train_state(env, cfg, 0, device=cuda)
    k6, k3, k4 = pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches, pu.ppo_update.launches
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.rl.ppo"):
        for _ in range(2):
            state, summary = ppo.train_step(env, cfg, state)
    torch.cuda.synchronize()
    assert (pr.ppo_rollout.launches, pl.ppo_loss_grads_gather.launches,
            pu.ppo_update.launches) == (k6 + 2, k3, k4 + 2)
    assert "rollout: K6 CUDA kernel" in caplog.text and "K4 CUDA kernel, 1 launch" in caplog.text
    assert all(bool(torch.isfinite(v)) for v in summary.values()), summary
    for module, config in ((sac, sac.SacConfig), (td3, td3.Td3Config)):
        ocfg = config(num_envs=1024, batch_size=256, buffer_capacity=1 << 14, warmup_steps=0,
                      hidden=(64, 64))
        ostate = module.init_state(env, ocfg, 0, device=cuda)
        before = op.collect_step.launches
        ostate, met = module.train_iters(env, ocfg, ostate, 3)
        torch.cuda.synchronize()
        assert op.collect_step.launches == before + 3
        assert all(bool(torch.isfinite(torch.tensor(v))) for v in met.values()), met
