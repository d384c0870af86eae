"""K7 (the fused off-policy collection step) on the card, against its plain
PyTorch twin, and the SAC/TD3/DDPG learners launching it.  Every test
needs a CUDA device and the ``nvcc`` that builds the kernels, and skips
without a device.

This file imports no JAX, so that it runs where only PyTorch is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_offpolicy.py

Tolerances: rtol 2e-4 / atol 2e-5 per value of the block and the new
states (the JAX kernel tests' float32 tolerances).  Kernel and twin draw
the same Philox numbers; nvcc contracts products into FMAs and the twin's
products are cuBLAS's, so an env on the hover task's done knife edge (z
<= 0.3) may end in one and not the other: the comparison counts the envs
that disagree and allows 0.1%.  A rerun is bitwise equal.
"""

import logging
import math

import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.ops import offpolicy as op
from reinmav_tpu_torch.ops import ppo_rollout as pr
from reinmav_tpu_torch.rl import sac, td3
from reinmav_tpu_torch.utils import checkpoint as ckpt

TOL = dict(rtol=2e-4, atol=2e-5)
MODES = [("sac", 0.0, 0.0), ("td3", 0.0, 0.3), ("sac_det", 0.0, 0.0), ("td3_det", 0.0, 0.0),
         ("sac", 1.0, 0.0)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _states(env, device, batch):
    """Start states ``(D, B)`` of which some end in one step."""
    gen = torch.Generator(device=device).manual_seed(3)
    s = env.vreset(gen, batch).T.contiguous()
    if env.name == "quadrotor3d-v0":
        return (s * 2.0).contiguous()
    s[0:2] = (torch.rand((2, batch), generator=gen, device=device) * 2 - 1) * 0.3
    s[7:13] = (torch.rand((6, batch), generator=gen, device=device) * 2 - 1) * 0.5
    s[2, :batch // 50], s[9, :batch // 50] = 0.302, -1.0
    return s


def _actor(env, device, hidden, out):
    layout = sac.MlpLayout((env.obs_dim, hidden, hidden, out))
    flat = sac.init_mlp(layout, torch.Generator().manual_seed(1)).to(device)
    flat = flat + 0.05 * torch.randn(flat.shape, device=device,
                                     generator=torch.Generator(device=device).manual_seed(2))
    return op.actor_kernel_args(layout.layers(flat))


@pytest.mark.parametrize("hidden", [32, 96, 256])
@pytest.mark.parametrize("env_id", ["quadrotor3d-v0", "MujocoQuadForce-v1"])
def test_k7_matches_twin_in_every_mode(cuda, env_id, hidden):
    env = reinmav_tpu_torch.make(env_id)
    batch = 4096 + 37  # a ragged last tile
    states = _states(env, cuda, batch)
    d, a = env.obs_dim, env.action_dim
    for mode, warm, noise in MODES:
        weights = _actor(env, cuda, hidden, 2 * a if mode.startswith("sac") else a)
        consts = sac.collect_consts(env, torch.tensor(warm > 0.5, device=cuda), noise)
        args = (env_id, mode, states, 11, consts, pr.env_params_vec(env), *weights)
        before = op.collect_step.launches
        new_k, blk_k = op.collect_step(*args)
        assert op.collect_step.launches == before + 1
        new_p, blk_p = op.collect_step_reference(*args)
        torch.cuda.synchronize()
        bad = ~(torch.isclose(new_k, new_p, **TOL).all(0) & torch.isclose(blk_k, blk_p, **TOL).all(0))
        assert int(bad.sum()) <= 0.001 * batch, (mode, warm, int(bad.sum()))
        assert int(blk_p[2 * d + a + 1].sum()) > 0, "no env ended"
        assert float(blk_k[d:d + a].abs().max()) <= 1.0
        again = op.collect_step(*args)
        assert torch.equal(new_k, again[0]) and torch.equal(blk_k, again[1])


def test_k7_refuses_widths_and_kinds_it_is_not_built_for(cuda):
    env = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    states = _states(env, cuda, 256)
    consts = sac.collect_consts(env, torch.tensor(False, device=cuda), 0.0)
    for hidden in (48, 288):
        with pytest.raises(ValueError, match="multiples of 32"):
            op.collect_step(env.name, "sac", states, 1, consts, pr.env_params_vec(env),
                            *_actor(env, cuda, hidden, 8))
    with pytest.raises(ValueError, match="states_t must be"):
        op.collect_step("quadrotor3d-v0", "sac", states, 1, consts, None,
                        *_actor(env, cuda, 64, 8))


@pytest.mark.parametrize("env_id", ["quadrotor3d-v0", "MujocoQuadForce-v1"])
def test_sac_launches_k7_once_per_iteration_and_learns_alike(cuda, env_id, caplog):
    env = reinmav_tpu_torch.make(env_id)
    cfg = sac.SacConfig(num_envs=8192, batch_size=1024, buffer_capacity=1 << 16,
                        hidden=(128, 128), warmup_steps=8192)
    state = sac.init_state(env, cfg, 0, device=cuda)
    before = op.collect_step.launches
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.rl.sac"):
        state, met = sac.train_iters(env, cfg, state, 4)
    assert op.collect_step.launches == before + 4
    assert "K7 CUDA kernel, 1 launch per iteration" in caplog.text
    assert all(math.isfinite(v) for v in met.values()) and met["q_loss"] > 0.0
    assert int(state.ptr) == int(state.filled) == 4 * 8192

    def fork(s):
        gen = torch.Generator()
        gen.set_state(s.generator.get_state())
        return s._replace(buffer=s.buffer.clone(), generator=gen)

    _, fused = sac.train_iters(env, cfg, fork(state), 2)
    _, eager = sac.train_iters(env, cfg._replace(fused_collect="off"), fork(state), 2)
    assert abs(fused["mean_reward"] - eager["mean_reward"]) <= 0.1 * abs(eager["mean_reward"])


@pytest.mark.parametrize("alg", ["td3", "ddpg"])
def test_td3_and_ddpg_launch_k7(cuda, alg):
    env = reinmav_tpu_torch.make("quadrotor3d-v0" if alg == "td3" else "MujocoQuadForce-v1")
    extra = {} if alg == "td3" else dict(single_critic=True, policy_noise=0.0, noise_clip=0.0,
                                         policy_delay=1)
    cfg = td3.Td3Config(num_envs=8192, batch_size=1024, buffer_capacity=1 << 16, hidden=(64, 64),
                        warmup_steps=0, **extra)
    state = td3.init_state(env, cfg, 0, device=cuda)
    actor0, before = state.actor.clone(), op.collect_step.launches
    state, met = td3.train_iters(env, cfg, state, 4)
    assert op.collect_step.launches == before + 4
    assert all(math.isfinite(v) for v in met.values())
    assert not torch.equal(state.actor, actor0) and int(state.updates) == 4


def test_resume_on_the_card_is_bitwise(cuda, tmp_path):
    env = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    cfg = sac.SacConfig(num_envs=4096, batch_size=512, buffer_capacity=1 << 15, hidden=(64, 64),
                        warmup_steps=0)
    ref, _ = sac.train_iters(env, cfg, sac.init_state(env, cfg, 4, device=cuda), 4)
    half, _ = sac.train_iters(env, cfg, sac.init_state(env, cfg, 4, device=cuda), 2)
    ckpt.save(str(tmp_path / "ck"), half)
    back = ckpt.restore(str(tmp_path / "ck"), sac.init_state(env, cfg, 5, device=cuda))
    assert back.actor.device.type == "cuda"
    back, _ = sac.train_iters(env, cfg, back, 2)
    for x, y in zip(ref, back):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        elif isinstance(x, tuple):
            assert all(torch.equal(u, v) for u, v in zip(x, y))
        else:
            assert torch.equal(x, y)
