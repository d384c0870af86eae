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
that disagree and allows 0.1%.  A rerun is bitwise equal.  K7's bf16
instance is held to the bf16 twin the same way, at every kind and mode.
K7's wide instances (a layer past 256 units, up to 1024) are held to the
twins the same way at the widths of ``chip_smoke.py --only collect``, the
wide bf16 instance's pack kernel bitwise to its twin; the wide float32
instance, launched at widths the narrow one takes, gives its bits.
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
BF16 = "bfloat16"
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
    """Start states ``(D, B)`` of which some end in one step (the
    quadrotor2d and slung-load kinds: a reset's spread times 1.5, and on
    the slung-load kinds one env in 50 with state 7 at 25, past the
    vel_limit of 10: the load's x velocity in 2D, the quad's in 3D)."""
    gen = torch.Generator(device=device).manual_seed(3)
    s = env.vreset(gen, batch).T.contiguous()
    if env.name == "quadrotor3d-v0":
        return (s * 2.0).contiguous()
    if env.name != "MujocoQuadForce-v1":
        s = s * 1.5
        if "slungload" in env.name:
            s[7, :batch // 50] = 25.0
        return s.contiguous()
    s[0:2] = (torch.rand((2, batch), generator=gen, device=device) * 2 - 1) * 0.3
    s[7:13] = (torch.rand((6, batch), generator=gen, device=device) * 2 - 1) * 0.5
    s[2, :batch // 50], s[9, :batch // 50] = 0.302, -1.0
    return s


def _actor(env, device, hidden, out):
    """A perturbed actor of widths ``hidden`` (an int: two equal layers)."""
    widths = (hidden, hidden) if isinstance(hidden, int) else tuple(hidden)
    layout = sac.MlpLayout((env.obs_dim, *widths, out))
    flat = sac.init_mlp(layout, torch.Generator().manual_seed(1)).to(device)
    flat = flat + 0.05 * torch.randn(flat.shape, device=device,
                                     generator=torch.Generator(device=device).manual_seed(2))
    return op.actor_kernel_args(layout.layers(flat))


@pytest.mark.parametrize("hidden", [32, 96, 256, (48, 80), (256, 7), (1, 129)])
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


@pytest.mark.parametrize("hidden", [256, 32, 100])
@pytest.mark.parametrize("env_id", list(pr.ENVS))
def test_k7_bf16_matches_twin_in_every_mode(cuda, env_id, hidden):
    """K7's bf16 instance (the hidden layers on the tensor cores) against
    the bf16 twin in every mode leg, as phase 37 holds it: each env's block
    and new state within rtol 2e-4 / atol 2e-5, at most 0.1% of envs
    apart, some envs ended and every action within [-1, 1]; one launch
    counted, bitwise on a rerun, the probe's outputs bitwise its own and
    no bf16 h of the probe's apart from the twin's unless recomputed (no
    miss); at 2 x 256, 2 x 32 and 2 x 100 (not a multiple of 16), on a
    ragged last tile."""
    env = reinmav_tpu_torch.make(env_id)
    batch = 4096 + 37
    states = _states(env, cuda, batch)
    d, a = env.obs_dim, env.action_dim
    for mode, warm, noise in MODES:
        weights = _actor(env, cuda, hidden, 2 * a if mode.startswith("sac") else a)
        consts = sac.collect_consts(env, torch.tensor(warm > 0.5, device=cuda), noise)
        args = (env_id, mode, states, 11, consts, pr.env_params_vec(env), *weights)
        before = op.collect_step.launches
        new_k, blk_k = op.collect_step(*args, compute_dtype=BF16)
        assert op.collect_step.launches == before + 1
        new_p, blk_p = op.collect_step_reference(*args, compute_dtype=BF16)
        torch.cuda.synchronize()
        bad = ~(torch.isclose(new_k, new_p, **TOL).all(0) & torch.isclose(blk_k, blk_p, **TOL).all(0))
        assert int(bad.sum()) <= 0.001 * batch, (mode, warm, int(bad.sum()))
        assert int(blk_p[2 * d + a + 1].sum()) > 0, "no env ended"
        assert float(blk_k[d:d + a].abs().max()) <= 1.0
        again = op.collect_step(*args, compute_dtype=BF16)
        assert torch.equal(new_k, again[0]) and torch.equal(blk_k, again[1])
        if mode in ("sac", "td3") and warm == 0.0:
            new_q, blk_q, counts = op.collect_step_bf16_probe(*args)
            assert torch.equal(new_q, new_k) and torch.equal(blk_q, blk_k)
            print(f"K7 bf16 {env_id} {hidden} {mode}: {int(bad.sum())} of {batch} envs apart; "
                  f"probe {counts}")
            assert counts["h1_missed"] == counts["h2_missed"] == 0, counts


def test_k7_refuses_widths_and_kinds_it_is_not_built_for(cuda):
    env = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    states = _states(env, cuda, 256)
    consts = sac.collect_consts(env, torch.tensor(False, device=cuda), 0.0)
    for hidden in (1025, (64, 1025)):
        with pytest.raises(ValueError, match="from 1 to 1024"):
            op.collect_step(env.name, "sac", states, 1, consts, pr.env_params_vec(env),
                            *_actor(env, cuda, hidden, 8))
    cfg = sac.SacConfig(hidden=(1025, 1025))
    assert "from 1 to 1024" in sac.collect_refusal(cfg, env, cuda)
    assert sac.choose_collect(cfg, env, cuda)[0] is False
    assert sac.choose_collect(cfg._replace(hidden=(512, 512)), env, cuda)[0] is True
    with pytest.raises(ValueError, match="states_t must be"):
        op.collect_step("quadrotor3d-v0", "sac", states, 1, consts, None,
                        *_actor(env, cuda, 64, 8))


WIDE = [(257, 257), (400, 300), (64, 1024), (1024, 64), (512, 512), (1024, 1024)]


def _wide_counts():
    return op._launch_wide.launches, op._launch_wide.launches_bf16, op._pack_wide.launches


@pytest.mark.parametrize("cd", [None, BF16])
@pytest.mark.parametrize("hidden", WIDE)
@pytest.mark.parametrize("env_id", list(pr.ENVS))
def test_k7_wide_matches_twin_in_every_mode(cuda, env_id, hidden, cd):
    """K7's wide instance (float32 and bf16) against its twin in every mode
    leg at ``chip_smoke.py --only collect``'s widths, as the narrow ones:
    at most 0.1% of envs apart, some envs ended, actions in [-1, 1], one
    wide launch counted (bf16: and one of the pack) and no narrow one,
    bitwise on a rerun; in bf16 the pack bitwise its twin, the probe's
    outputs the instance's and no miss."""
    env = reinmav_tpu_torch.make(env_id)
    batch = 4096 + 37
    states = _states(env, cuda, batch)
    d, a = env.obs_dim, env.action_dim
    for mode, warm, noise in MODES:
        weights = _actor(env, cuda, hidden, 2 * a if mode.startswith("sac") else a)
        consts = sac.collect_consts(env, torch.tensor(warm > 0.5, device=cuda), noise)
        args = (env_id, mode, states, 11, consts, pr.env_params_vec(env), *weights)
        before, narrow = _wide_counts(), op.collect_step.launches
        new_k, blk_k = op.collect_step(*args, compute_dtype=cd)
        after = _wide_counts()
        bf16 = int(cd == BF16)
        assert after == (before[0] + 1 - bf16, before[1] + bf16, before[2] + bf16)
        assert op.collect_step.launches == narrow
        if bf16 and mode == "sac" and warm == 0.0:
            assert torch.equal(op._pack_wide(weights), op.pack_reference(*weights[:5]))
        new_p, blk_p = op.collect_step_reference(*args, compute_dtype=cd)
        torch.cuda.synchronize()
        bad = ~(torch.isclose(new_k, new_p, **TOL).all(0) & torch.isclose(blk_k, blk_p, **TOL).all(0))
        assert int(bad.sum()) <= 0.001 * batch, (mode, warm, int(bad.sum()))
        assert int(blk_p[2 * d + a + 1].sum()) > 0, "no env ended"
        assert float(blk_k[d:d + a].abs().max()) <= 1.0
        again = op.collect_step(*args, compute_dtype=cd)
        assert torch.equal(new_k, again[0]) and torch.equal(blk_k, again[1])
        if cd == BF16 and mode in ("sac", "td3") and warm == 0.0:
            new_q, blk_q, counts = op.collect_step_bf16_probe(*args)
            assert torch.equal(new_q, new_k) and torch.equal(blk_q, blk_k)
            print(f"K7 wide bf16 {env_id} {hidden} {mode}: {int(bad.sum())} of {batch} envs "
                  f"apart; probe {counts}")
            assert counts["h1_missed"] == counts["h2_missed"] == 0, counts


@pytest.mark.parametrize("hidden", [(48, 80), (256, 256), 32, (1, 129)])
@pytest.mark.parametrize("env_id", list(pr.ENVS))
def test_k7_wide_forced_is_bitwise_the_narrow_instance(cuda, env_id, hidden):
    """The wide float32 instance, launched at widths the narrow one takes
    (through its private launch; collect_step takes the narrow one there),
    keeps its sums' order and so its bits, in every mode leg."""
    env = reinmav_tpu_torch.make(env_id)
    states = _states(env, cuda, 4096 + 37)
    a = env.action_dim
    for mode, warm, noise in MODES:
        weights = _actor(env, cuda, hidden, 2 * a if mode.startswith("sac") else a)
        consts = sac.collect_consts(env, torch.tensor(warm > 0.5, device=cuda), noise)
        args = (env_id, mode, states, 11, consts, pr.env_params_vec(env), *weights)
        params = op._check_args(*args[:6], weights)
        narrow = op.collect_step(*args)
        wide = op._launch_wide(*args[:5], params, weights, False)
        assert torch.equal(narrow[0], wide[0]) and torch.equal(narrow[1], wide[1]), mode


@pytest.mark.parametrize("alg,env_id,hidden,cd", [
    ("sac", "MujocoQuadForce-v1", (512, 512), None),
    ("sac", "MujocoQuadForce-v1", (1024, 1024), None),
    ("td3", "quadrotor3d-v0", (400, 300), None),
    ("sac", "MujocoQuadForce-v1", (1024, 1024), BF16)])
def test_wide_actor_launches_k7_once_per_iteration_and_learns_alike(cuda, alg, env_id, hidden, cd,
                                                                     caplog):
    """SAC at 512-512 and 1024-1024 and TD3 at 400-300 through train_iters with
    fused_collect "auto": K7's wide instance once an iteration (bf16: and
    its pack; the log names them), and 2 iterations from one state through
    K7 and eagerly within 10% in mean_reward."""
    env = reinmav_tpu_torch.make(env_id)
    module = sac if alg == "sac" else td3
    cls = sac.SacConfig if alg == "sac" else td3.Td3Config
    cfg = cls(num_envs=8192, batch_size=1024, buffer_capacity=1 << 16, hidden=hidden,
              warmup_steps=0, compute_dtype=cd or "float32")
    state = module.init_state(env, cfg, 0, device=cuda)
    before, narrow = _wide_counts(), op.collect_step.launches
    with caplog.at_level(logging.INFO, logger=f"reinmav_tpu_torch.rl.{alg}"):
        state, met = module.train_iters(env, cfg, state, 4)
    bf16 = int(cd == BF16)
    assert _wide_counts() == (before[0] + 4 * (1 - bf16), before[1] + 4 * bf16,
                              before[2] + 4 * bf16)
    assert op.collect_step.launches == narrow
    launches = "2 launches per iteration (the weights' pack, the body)" if bf16 else \
        "1 launch per iteration"
    assert f"K7 CUDA kernel (wide, H={hidden}), {launches}" in caplog.text
    assert all(math.isfinite(v) for v in met.values()) and met["q_loss"] > 0.0

    def fork(s):
        gen = torch.Generator()
        gen.set_state(s.generator.get_state())
        return s._replace(buffer=s.buffer.clone(), generator=gen)

    _, fused = module.train_iters(env, cfg, fork(state), 2)
    _, eager = module.train_iters(env, cfg._replace(fused_collect="off"), fork(state), 2)
    assert abs(fused["mean_reward"] - eager["mean_reward"]) <= 0.1 * abs(eager["mean_reward"])


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
