"""K7's plain twin (reinmav_tpu_torch.ops.offpolicy) against the JAX
package's fused collection kernel, and the off-policy training surface of
the port (dispatch, the CLI, checkpoints), on the CPU.

The JAX kernel ``collect_step_pallas`` runs as
tests/test_pallas_offpolicy.py runs it: ``pltpu.force_tpu_interpret_mode()``
in float32, on both kinds the port has (quadrotor3d-v0, MujocoQuadForce-v1),
with the same actor weights and start states on both sides.

- The ``_det`` modes (eps = 0, noise = 0): the obs and action rows at rtol
  1e-5, reward and next_obs at rtol 1e-5 / atol 1e-5, done equal, and the
  new states of the envs that did not end.
- The stochastic and warmup legs draw from Philox in the twin and from
  the TPU's on-core PRNG in the JAX kernel (a stub in interpret mode), so
  the streams are not compared: the twin's stored actions are stepped again
  through the JAX env step, which must reproduce its reward, next_obs and
  done rows.

The CLI runs with ``--device=cpu``: train with evaluation and a
checkpoint, a bitwise resume, then ``--play``.
"""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.ops import pallas_offpolicy, pallas_ppo_rollout
from reinmav_tpu.rl import sac as jsac
from reinmav_tpu_torch.ops import offpolicy
from reinmav_tpu_torch.ops import ppo_rollout as rollout_ops
from reinmav_tpu_torch.ops.rollout import reset_draws
from reinmav_tpu_torch.rl import run, sac, td3
from reinmav_tpu_torch.utils import checkpoint as ckpt

from jax.experimental.pallas import tpu as pltpu

BATCH, H = 256, 64
KINDS = ["quadrotor3d-v0", "MujocoQuadForce-v1"]
ROW_TOL = dict(rtol=1e-5, atol=1e-5)
#: The JAX actor init as one jitted program (eagerly, JAX compiles each
#: primitive apart: most of these tests' wall).
_MLP_INIT = jax.jit(jsac._mlp_init, static_argnums=1)


@functools.cache
def _jax_env_fns(env_id):
    """The JAX env's vreset and the re-step of :func:`_jax_restep`, each
    one jitted program, shared by the tests of a worker."""
    env = reinmav_tpu.make(env_id)

    def restep(states_t, a_t):
        out = jsac._autoreset_dense8(env, states_t, jsac._scale_action_t(env, a_t),
                                     jax.random.PRNGKey(5))
        return out.reward, out.obs, out.done

    return jax.jit(env.vreset), jax.jit(restep)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(env_id, head_kind="sac", key=0, hidden=(H, H)):
    """The JAX env and a perturbed actor of widths ``hidden`` (2 x 64;
    float32 layer lists), and start states (B, D) float32 of which some
    end in one step."""
    env = reinmav_tpu.make(env_id)
    d, a = env.obs_dim, env.action_dim
    head = 2 * a if head_kind == "sac" else a
    rng = np.random.default_rng(key)
    actor = _MLP_INIT(jax.random.PRNGKey(key), (d, *hidden, head))
    actor = [{k: np.asarray(v, np.float32) + np.float32(0.3) * rng.standard_normal(v.shape)
              .astype(np.float32) for k, v in layer.items()} for layer in actor]
    if env_id == "quadrotor3d-v0":
        # Twice a reset's spread, and the first 32 envs' positions twice
        # again: the envs past |p| = 3 end at once.
        vreset = _jax_env_fns(env_id)[0]
        states = np.asarray(vreset(jax.random.split(jax.random.PRNGKey(key + 1), BATCH))) * 2.0
        states[:32, :3] *= 2.0
    else:
        # Perturbed hover states; the first 32 just above the z = 0.3
        # floor and falling.
        states = np.zeros((BATCH, 13))
        states[:, 0:2] = rng.uniform(-0.3, 0.3, (BATCH, 2))
        states[:, 2] = rng.uniform(0.305, 1.0, BATCH)
        states[:, 3] = 1.0
        states[:, 7:13] = rng.uniform(-0.5, 0.5, (BATCH, 6))
        states[:32, 2], states[:32, 9] = 0.302, -1.0
    return env, actor, states.astype(np.float32)


def _jax_kernel(env, actor, states, mode):
    d, b = env.obs_dim, states.shape[0]
    consts = jsac._collect_consts(env, jnp.asarray(0.0, jnp.float32), 0.0)
    with pltpu.force_tpu_interpret_mode():
        new_rows, block_rows = pallas_offpolicy.collect_step_pallas(
            env.name, mode, jnp.asarray(states.T.reshape(8 * d, b // 8)),
            jnp.asarray([7], jnp.int32), consts, pallas_ppo_rollout.env_params_vec(env),
            *pallas_offpolicy.actor_kernel_args(actor), tile=jsac._collect_tile(b))
    r = 2 * d + env.action_dim + 2
    return np.asarray(new_rows).reshape(d, b), np.asarray(block_rows).reshape(r, b)


def _twin(env_id, actor, states, mode, warm=0.0, noise=0.0, seed=7):
    penv = reinmav_tpu_torch.make(env_id)
    weights = offpolicy.actor_kernel_args(
        [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in actor])
    consts = sac.collect_consts(penv, torch.tensor(warm > 0.5), noise)
    new, block = offpolicy.collect_step(env_id, mode, torch.from_numpy(states.T.copy()), seed,
                                        consts, rollout_ops.env_params_vec(penv), *weights)
    return new.numpy(), block.numpy()


def _jax_restep(env, states, a_t):
    """The JAX env step of ``states`` (B, D) under the policy-space actions
    ``a_t`` (A, B): the block's reward, next_obs and done rows."""
    reward, obs, done = _jax_env_fns(env.name)[1](jnp.asarray(states.T), jnp.asarray(a_t))
    return np.asarray(reward), np.asarray(obs), np.asarray(done)


def _assert_step_rows(block, ref, d, a, what):
    reward, nobs, done = ref
    np.testing.assert_allclose(block[d + a], reward, **ROW_TOL, err_msg=f"{what} reward")
    np.testing.assert_allclose(block[d + a + 1:2 * d + a + 1], nobs, **ROW_TOL,
                               err_msg=f"{what} next_obs")
    np.testing.assert_array_equal(block[2 * d + a + 1], done.astype(np.float32),
                                  err_msg=f"{what} done")


@pytest.mark.parametrize("env_id", KINDS)
@pytest.mark.parametrize("mode", ["sac_det", "td3_det"])
def test_det_modes_match_the_jax_kernel(env_id, mode):
    _assert_det_leg(env_id, mode, *_setup(env_id, mode[:3]))


@pytest.mark.parametrize("env_id,mode,hidden", [
    ("MujocoQuadForce-v1", "sac_det", (48, 80)),
    ("quadrotor3d-v0", "td3_det", (400, 300)),
    ("MujocoQuadForce-v1", "sac_det", (300, 520)),
])
def test_unequal_widths_match_the_jax_kernel(env_id, mode, hidden):
    """Two unequal widths in a deterministic leg: (48, 80), which the
    narrow instance takes; TD3's and DDPG's 400-300 actor and (300, 520),
    which only the wide instance takes on the card (each layer from 1 to
    1024)."""
    env, actor, states = _setup(env_id, mode[:3], key=5, hidden=hidden)
    head = 2 * env.action_dim if mode.startswith("sac") else env.action_dim
    assert [layer["w"].shape for layer in actor] == [(env.obs_dim, hidden[0]), hidden,
                                                     (hidden[1], head)]
    _assert_det_leg(env_id, mode, env, actor, states)


def _assert_det_leg(env_id, mode, env, actor, states):
    d, a = env.obs_dim, env.action_dim
    new_j, block_j = _jax_kernel(env, actor, states, mode)
    new_t, block_t = _twin(env_id, actor, states, mode)
    np.testing.assert_array_equal(block_t[:d], states.T)
    np.testing.assert_allclose(block_t[:d + a], block_j[:d + a], rtol=1e-5, atol=1e-6,
                               err_msg="obs/action rows")
    np.testing.assert_allclose(block_t[d + a:2 * d + a + 1], block_j[d + a:2 * d + a + 1],
                               **ROW_TOL, err_msg="reward/next_obs rows")
    np.testing.assert_array_equal(block_t[2 * d + a + 1], block_j[2 * d + a + 1])
    done = block_t[2 * d + a + 1] > 0.5
    assert 0 < done.sum() < BATCH // 2, done.sum()  # both sides of the comparison are live
    np.testing.assert_allclose(new_t[:, ~done], new_j[:, ~done], **ROW_TOL, err_msg="new states")
    # The done envs restart: quadrotor3d from K7's reset stream, hover at
    # its deterministic pose; the block keeps their TERMINAL next_obs.
    idx = torch.from_numpy(np.nonzero(done)[0])
    if env_id == "quadrotor3d-v0":
        np.testing.assert_array_equal(new_t[:, done], reset_draws(idx, 0, 7, 5).numpy())
    else:
        fresh = np.zeros(13, np.float32)
        fresh[2], fresh[3] = env.params.init_z, 1.0
        np.testing.assert_array_equal(new_t[:, done], np.repeat(fresh[:, None], done.sum(), 1))
    assert not np.array_equal(block_t[d + a + 1:2 * d + a + 1, done], new_t[:, done])


@pytest.mark.parametrize("env_id,mode,noise", [("quadrotor3d-v0", "sac", 0.0),
                                               ("MujocoQuadForce-v1", "td3", 0.3)])
def test_stochastic_leg_restepped_through_jax(env_id, mode, noise):
    env, actor, states = _setup(env_id, mode, key=3)
    d, a = env.obs_dim, env.action_dim
    _, block = _twin(env_id, actor, states, mode, noise=noise)
    _, det = _twin(env_id, actor, states, f"{mode}_det")
    stored = block[d:d + a]
    assert np.abs(stored).max() <= 1.0
    assert np.abs(stored - det[d:d + a]).mean() > 1e-2  # the noise reached the actions
    _assert_step_rows(block, _jax_restep(env, states, jnp.asarray(stored)), d, a, mode)
    _, again = _twin(env_id, actor, states, mode, noise=noise)
    np.testing.assert_array_equal(block, again)
    _, other = _twin(env_id, actor, states, mode, noise=noise, seed=8)
    assert not np.array_equal(block[d:d + a], other[d:d + a])


def test_warmup_leg_ignores_the_actor():
    env, actor, states = _setup("MujocoQuadForce-v1", "sac")
    _, actor2, _ = _setup("MujocoQuadForce-v1", "sac", key=42)
    d, a = env.obs_dim, env.action_dim
    _, block = _twin(env.name, actor, states, "sac", warm=1.0)
    _, block2 = _twin(env.name, actor2, states, "sac", warm=1.0)
    np.testing.assert_array_equal(block[d:d + a], block2[d:d + a])
    assert np.abs(block[d:d + a]).max() <= 1.0 and block[d:d + a].std() > 0.4
    _assert_step_rows(block, _jax_restep(env, states, jnp.asarray(block[d:d + a])), d, a, "warm")


def test_draws_are_standard():
    """K7's Philox normals and warmup uniforms, over 65,536 envs."""
    idx = torch.arange(65_536)
    eps = offpolicy._normal(idx, 11, 4)
    u = offpolicy._uniform_pm1(idx, 11, 4)
    assert abs(float(eps.mean())) < 0.01 and abs(float(eps.std()) - 1.0) < 0.01
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0 and abs(float(u.mean())) < 0.01
    assert abs(float(u.var()) - 1.0 / 3.0) < 0.01
    # Apart from the streams of K2's action noise (1) and resets (2).
    assert offpolicy._EPS_STREAM not in (1, 2) and offpolicy._WARM_STREAM not in (1, 2)


def test_dispatch_and_refusals():
    hover = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    cfg = sac.SacConfig()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for env in (hover, reinmav_tpu_torch.make("quadrotor3d-v0")):
        assert offpolicy.supported(env)
        assert sac.collect_refusal(cfg, env, cuda) is None
        assert sac.collect_refusal(cfg._replace(hidden=(64, 64)), env, cuda) is None
    assert sac.collect_refusal(cfg._replace(hidden=(48, 48)), hover, cuda) is None
    assert sac.collect_refusal(cfg._replace(hidden=(48, 80)), hover, cuda) is None
    assert sac.collect_refusal(cfg._replace(hidden=(512, 512)), hover, cuda) is None
    assert sac.collect_refusal(cfg._replace(hidden=(256, 257)), hover, cuda) is None
    assert sac.collect_refusal(cfg._replace(hidden=(1024, 1024)), hover, cuda) is None
    assert "from 1 to 1024" in sac.collect_refusal(cfg._replace(hidden=(1025, 64)), hover, cuda)
    assert "from 1 to 1024" in sac.collect_refusal(cfg._replace(hidden=(64, 1025)), hover, cuda)
    assert sac.collect_refusal(cfg._replace(hidden=(48, 48)), hover, cpu) is None
    assert sac.collect_refusal(cfg._replace(hidden=(64, 32)), hover, cpu) is None
    assert sac.collect_refusal(cfg._replace(hidden=(512, 512)), hover, cpu) is None
    assert sac.collect_refusal(cfg._replace(hidden=(1025, 64)), hover, cpu) is None
    # The instance by width: narrow while both layers are at most 256.
    assert [offpolicy.kernel_instance(h) for h in ((256, 256), (1, 256), (256, 257), (257, 1),
                                                   (400, 300), (1024, 1024), (1025, 8))] == [
        "narrow", "narrow", "wide", "wide", "wide", "wide", None]
    assert [offpolicy.tie_scale(h) for h in (64, 256, 512, 1024)] == [1.0, 1.0, 2.0, 4.0]
    for hidden, named in (((256, 256), ""), ((512, 512), " (wide, H=(512, 512))"),
                          ((400, 300), " (wide, H=(400, 300))")):
        assert sac.collect_path(cfg._replace(hidden=hidden), True, "CUDA kernel", cuda) == (
            f"K7 CUDA kernel{named}, 1 launch per iteration")
    assert sac.collect_path(cfg._replace(hidden=(512, 512)), True, "plain twin", cpu) == (
        "K7 plain twin, 1 launch per iteration")
    # The wide bf16 instance packs the weights in a launch of its own first.
    for hidden, launches in (((256, 256), "1 launch"), ((512, 512), "2 launches")):
        path = sac.collect_path(cfg._replace(hidden=hidden, compute_dtype="bfloat16"), True,
                                "CUDA kernel", cuda)
        assert path.startswith("K7 CUDA kernel") and f", {launches} per iteration" in path
    assert "is not two layers" in sac.collect_refusal(cfg._replace(hidden=(64,) * 3), hover, cuda)
    assert "no K7" in sac.collect_refusal(cfg, reinmav_tpu_torch.make("MujocoQuadForce-v0"), cuda)
    wrapped = dataclasses.replace(hover, step_fn=lambda s, a, p: hover.step_fn(s, a, p))
    assert "wrapped or replaced" in sac.collect_refusal(cfg, wrapped, cuda)
    from reinmav_tpu_torch.envs import tpuquad
    assert "frame_skip" in sac.collect_refusal(
        cfg, tpuquad.make_hovering(tpuquad.Params(init_z=1.0, frame_skip=3)), cuda)

    assert sac.choose_collect(cfg, hover, cuda) == (True, "CUDA kernel")
    use, how = sac.choose_collect(cfg, wrapped, cuda)
    assert not use and "wrapped" in how
    with pytest.raises(ValueError, match="fused_collect refused: .*wrapped"):
        sac.choose_collect(cfg._replace(fused_collect="on"), wrapped, cuda)
    assert sac.choose_collect(cfg, hover, cpu)[0] is False
    assert sac.choose_collect(cfg._replace(fused_collect="on"), hover, cpu) == (
        True, "plain twin (tensors on cpu)")
    assert sac.choose_collect(cfg._replace(fused_collect="off"), hover, cuda)[0] is False
    with pytest.raises(ValueError, match="'auto', 'on' or 'off'"):
        sac.choose_collect(cfg._replace(fused_collect="yes"), hover, cuda)


def test_collect_step_checks_its_arguments():
    env, actor, states = _setup("quadrotor3d-v0", "td3")
    weights = offpolicy.actor_kernel_args(
        [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in actor])
    st = torch.from_numpy(states.T.copy())
    consts = sac.collect_consts(reinmav_tpu_torch.make("quadrotor3d-v0"), torch.tensor(False), 0.1)
    call = lambda *a, **kw: offpolicy.collect_step(*a, **kw)  # noqa: E731
    with pytest.raises(ValueError, match="mode"):
        call("quadrotor3d-v0", "ppo", st, 1, consts, None, *weights)
    with pytest.raises(ValueError, match="w3 must be"):
        call("quadrotor3d-v0", "sac", st, 1, consts, None, *weights)  # a TD3 head
    with pytest.raises(ValueError, match="env_kind"):
        call("reinmav-v0", "td3", st, 1, consts, None, *weights)
    with pytest.raises(ValueError, match="states_t must be"):
        call("MujocoQuadForce-v1", "td3", st, 1, consts, None, *weights)
    with pytest.raises(TypeError, match="float32"):
        call("quadrotor3d-v0", "td3", st.double(), 1, consts, None, *weights)
    with pytest.raises(ValueError, match="seed"):
        call("quadrotor3d-v0", "td3", st, -1, consts, None, *weights)
    with pytest.raises(ValueError, match="2-hidden-layer"):
        offpolicy.actor_kernel_args([{"w": weights[0], "b": weights[1]}])
    new, block = call("quadrotor3d-v0", "td3", st, 1, consts, None, *weights)
    assert new.shape == (10, BATCH) and block.shape == (2 * 10 + 4 + 2, BATCH)


def test_wide_pack_twin_lays_out_what_the_body_reads():
    """pack_reference, the twin of K7 wide bf16's pack kernel: W1ᵀ, W2,
    W2ᵀ in bf16, W3ᵀ rounded to bf16 and the biases, at the padded widths
    (128 / 64 / 128), zero past the widths, back to back."""
    g = torch.Generator().manual_seed(20)
    d, h1, h2, out = 13, 300, 520, 8
    w1, b1, w2, b2, w3 = (torch.randn(shape, generator=g) for shape in
                          ((d, h1), (h1,), (h1, h2), (h2,), (h2, out)))
    got = offpolicy.pack_reference(w1, b1, w2, b2, w3)
    k1p, k2, n2p = 384, 320, 640
    sizes = (2 * k1p * 16, 2 * k2 * n2p, 2 * n2p * k2, 4 * out * n2p, 4 * k1p, 4 * n2p)
    assert got.dtype == torch.uint8 and got.shape == (sum(sizes),)
    parts = torch.split(got, sizes)
    w1t = parts[0].view(torch.bfloat16).reshape(k1p, 16)
    w2p = parts[1].view(torch.bfloat16).reshape(k2, n2p)
    w2t = parts[2].view(torch.bfloat16).reshape(n2p, k2)
    w3t, b1p, b2p = (p.view(torch.float32) for p in parts[3:])
    assert torch.equal(w1t[:h1, :d], w1.T.to(torch.bfloat16))
    assert torch.equal(w2p[:h1, :h2], w2.to(torch.bfloat16)) and torch.equal(w2t, w2p.T)
    assert torch.equal(w3t.reshape(out, n2p)[:, :h2], w3.T.to(torch.bfloat16).float())
    assert torch.equal(b1p[:h1], b1) and torch.equal(b2p[:h2], b2)
    for pad in (w1t[h1:], w1t[:, d:], w2p[h1:], w2p[:, h2:], w3t.reshape(out, n2p)[:, h2:],
                b1p[h1:], b2p[h2:]):
        assert not pad.float().any()


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _leaves(tree):
    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if isinstance(tree, tuple):
        return [leaf for field in tree for leaf in _leaves(field)]
    return [tree]


@pytest.mark.parametrize("alg,env_id", [("sac", "MujocoQuadForce-v1"), ("td3", "quadrotor3d-v0"),
                                        ("ddpg", "MujocoQuadForce-v1")])
def test_cli_trains_resumes_bitwise_and_plays(alg, env_id, tmp_path, capsys):
    """4 calls of 2 iterations with an evaluation every 2 calls and a
    checkpoint; 2 calls, a checkpoint, and 2 more from it, bitwise the same
    state; then --play from the checkpoint."""
    small = ["--device=cpu", f"--alg={alg}", f"--env={env_id}", "--num_env=64", "--batch_size=64",
             "--buffer_capacity=1024", "--warmup_steps=256", "--num_hidden=32",
             "--updates_per_jit=2", "--log_interval=1"]
    ck, half, resumed = (str(tmp_path / n) for n in ("ck", "half", "resumed"))
    run.main([*small, "--num_timesteps=512", f"--save_path={ck}", "--eval_interval=2",
              "--eval_envs=8", "--eval_horizon=10"])
    lines = _lines(capsys.readouterr().out)
    train = [row for row in lines if "env_steps" in row]
    assert [row["env_steps"] for row in train] == [128.0, 256.0, 384.0, 512.0]
    assert all(math.isfinite(v) for row in train for v in row.values())
    assert train[0]["q_loss"] == 0.0 and train[-1]["q_loss"] > 0.0  # gated, then open
    assert train[-1]["buffer_filled"] == (448.0 + 512.0) / 2  # the call's two iterations
    evals = [row for row in lines if "eval_survival_frac" in row]
    assert len(evals) == 2 and all(0.0 <= row["eval_survival_frac"] <= 1.0 for row in evals)

    run.main([*small, "--num_timesteps=256", f"--save_path={half}"])
    run.main([*small, "--num_timesteps=256", f"--load_path={half}", f"--save_path={resumed}"])
    capsys.readouterr()
    module, cfg = run.offpolicy_config(run.build_parser().parse_args(small))
    target = module.init_state(reinmav_tpu_torch.make(env_id), cfg, 9, device="cpu")
    a, b = _leaves(ckpt.restore(ck, target)), _leaves(ckpt.restore(resumed, target))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.dtype == y.dtype and torch.equal(x, y)) if isinstance(x, torch.Tensor) else x == y

    run.main([*small, "--play", f"--load_path={ck}", "--play_steps=20"])
    (played,) = _lines(capsys.readouterr().out)
    assert played["play_steps"] == 20 and math.isfinite(played["total_reward"])


def test_checkpoints_keep_the_critic_count(tmp_path):
    """A DDPG state has one critic: its checkpoint does not restore into a
    TD3 state, and a TD3 one restores into a TD3 state of another seed."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = td3.Td3Config(num_envs=16, batch_size=16, buffer_capacity=64, hidden=(8, 8))
    ddpg = cfg._replace(single_critic=True, policy_noise=0.0, noise_clip=0.0, policy_delay=1)
    ckpt.save(str(tmp_path / "ddpg"), td3.init_state(env, ddpg, 0, device="cpu"))
    with pytest.raises(ckpt.CheckpointStructureError, match="critics"):
        ckpt.restore(str(tmp_path / "ddpg"), td3.init_state(env, cfg, 0, device="cpu"))
    state = td3.init_state(env, cfg, 0, device="cpu")
    ckpt.save(str(tmp_path / "td3"), state)
    back = ckpt.restore(str(tmp_path / "td3"), td3.init_state(env, cfg, 1, device="cpu"))
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(_leaves(state), _leaves(back)))
