"""The modules around the learners on the card: chunked_throughput_rollout
launching K1 once a chunk, the GRU learner against the CPU's float64, the
two controllers against the CPU, and the gymnasium adapters' default
device.  Every test needs a CUDA device (chunking also the ``nvcc`` that
builds K1) and skips without one.

This file imports no JAX, so that it runs where only PyTorch is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_modules.py

Tolerances: the GRU collection in float32 against float64 from the same
draws, rtol 1e-3 / atol 1e-4 on every observation; the controllers'
actions rtol 1e-4 / atol 1e-5 (float32 against float64 on one call, at
attitudes within 60 degrees of level).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.controllers import geometric, rpy_pid
from reinmav_tpu_torch.ops import rollout as ro
from reinmav_tpu_torch.rl import recurrent

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_chunked_launches_k1_once_a_chunk(cuda, caplog):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    gen = torch.Generator(device=cuda).manual_seed(0)
    states = env.vreset(gen, 65_536)
    before = ro.quad3d_rollout_autoreset.launches
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        final, rew = reinmav_tpu_torch.chunked_throughput_rollout(
            env, states, gen, 100, device_time_budget_s=1e-9, probe_steps=4)
    (line,) = [r.getMessage() for r in caplog.records if " chunks of " in r.getMessage()]
    chunks = int(line.split("): ")[1].split(" chunks")[0])
    assert chunks == 2 + 92 and ro.quad3d_rollout_autoreset.launches == before + chunks
    assert final.shape == (65_536, 10) and bool(torch.isfinite(rew).all())
    small = states[:512]
    f_ref, r_ref = reinmav_tpu_torch.throughput_rollout(
        env, small, torch.Generator(device=cuda).manual_seed(3), 20, backend="scan")
    f, r = reinmav_tpu_torch.chunked_throughput_rollout(
        env, small, torch.Generator(device=cuda).manual_seed(3), 20, backend="scan",
        device_time_budget_s=1e-9, probe_steps=4)
    assert torch.equal(f, f_ref) and torch.equal(r, r_ref)


def test_gru_collection_on_the_card_is_the_cpus(cuda):
    env = reinmav_tpu_torch.make("quadrotor2d-v0")
    cfg = recurrent.RecurrentPpoConfig(num_envs=256, rollout_len=32, hidden=32, embed=32)
    cpu = recurrent.init_train_state(env, cfg, 1, device="cpu", dtype=torch.float64)
    card = cpu._replace(
        params=cpu.params.to(cuda, torch.float32),
        opt_state=cpu.opt_state._replace(count=cpu.opt_state.count.to(cuda),
                                         mu=cpu.opt_state.mu.to(cuda, torch.float32),
                                         nu=cpu.opt_state.nu.to(cuda, torch.float32)),
        env_states=cpu.env_states.to(cuda, torch.float32), h=cpu.h.to(cuda, torch.float32),
        prev_done=cpu.prev_done.to(cuda, torch.float32))
    gen = torch.Generator().manual_seed(2)
    noise = torch.randn((32, env.action_dim, 256), generator=gen, dtype=torch.float64)
    resets = [env.vreset(gen, 256, dtype=torch.float64) for _ in range(32)]

    def replayed():
        pending = iter(resets)
        return dataclasses.replace(env, reset_fn=lambda p, g, b, device, dtype: next(
            pending).to(device=device, dtype=dtype))

    layout = recurrent.GruLayout.of(env, cfg)
    trajs = [recurrent.collect(replayed(), cfg, layout.unflatten(s.params), s,
                               torch.Generator(device=s.params.device), noise)[1]
             for s in (cpu, card)]
    np.testing.assert_allclose(trajs[1].obs.double().cpu().numpy(), trajs[0].obs.numpy(),
                               rtol=1e-3, atol=1e-4)
    new, metrics = recurrent.train_step(env, cfg, card)
    assert new.params.device.type == "cuda" and new.update_step == 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_controllers_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(5)
    pos, vel, ref = (rng.uniform(-1, 1, (1024, 3)) for _ in range(3))
    # Attitudes within 60 degrees of level: near +-90 degrees the Euler
    # angles' asin and the feed-forward's 1 / (cos(phi) cos(theta)) turn
    # float32 rounding into errors of order 1e-3.
    axis = rng.normal(size=(1024, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = rng.uniform(0.0, np.pi / 6, (1024, 1))
    quat = np.concatenate([np.cos(half), np.sin(half) * axis], axis=1)
    t64 = lambda x: torch.from_numpy(x)  # noqa: E731
    t32 = lambda x: torch.from_numpy(x).to(cuda, torch.float32)  # noqa: E731
    for t in (t64, t32):
        a = geometric.control(geometric.Gains(), t(pos), t(quat), t(vel), t(ref))
        f, _ = rpy_pid.control(rpy_pid.Gains(), rpy_pid.init_carry(a.dtype, a.device, (1024,)),
                               t(pos), t(quat), t(ref), 0.3, 0.01, 0.3)
        if t is t64:
            a_ref, f_ref = a, f
    np.testing.assert_allclose(a.double().cpu().numpy(), a_ref.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f.double().cpu().numpy(), f_ref.numpy(), rtol=1e-4, atol=1e-5)


def test_gym_adapters_default_to_the_card(cuda):
    pytest.importorskip("gymnasium")
    from reinmav_tpu_torch.compat import gym_env, vector_env

    e = gym_env.make("quadrotor3d-v0")
    assert e.device.type == "cuda"
    e.reset(seed=0)
    obs, reward, term, trunc, _ = e.step(e.control())
    assert e._state.is_cuda and np.isfinite(obs).all()
    v = vector_env.make_vec("quadrotor3d-v0", 1024)
    v.reset(seed=0)
    obs, rew, term, trunc, infos = v.step(np.zeros((1024, 4), np.float32))
    assert v._states.is_cuda and obs.shape == (1024, 10) and rew.dtype == np.float64
