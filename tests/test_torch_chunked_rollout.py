"""The port's chunked_throughput_rollout on the CPU (the eager backend).

The chunked call carries the states, the reward sums and the generator
from chunk to chunk, so with the same generator it is BIT FOR BIT the
unchunked throughput_rollout: a budget of 1e-9 s forces chunks of one
step after the probes, over a horizon that is no multiple of them.  The
slung-load envs are included: unlike the JAX package's recompiled scans,
the eager loop computes each step alike in any chunking.  A generous
budget makes one chunk after the two probes; the argument errors and
the refusal during CUDA graph capture are checked.
"""

import logging

import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu_torch.envs import core


@pytest.mark.parametrize("env_id", ["quadrotor3d-v0", "quadrotor2d-v0",
                                    "quadrotor3d-slungload-v0", "MujocoQuadForce-v1",
                                    "reinmav-v0"])
def test_chunked_equals_unchunked_bitwise(env_id, caplog):
    env = reinmav_tpu_torch.make(env_id)
    states = env.vreset(torch.Generator().manual_seed(2), 32, dtype=torch.float64)
    horizon = 25
    f_ref, r_ref = reinmav_tpu_torch.throughput_rollout(
        env, states, torch.Generator().manual_seed(5), horizon, backend="scan")
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        f, r = reinmav_tpu_torch.chunked_throughput_rollout(
            env, states, torch.Generator().manual_seed(5), horizon,
            device_time_budget_s=1e-9, probe_steps=4)
    assert "eager loop (states on cpu" in caplog.text
    assert f"19 chunks of [4, 4, {', '.join(['1'] * 17)}] steps" in caplog.text
    assert torch.equal(f, f_ref) and torch.equal(r, r_ref)
    assert f.dtype == torch.float64 and bool(torch.isfinite(r).all())


def test_one_chunk_after_the_probes_when_the_budget_allows(caplog):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    states = env.vreset(torch.Generator().manual_seed(3), 16)
    f_ref, r_ref = reinmav_tpu_torch.throughput_rollout(env, states,
                                                        torch.Generator().manual_seed(1), 40)
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        f, r = reinmav_tpu_torch.chunked_throughput_rollout(
            env, states, torch.Generator().manual_seed(1), 40, backend="scan",
            device_time_budget_s=1e6)
    assert "3 chunks of [8, 8, 24] steps" in caplog.text
    assert torch.equal(f, f_ref) and torch.equal(r, r_ref)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        reinmav_tpu_torch.chunked_throughput_rollout(env, states, torch.Generator(), 5)
    assert "1 chunks of [5] steps" in caplog.text


def test_argument_errors_and_the_capture_refusal(monkeypatch):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    states = env.vreset(torch.Generator(), 4)
    chunked = reinmav_tpu_torch.chunked_throughput_rollout
    with pytest.raises(ValueError, match="horizon must be positive"):
        chunked(env, states, torch.Generator(), 0)
    with pytest.raises(ValueError, match="probe_steps must be positive"):
        chunked(env, states, torch.Generator(), 8, probe_steps=0)
    with pytest.raises(ValueError, match="unknown backend"):
        chunked(env, states, torch.Generator(), 8, backend="pallas")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        chunked(env, states, torch.Generator(), 8, backend="kernel")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(ValueError, match="CUDA graph capture"):
        chunked(env, states, torch.Generator(), 8)
    assert core.chunked_throughput_rollout is chunked
