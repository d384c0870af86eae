"""reinmav_tpu_torch — the PyTorch + CUDA port of :mod:`reinmav_tpu`.

Plain functions on tensors, an explicit ``device`` and explicit
``torch.Generator``\\ s; the hot loop runs in kernels written by hand
for NVIDIA Hopper (``csrc/``), built with ``nvcc`` at first use.  The
JAX package stays the reference the port is tested against.

Quick start::

    import torch, reinmav_tpu_torch
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    gen = torch.Generator(device="cuda").manual_seed(0)
    states = env.vreset(gen, 4096)
    final, traj = reinmav_tpu_torch.control_rollout(env, states, gen, horizon=400)
    final, rew = reinmav_tpu_torch.chunked_throughput_rollout(env, states, gen, horizon=100_000)
"""

from .envs.core import (EnvDef, StepOut, chunked_throughput_rollout, control_rollout,
                        controller_policy, rollout, throughput_rollout)
from .envs.registry import make, register, registered_ids

__version__ = "0.1.0"

__all__ = [
    "EnvDef",
    "StepOut",
    "make",
    "register",
    "registered_ids",
    "rollout",
    "control_rollout",
    "controller_policy",
    "throughput_rollout",
    "chunked_throughput_rollout",
    "__version__",
]
