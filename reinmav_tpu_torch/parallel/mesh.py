"""The 1-D mesh of a multi-rank run: the env batch split over the ranks.

The counterpart of :mod:`reinmav_tpu.parallel.mesh`.  There a
``jax.sharding.Mesh`` spans the devices and XLA places the shards; here
each rank is a process holding its own shard of the env batch, and
:class:`Mesh` stands in for the mesh: the process group, the world size,
the rank and its device, with the few collectives the learners use.

The collectives are the ones every backend takes on every device, so
that the CPU, gloo on a card and NCCL round alike: SUM all-reduces (an
average is the SUM followed by one division by the world size; gloo has
no ``ReduceOp.AVG``), broadcasts, and gathers (on gloo a CUDA tensor is
gathered through a host copy, since gloo's ``all_gather`` takes CPU
tensors only).  A mesh with no group (one process, no ``torchrun``)
makes each of them the identity, so the sharded paths run unchanged at
world size 1; :data:`COLLECTIVES` counts the calls made on a group.

Do not port: the TPU's ``(D, 8, B/8)`` dense view of ``sharded_dense_rollout``
(ROADMAP.md, Layouts): :func:`sharded_dense_rollout` runs the closed-loop
kernel on the rank's ``(B_local, D)`` shard.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import distributed

BATCH_AXIS = "env_batch"

#: Collective calls made on a group, by kind (``all_reduce``,
#: ``all_gather``, ``broadcast``, ``barrier``); a run may set them to 0.
COLLECTIVES = collections.Counter()

#: The fields of the learners' states that hold a rank's shard, and the
#: axis their env (or replay column) index runs along: PPO's env states
#: and running returns, the off-policy env states, ``ever_done`` and
#: replay ring.  Every other field is replicated (the JAX package's
#: ``state_shardings`` / ``_shard_specs``).
SHARDED_FIELDS = {"env_states": 0, "env_returns": 0, "ever_done": 0, "buffer": 1}


def fold_in(seed: int, index: int) -> int:
    """A seed for stream ``index`` of ``seed`` (the counterpart of
    ``jax.random.fold_in``): 31 bits of NumPy's ``SeedSequence([seed,
    index])``, so every rank draws its own stream from a replicated seed."""
    word = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint32)[0]
    return int(word) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``world_size`` ranks over the env batch: the process
    group (None for one process with no group), this process's rank and
    device, and the backend."""

    group: Optional[object]
    world_size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    axis_name: str = BATCH_AXIS

    def shard(self, batch: int) -> slice:
        """The rows of a ``batch``-row global batch that this rank holds;
        raises when the batch does not divide by the world size."""
        if batch % self.world_size != 0:
            raise ValueError(f"batch {batch} not divisible by mesh size {self.world_size}")
        n = batch // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the ranks (a new tensor)."""
        out = t.detach().clone().contiguous()
        if self.group is not None:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
            COLLECTIVES["all_reduce"] += 1
        return out

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise mean of ``t`` over the ranks: the SUM, then one
        division by the world size."""
        out = self.all_reduce_sum(t)
        return out / self.world_size if self.world_size > 1 else out

    def mean_dict(self, metrics: dict) -> dict:
        """Each 0-d tensor of ``metrics`` averaged over the ranks, in one
        all-reduce."""
        names = list(metrics)
        if not names:
            return {}
        vec = self.all_reduce_mean(torch.stack([metrics[k].reshape(()).to(torch.float64)
                                                for k in names]))
        return {k: v.to(metrics[k].dtype) for k, v in zip(names, vec.unbind(0))}

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        if self.group is None:
            return t
        src = t.contiguous()
        if src.dtype == torch.bool:
            return self.all_gather(src.to(torch.uint8), dim).to(torch.bool)
        host = self.backend == "gloo" and src.is_cuda
        if host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src, group=self.group)
        COLLECTIVES["all_gather"] += 1
        out = torch.cat(parts, dim=dim)
        return out.to(t.device) if host else out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (a new tensor)."""
        out = t.detach().clone().contiguous()
        if self.group is not None:
            dist.broadcast(out, src=src, group=self.group)
            COLLECTIVES["broadcast"] += 1
        return out

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)
            COLLECTIVES["barrier"] += 1


def make_mesh(device=None, axis_name: str = BATCH_AXIS) -> Mesh:
    """The 1-D mesh of this run: after :func:`.distributed.init` formed a
    group, the whole group with the device ``init`` gave this rank; else
    one rank on ``device`` ("cuda" by default) with no group."""
    if dist.is_initialized():
        return Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(),
                    distributed.device(), dist.get_backend(), axis_name)
    return Mesh(None, 1, 0, torch.device("cuda" if device is None else device), None, axis_name)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """The rows of a ``(batch, ...)`` array this rank holds (the
    counterpart of the JAX package's batch ``NamedSharding``)."""
    return mesh.shard(batch)


def replicated(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as rank 0 holds it, on every rank, on the mesh's device."""
    return mesh.broadcast(t.to(mesh.device))


def shard_batch(mesh: Mesh, tree):
    """Each ``(B, ...)`` tensor of a tensor, tuple or dict ``tree`` cut to
    this rank's rows, on the mesh's device."""
    if isinstance(tree, torch.Tensor):
        return tree[mesh.shard(tree.shape[0])].to(mesh.device).clone()
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [shard_batch(mesh, v) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def shard_state(mesh: Mesh, state):
    """A learner's global state (PPO's ``TrainState``, ``SacState``,
    ``Td3State``) cut to this rank's shard: the :data:`SHARDED_FIELDS`
    along their axis, the rest as it is (replicated).  Every rank builds
    the same global state from the same seed and keeps its rows, so rank
    ``r`` holds envs ``r * B / N`` onwards of the one-rank run's."""
    cut = {}
    for name, axis in SHARDED_FIELDS.items():
        if name in state._fields:
            x = getattr(state, name)
            idx = mesh.shard(x.shape[axis])
            cut[name] = (x[idx] if axis == 0 else x[:, idx]).clone()
    return state._replace(**cut)


def sharded_control_rollout(env, mesh: Mesh, batch: int, horizon: int, generator,
                            auto_reset: bool = True):
    """A closed-loop controller rollout with the env batch split over the
    ranks.  Returns ``(run, init_states)``: ``init_states`` this rank's
    rows of ``env.vreset(generator, batch)`` (the one-rank run's states),
    and ``run(states, seed) -> (final states (B_local, D), done count
    over every rank)``: the eager rollout of the rank's shard with resets
    from a stream of ``seed`` folded with the rank.  The rollout itself
    makes no collective; only the done count is all-reduced."""
    from ..envs.core import control_rollout

    rows = mesh.shard(batch)
    init_states = env.vreset(generator, batch)[rows].to(mesh.device).clone()

    def run(states, seed: int):
        gen = torch.Generator(device=states.device).manual_seed(fold_in(seed, mesh.rank))
        final, traj = control_rollout(env, states, gen, horizon, auto_reset=auto_reset,
                                      collect_trajectory=False)
        return final, mesh.all_reduce_sum(traj.done.sum().to(torch.int64))

    return run, init_states


def sharded_dense_rollout(env, mesh: Mesh, states, seed: int, horizon: int, backend="auto"):
    """The throughput rollout of this rank's ``(B_local, D)`` shard, K1 (or
    the env's closed-loop kernel) on the card, its reset stream seeded with
    ``seed`` folded with the rank: deterministic per (seed, world size),
    not equal to a one-rank run, as the JAX package's.  Returns ``(final
    states (B_local, D), reward sums (B_local,))``."""
    from ..envs.core import throughput_rollout

    gen = torch.Generator(device=states.device).manual_seed(fold_in(seed, mesh.rank))
    return throughput_rollout(env, states, gen, horizon, backend=backend)
