"""Process groups and process roles for multi-rank runs, on
``torch.distributed``.

The counterpart of :mod:`reinmav_tpu.parallel.distributed`
(``jax.distributed.initialize`` there).  One process per rank, each on a
device of its own or sharing one card; :func:`init` forms the group,
:mod:`.mesh` wraps it as the 1-D mesh the learners take.

Usage, the same script on every rank::

    from reinmav_tpu_torch.parallel import distributed, make_mesh
    distributed.init()              # a no-op outside torchrun
    mesh = make_mesh()              # the rank's group, rank and device
    ...

launched as ``torchrun --nproc_per_node=N script.py`` (or ``python -m
torch.distributed.run``), or with the explicit arguments of :func:`init`.

The backend is chosen explicitly and logged: NCCL when every rank of the
host has a card of its own (``torch.cuda.set_device(local_rank)``); gloo
on the CPU, and when the ranks share a card (NCCL refuses two ranks on
one device; gloo all-reduces CUDA tensors through the host).  A failed
initialisation raises; nothing falls back to another backend or device.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

#: What torchrun sets for every rank; auto-detect mode reads these.
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_device: Optional[torch.device] = None


def _choose_backend(device, local_rank: int, local_world: int):
    """``(backend, the rank's device)`` for ranks of ``device``'s type."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo", dev, "ranks on the CPU"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch.cuda.is_available() is False")
    cards = torch.cuda.device_count()
    if local_world <= cards:
        torch.cuda.set_device(local_rank)
        return "nccl", torch.device("cuda", local_rank), f"each rank a card of its own ({cards})"
    return ("gloo", torch.device("cuda", 0),
            f"{local_world} ranks share {cards} card(s): NCCL takes one rank a device, gloo "
            "all-reduces CUDA tensors through the host")


def _start(init_method: str, world_size: int, rank: int, local_rank: int, local_world: int,
           device) -> None:
    global _device
    backend, dev, why = _choose_backend(device, local_rank, local_world)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    _device = dev
    log.info("distributed.init: rank %d of %d, backend %s on %s (%s)", rank, world_size,
             backend, dev, why)


def init(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
         process_id: Optional[int] = None, device="cuda") -> None:
    """Form the process group of a multi-rank run.

    * **Explicit** (any of the three arguments given): this process was
      launched as one rank of ``num_processes`` on one host, the group
      meeting at ``coordinator_address`` ("host:port").  A missing or
      out-of-range argument and any initialisation failure RAISE: a rank
      that trained alone would see 1/N of the data while looking healthy.
      ``num_processes=1`` is a deliberate one-process run: no group.
    * **Auto-detect** (no arguments): torchrun's environment (``RANK``,
      ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` and
      ``LOCAL_WORLD_SIZE`` where set); a no-op when none of them is set,
      an error when only some are.

    Idempotent: a second call is a no-op, unless its explicit arguments
    conflict with the live group, which raises ``RuntimeError``.
    ``device``: "cuda" (NCCL when the host has a card a rank, else gloo)
    or "cpu" (gloo).
    """
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if dist.is_initialized():
        if num_processes is not None and num_processes != dist.get_world_size():
            raise RuntimeError(f"distributed.init(num_processes={num_processes}) after the group "
                               f"was formed with {dist.get_world_size()} ranks")
        if process_id is not None and process_id != dist.get_rank():
            raise RuntimeError(f"distributed.init(process_id={process_id}) after the group was "
                               f"formed as rank {dist.get_rank()}")
        return
    if explicit:
        if num_processes == 1 and process_id in (None, 0):
            return  # deliberate one-process run
        missing = [n for n, v in (("coordinator_address", coordinator_address),
                                  ("num_processes", num_processes),
                                  ("process_id", process_id)) if v is None]
        if missing:
            raise ValueError(f"distributed.init: explicit mode needs {', '.join(missing)} too")
        if not (isinstance(num_processes, int) and num_processes >= 1):
            raise ValueError(f"num_processes must be a positive int, got {num_processes!r}")
        if not (isinstance(process_id, int) and 0 <= process_id < num_processes):
            raise ValueError(f"process_id {process_id!r} is not a rank of {num_processes}")
        _start(f"tcp://{coordinator_address}", num_processes, process_id, process_id,
               num_processes, device)
        return
    present = [v for v in TORCHRUN_VARS if v in os.environ]
    if not present:
        return  # a plain one-process run
    if len(present) != len(TORCHRUN_VARS):
        missing = sorted(set(TORCHRUN_VARS) - set(present))
        raise ValueError(f"distributed.init: {', '.join(present)} set but not {', '.join(missing)}")
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    _start("env://", world, rank, int(os.environ.get("LOCAL_RANK", rank)),
           int(os.environ.get("LOCAL_WORLD_SIZE", world)), device)


def device() -> Optional[torch.device]:
    """The device :func:`init` gave this rank (None before a group)."""
    return _device if dist.is_initialized() else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank-0 gating (the reference's MPI rank-0 check, ``run.py:177-182``)."""
    return rank() == 0


def host_local_batch_size(global_batch: int) -> int:
    """This rank's share of a global batch; raises ``ValueError`` when it
    does not divide by the world size."""
    n = world_size()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def global_batch_array(mesh, host_local) -> torch.Tensor:
    """This rank's ``(B_local, ...)`` data as the rank's shard of the global
    batch, on the mesh's device.  There is no global array object in
    torch: each rank holds its own rows, rank ``r`` the rows ``r *
    B_local`` onwards of the batch (:meth:`.mesh.Mesh.shard`)."""
    return torch.as_tensor(host_local, device=mesh.device)
