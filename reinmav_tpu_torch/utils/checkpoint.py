"""Checkpoint / resume of a whole training state with ``torch.save``.

The counterpart of :mod:`reinmav_tpu.utils.checkpoint` (orbax there).
The whole training state is saved: for PPO's
:class:`reinmav_tpu_torch.rl.ppo.TrainState` the params, Adam state, env
states, normalisers, ``kl_beta``, ``update_step`` and the CPU generator's
state; for the off-policy ``SacState``/``Td3State`` the nets, targets,
Adam states, the replay ring with ``ptr`` and ``filled``, the env states,
the counters and the generator.  Training resumes bitwise-identically.
Any tree of NamedTuples, tensors, ``torch.Generator``\\ s and Python
scalars works the same way.

A checkpoint is a directory holding one file, written to a temporary
name and renamed into place.  :func:`restore` loads it with
``weights_only=True`` (the file holds only tensors, dicts and scalars)
and puts each tensor on the device of the target's.  A checkpoint whose
structure, shapes or types do not fit the target (another network width,
env count or state layout) raises :class:`CheckpointStructureError`; a
missing one raises ``FileNotFoundError``.

Collective across ranks (``mesh`` of more than one rank, the JAX
package's multi-host orbax call): every rank calls :func:`save` and
:func:`restore` with its own state.  Each rank writes its shard (the
fields of :data:`reinmav_tpu_torch.parallel.mesh.SHARDED_FIELDS`: env
states, running returns, the replay ring) to a file of its own, rank 0
also the replicated rest, and a barrier ends the call, so that no rank
reads or overwrites a checkpoint another is still writing.  A checkpoint
restores only at the world size that wrote it; another is refused by
name (:class:`CheckpointStructureError`), never re-sliced.
"""

from __future__ import annotations

import os

import torch

from ..parallel.mesh import SHARDED_FIELDS

_FILE = "train_state.pt"
_FORMAT = 1
_FORMAT_SHARDED = 2  # the replicated tree in _FILE, each rank's shard in _shard_file(rank)


def _shard_file(rank: int) -> str:
    return f"shard_{rank}.pt"


class CheckpointStructureError(ValueError):
    """The checkpoint's structure does not match the restore target
    (different network size, env count, or TrainState layout)."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _to_saved(x):
    """A state tree as dicts of CPU tensors and scalars."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, torch.Generator):
        return {"generator_state": x.get_state()}
    if _is_namedtuple(x):
        return {"fields": {f: _to_saved(getattr(x, f)) for f in x._fields}}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _mismatch(where: str, what: str) -> CheckpointStructureError:
    return CheckpointStructureError(
        f"checkpoint does not match the restore target at {where or 'the root'}: {what} (was it "
        "written with a different network width, num_envs, or TrainState layout?)")


def _from_saved(saved, target, where: str):
    """``saved`` (:func:`_to_saved`'s form) in the structure of ``target``,
    each tensor on the device of the target's."""
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise _mismatch(where, f"saved a {type(saved).__name__}, the target is a tensor")
        if saved.shape != target.shape or saved.dtype != target.dtype:
            raise _mismatch(where, f"saved {tuple(saved.shape)} {saved.dtype}, the target is "
                                   f"{tuple(target.shape)} {target.dtype}")
        return saved.to(target.device)
    if isinstance(target, torch.Generator):
        if not isinstance(saved, dict) or "generator_state" not in saved:
            raise _mismatch(where, "no generator state saved")
        gen = torch.Generator(device=target.device)
        try:
            gen.set_state(saved["generator_state"])
        except RuntimeError as e:
            raise _mismatch(where, f"generator state: {e}") from e
        return gen
    if _is_namedtuple(target):
        fields = saved.get("fields") if isinstance(saved, dict) else None
        if not isinstance(fields, dict) or tuple(fields) != target._fields:
            raise _mismatch(where, f"saved fields {None if fields is None else tuple(fields)}, "
                                   f"the target's {target._fields}")
        return type(target)(*(_from_saved(fields[f], getattr(target, f), f"{where}.{f}".lstrip("."))
                              for f in target._fields))
    if type(saved) is not type(target):
        raise _mismatch(where, f"saved a {type(saved).__name__}, the target is a "
                               f"{type(target).__name__}")
    return saved


def _write(path: str, name: str, blob) -> None:
    tmp = os.path.join(path, name + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, name))


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.world_size > 1


def save(path: str, tree, mesh=None) -> None:
    """Save ``tree`` (e.g. a ``TrainState``) as the checkpoint directory
    ``path``, replacing any checkpoint there.  With a ``mesh`` of more
    than one rank, collective: every rank calls it with its shard of the
    state (see the module docstring)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    saved = _to_saved(tree)
    if not _sharded(mesh):
        _write(path, _FILE, {"format": _FORMAT, "tree": saved})
        return
    fields = saved.get("fields") if isinstance(saved, dict) else None
    if fields is None:
        raise TypeError(f"a sharded checkpoint takes a state NamedTuple, not a "
                        f"{type(tree).__name__}")
    shard = {f: fields[f] for f in SHARDED_FIELDS if f in fields}
    _write(path, _shard_file(mesh.rank), {"world_size": mesh.world_size, "rank": mesh.rank,
                                          "fields": shard})
    if mesh.rank == 0:
        replicated = {"fields": {f: (None if f in shard else v) for f, v in fields.items()}}
        _write(path, _FILE, {"format": _FORMAT_SHARDED, "world_size": mesh.world_size,
                             "tree": replicated})
    mesh.barrier()


def _load(file: str):
    return torch.load(file, map_location="cpu", weights_only=True)


def restore(path: str, target, mesh=None):
    """The checkpoint at ``path`` in the structure of ``target``, each
    tensor on the device of the target's (the target is not modified).
    Raises ``FileNotFoundError`` when there is no checkpoint at ``path``
    and :class:`CheckpointStructureError` when it does not fit, or was
    written by another number of ranks than ``mesh`` has (one without a
    mesh).  With a ``mesh`` of more than one rank, collective: each rank
    gets the replicated state and its own shard."""
    path = os.path.abspath(path)
    file = os.path.join(path, _FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint at {path}")
    blob = _load(file)
    if not isinstance(blob, dict) or blob.get("format") not in (_FORMAT, _FORMAT_SHARDED):
        raise CheckpointStructureError(f"{file} is not a checkpoint of format {_FORMAT} or "
                                       f"{_FORMAT_SHARDED}")
    written = blob.get("world_size", 1)
    ranks = mesh.world_size if mesh is not None else 1
    if written != ranks:
        raise CheckpointStructureError(
            f"checkpoint at {path} was written by {written} rank(s); this run has {ranks}: "
            "restore it at the world size that wrote it")
    tree = blob["tree"]
    if blob["format"] == _FORMAT_SHARDED:
        rank = mesh.rank if mesh is not None else 0
        shard = _load(os.path.join(path, _shard_file(rank)))
        if shard.get("world_size") != written or shard.get("rank") != rank:
            raise CheckpointStructureError(f"{path}: {_shard_file(rank)} is not rank {rank} "
                                           f"of {written}")
        tree = {"fields": {**tree["fields"], **shard["fields"]}}
    out = _from_saved(tree, target, "")
    if mesh is not None:
        mesh.barrier()
    return out
