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
"""

from __future__ import annotations

import os

import torch

_FILE = "train_state.pt"
_FORMAT = 1


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


def save(path: str, tree) -> None:
    """Save ``tree`` (e.g. a ``TrainState``) as the checkpoint directory
    ``path``, replacing any checkpoint there."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save({"format": _FORMAT, "tree": _to_saved(tree)}, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def restore(path: str, target):
    """The checkpoint at ``path`` in the structure of ``target``, each
    tensor on the device of the target's (the target is not modified).
    Raises ``FileNotFoundError`` when there is no checkpoint at ``path``
    and :class:`CheckpointStructureError` when it does not fit."""
    path = os.path.abspath(path)
    file = os.path.join(path, _FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint at {path}")
    blob = torch.load(file, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != _FORMAT:
        raise CheckpointStructureError(f"{file} is not a checkpoint of format {_FORMAT}")
    return _from_saved(blob["tree"], target, "")
