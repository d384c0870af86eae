"""Environment registry of the PyTorch port: ``make(env_id)`` returns an
:class:`~reinmav_tpu_torch.envs.core.EnvDef`.

Ported so far: ``quadrotor3d-v0``, ``quadrotor2d-v0``, the two slung-load
envs and the tpuquad family (``MujocoQuadForce-v0``,
``MujocoQuadForce-v1``, ``MujocoQuadQuat-v0``).  ``reinmav-v0`` is known
and raises ``NotImplementedError`` naming the ROADMAP.md item that ports
it; an unknown id raises the same ``KeyError`` as
:func:`reinmav_tpu.make`.
"""

from __future__ import annotations

from typing import Callable, Dict

from .core import EnvDef

_REGISTRY: Dict[str, Callable[..., EnvDef]] = {}

#: Reference env ids not ported yet -> the ROADMAP.md item that ports them.
_NOT_PORTED = {
    "reinmav-v0": "ROADMAP.md queue 1 item 9 (remaining native envs, slice 9c)",
}


def register(env_id: str, factory: Callable[..., EnvDef]) -> None:
    if env_id in _REGISTRY:
        raise ValueError(f"env id already registered: {env_id}")
    _REGISTRY[env_id] = factory


def make(env_id: str, **kwargs) -> EnvDef:
    if env_id in _NOT_PORTED and env_id not in _REGISTRY:
        raise NotImplementedError(
            f"{env_id} is not ported to PyTorch yet: {_NOT_PORTED[env_id]}")
    try:
        factory = _REGISTRY[env_id]
    except KeyError:
        known = sorted(set(_REGISTRY) | set(_NOT_PORTED))
        raise KeyError(f"unknown env id {env_id!r}; known: {known}") from None
    return factory(**kwargs)


def registered_ids():
    return sorted(_REGISTRY)


def _populate() -> None:
    from . import (  # local import to avoid cycles
        quadrotor2d,
        quadrotor2d_slungload,
        quadrotor3d,
        quadrotor3d_slungload,
        tpuquad,
    )

    register("quadrotor2d-v0", quadrotor2d.make)
    register("quadrotor2d-slungload-v0", quadrotor2d_slungload.make)
    register("quadrotor3d-v0", quadrotor3d.make)
    register("quadrotor3d-slungload-v0", quadrotor3d_slungload.make)
    register("MujocoQuadForce-v0", tpuquad.make_force_ground)
    register("MujocoQuadForce-v1", tpuquad.make_hovering)
    register("MujocoQuadQuat-v0", tpuquad.make_quat)


_populate()
