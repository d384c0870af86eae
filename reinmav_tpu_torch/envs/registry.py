"""Environment registry of the PyTorch port: ``make(env_id)`` returns an
:class:`~reinmav_tpu_torch.envs.core.EnvDef`.

Every id of the JAX package is ported: ``quadrotor3d-v0``,
``quadrotor2d-v0``, the two slung-load envs, ``reinmav-v0`` and the
tpuquad family (``MujocoQuadForce-v0``, ``MujocoQuadForce-v1``,
``MujocoQuadQuat-v0``).  An unknown id raises the same ``KeyError`` as
:func:`reinmav_tpu.make`.
"""

from __future__ import annotations

from typing import Callable, Dict

from .core import EnvDef

_REGISTRY: Dict[str, Callable[..., EnvDef]] = {}


def register(env_id: str, factory: Callable[..., EnvDef]) -> None:
    if env_id in _REGISTRY:
        raise ValueError(f"env id already registered: {env_id}")
    _REGISTRY[env_id] = factory


def make(env_id: str, **kwargs) -> EnvDef:
    try:
        factory = _REGISTRY[env_id]
    except KeyError:
        raise KeyError(f"unknown env id {env_id!r}; known: {sorted(_REGISTRY)}") from None
    return factory(**kwargs)


def registered_ids():
    return sorted(_REGISTRY)


def _populate() -> None:
    from . import (  # local import to avoid cycles
        quadrotor2d,
        quadrotor2d_slungload,
        quadrotor3d,
        quadrotor3d_slungload,
        reinmav13,
        tpuquad,
    )

    register("quadrotor2d-v0", quadrotor2d.make)
    register("quadrotor2d-slungload-v0", quadrotor2d_slungload.make)
    register("quadrotor3d-v0", quadrotor3d.make)
    register("quadrotor3d-slungload-v0", quadrotor3d_slungload.make)
    register("reinmav-v0", reinmav13.make)
    register("MujocoQuadForce-v0", tpuquad.make_force_ground)
    register("MujocoQuadForce-v1", tpuquad.make_hovering)
    register("MujocoQuadQuat-v0", tpuquad.make_quat)


_populate()
