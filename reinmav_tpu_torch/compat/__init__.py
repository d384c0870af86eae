"""Gymnasium adapters of the PyTorch port: one env (:mod:`.gym_env`) and
a batch of envs as one ``VectorEnv`` (:mod:`.vector_env`)."""

from . import gym_env, vector_env

__all__ = ["gym_env", "vector_env"]
