"""Learners of the PyTorch port: the actor-critic (:mod:`.networks`) and
PPO (:mod:`.ppo`)."""
