"""Learners of the PyTorch port: the actor-critic (:mod:`.networks`), PPO
(:mod:`.ppo`), SAC (:mod:`.sac`), TD3 and DDPG (:mod:`.td3`), the GRU
learner (:mod:`.recurrent`), evaluation (:mod:`.evaluate`) and the CLI
(:mod:`.run`)."""
