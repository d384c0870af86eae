"""CLI alias: ``python -m reinmav_tpu_torch.run``, as ``python -m
reinmav_tpu.run`` is for the JAX package.  Forwards to
:mod:`reinmav_tpu_torch.rl.run`."""

from .rl.run import main

if __name__ == "__main__":
    main()
