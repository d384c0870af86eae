"""The JAX package's five ``examples/`` scripts, as the port's own.

Each runs as ``python -m reinmav_tpu_torch.examples.<name>`` on the card
(``--device=cpu`` for the CPU) and at a reduced size with ``--quick``;
each splits its work (``simulate()`` or ``train()``) from its plots or its
gymnasium loop, which refuse by name where matplotlib or gymnasium is not
installed:

- :mod:`.control_quat`: the geometric controller flying
  ``MujocoQuadQuat-v0`` on the demos' circle, 10,000 steps;
- :mod:`.control_rpy`: the RPY PID flying ``MujocoQuadForce-v0`` on the
  circle, 1000 steps;
- :mod:`.reinmav_sim`: ``reinmav-v0``'s 400 steps of the min-jerk
  trajectory against the desired one;
- :mod:`.train_quadrotor2d_ppo`: PPO on ``quadrotor2d-v0`` (K6 and K4 on
  the card), then a 1000-step greedy play;
- :mod:`.train_vector_env`: a NumPy REINFORCE loop through the gymnasium
  ``VectorEnv`` adapter.
"""

from __future__ import annotations

import argparse
import importlib.util
import os


def parser(description: str) -> argparse.ArgumentParser:
    """The flags every example takes: ``--device``, ``--quick`` and
    ``--out_dir``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    p.add_argument("--quick", action="store_true", help="a reduced size that runs in seconds")
    p.add_argument("--out_dir", default=".", help="where the PDFs are written")
    return p


def require(module: str, example: str, what: str) -> None:
    """Exit before any work, naming ``module``, when it is not installed."""
    if importlib.util.find_spec(module) is None:
        raise SystemExit(f"{example}: {what} needs {module}, which is not installed")


def prefix(out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, name)
