"""Cascaded RPY PID flying the force-actuated quad on a circle: the
reference demo ``example/mujoco/control_rpy.py`` (1000 steps, circle
R = 0.5, omega = 1 rad/s, z = 1) on ``MujocoQuadForce-v0``; the
counterpart of the JAX package's ``examples/control_rpy.py``.

Run:  python -m reinmav_tpu_torch.examples.control_rpy [--device=cpu] [--quick]
(writes control_rpy_*.pdf; the plots need matplotlib)
"""

from __future__ import annotations

import math

import torch

from .. import make
from ..controllers import rpy_pid
from . import parser, prefix, require

ENV, STEPS, QUICK_STEPS = "MujocoQuadForce-v0", 1000, 150


@torch.no_grad()
def simulate(steps: int = STEPS, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """``steps`` steps of one env flown on the circle by the PID from the
    reset state; returns the ``(steps, 13)`` states, in ``dtype``."""
    env = make(ENV)
    p = env.params
    dt = p.dt * p.frame_skip
    gains = rpy_pid.Gains()
    s = env.reset(torch.Generator(device=device).manual_seed(0), dtype=dtype)
    pid = rpy_pid.init_carry(s.dtype, device)
    traj = []
    for t in range(steps):
        pos_d = torch.tensor([0.5 * math.cos(dt * t), 0.5 * math.sin(dt * t), 1.0],
                             dtype=s.dtype, device=device)
        yaw_d = (dt * t + math.pi) % (2 * math.pi) - math.pi
        forces, pid = rpy_pid.control(gains, pid, s[0:3], s[3:7], pos_d, yaw_d, dt, p.mass,
                                      p.gravity)
        s = env.step(s, forces).state
        traj.append(s)
    return torch.stack(traj)


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    require("matplotlib", "control_rpy", "plotting")
    from ..render import plot_trajectory

    traj = simulate(QUICK_STEPS if args.quick else STEPS, args.device).cpu().numpy()
    print("final position:", traj[-1, 0:3])
    paths = plot_trajectory(ENV, traj, prefix(args.out_dir, "control_rpy"))
    print(paths)
    return traj, paths


if __name__ == "__main__":
    main()
