"""Geometric quaternion controller flying the body-rate quad on a circle:
the reference demo ``example/mujoco/control_quat.py`` (10,000 steps,
circle R = 0.5, omega = 1 rad/s, z = 1) on ``MujocoQuadQuat-v0``; the
counterpart of the JAX package's ``examples/control_quat.py``.

Like the reference demo the controller is mass-blind (thrust = desired
acceleration along the body z axis), so the 0.4 kg quat model settles
above the commanded altitude.

Run:  python -m reinmav_tpu_torch.examples.control_quat [--device=cpu] [--quick]
(writes control_quat_*.pdf; the plots need matplotlib)
"""

from __future__ import annotations

import torch

from .. import make
from ..controllers import geometric
from . import parser, prefix, require

ENV, STEPS, QUICK_STEPS = "MujocoQuadQuat-v0", 10_000, 150


@torch.no_grad()
def simulate(steps: int = STEPS, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """``steps`` steps of one env flown on the circle from the reset state;
    returns the ``(steps, 13)`` states, in ``dtype``."""
    env = make(ENV)
    dt = env.params.dt * env.params.frame_skip
    gains = geometric.Gains(gravity=-9.81)
    s = env.reset(torch.Generator(device=device).manual_seed(0), dtype=dtype)
    traj = []
    for t in range(steps):
        ref = geometric.circle_reference(dt * t, radius=0.5, omega=1.0, z=1.0, dtype=dtype,
                                         device=device)
        s = env.step(s, geometric.control(gains, s[0:3], s[3:7], s[7:10], ref)).state
        traj.append(s)
    return torch.stack(traj)


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    require("matplotlib", "control_quat", "plotting")
    from ..render import plot_trajectory

    traj = simulate(QUICK_STEPS if args.quick else STEPS, args.device).cpu().numpy()
    print("final position:", traj[-1, 0:3])
    paths = plot_trajectory(ENV, traj, prefix(args.out_dir, "control_quat"))
    print(paths)
    return traj, paths


if __name__ == "__main__":
    main()
