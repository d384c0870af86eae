"""reinmav-v0's controller-in-the-loop simulation and its trajectory
plots: the reference flow ``test/test_reinmav.py`` (400 steps, 4 s of the
quintic min-jerk trajectory) with ``ReinmavEnv.plot_state``
(``reinmav_env.py:138-185``: position, velocity and yaw against the
desired ones, as PDFs); the counterpart of the JAX package's
``examples/reinmav_sim.py``.

Run:  python -m reinmav_tpu_torch.examples.reinmav_sim [--device=cpu] [--quick]
(writes reinmav_sim_*.pdf; the plots need matplotlib)
"""

from __future__ import annotations

import torch

from .. import make
from ..envs import reinmav13
from . import parser, prefix, require

ENV, STEPS, QUICK_STEPS = "reinmav-v0", 400, 100


@torch.no_grad()
def simulate(steps: int = STEPS, device="cuda", dtype=torch.float32):
    """``steps`` outer steps from the reset state; returns ``(observations
    (steps, 13), desired (steps, 11))`` in ``dtype``, the desired
    trajectory at the outer-step times ``1 .. steps`` x 10 ms (the
    reference's overlay)."""
    env = make(ENV)
    s = env.reset(torch.Generator(device=device).manual_seed(0), dtype=dtype)
    obs = []
    for _ in range(steps):
        out = env.step(s, s.new_zeros(0))
        s = out.state
        obs.append(out.obs)
    times = torch.arange(1, steps + 1, dtype=s.dtype, device=device) / 100.0
    return torch.stack(obs), reinmav13.trj_gen(env.params, times)


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    require("matplotlib", "reinmav_sim", "plotting")
    from ..render import plot_trajectory

    traj, desired = (x.cpu().numpy() for x in simulate(QUICK_STEPS if args.quick else STEPS,
                                                        args.device))
    print("final position:", traj[-1, 0:3], "desired:", desired[-1, 0:3])
    print("max |x - x_des|:", abs(traj[:, 0] - desired[:, 0]).max())
    paths = plot_trajectory(ENV, traj, prefix(args.out_dir, "reinmav_sim"), desired=desired)
    print(paths)
    return traj, desired, paths


if __name__ == "__main__":
    main()
