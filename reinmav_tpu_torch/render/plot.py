"""Headless rendering: offline trajectory plots and rgb_array frames.

The counterpart of :mod:`reinmav_tpu.render.plot`.  It replaces the
reference's interactive rendering stacks (gym classic_control viewer for
2D, vpython browser canvas for 3D, MuJoCo viewer) with matplotlib Agg
rendering that needs no display:

* :func:`plot_trajectory` — the ``ReinmavEnv.plot_state`` role
  (``reinmav_env.py:138-185``): the reference's full plot set —
  position-x, velocity-x, and yaw, each against its desired trace, plus
  a 3D path figure — saved as PDFs.
* :func:`render_frame` — per-state rgb_array frames.  2D: quad bar +
  load + reference marker like ``quadrotor2d.py:154-185``.  3D /
  tpuquad: top-down view with the X-configuration arms and rotor discs
  rotated by the attitude quaternion plus projected body axes (the
  vpython scene's content, ``quadrotor3d.py:187-307``), altitude bar,
  and tether/load projection for the slungload envs.

States may be NumPy arrays or tensors on any device (:func:`host`).
"""

from __future__ import annotations

import numpy as np


def host(x) -> np.ndarray:
    """``x`` as a NumPy array: a tensor (on any device) is copied to the
    host, anything else goes through ``np.asarray``."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _agg_figure(figsize=(6.4, 4.8)):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt, plt.figure(figsize=figsize)


def _fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    return buf.copy()


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(q)
    w, x, y, z = (q / n) if n > 0 else np.array([1.0, 0, 0, 0])
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _layout(env_name: str):
    """(pos, vel, quat, load) index slices per env family (None = absent)."""
    if env_name == "reinmav-v0":
        return slice(0, 3), slice(3, 6), slice(6, 10), None
    if "2d" in env_name:
        return None, None, None, None  # 2D handled separately
    load = slice(10, 13) if "slungload" in env_name else None
    return slice(0, 3), slice(7, 10), slice(3, 7), load


def _yaw_from_quat(quats: np.ndarray) -> np.ndarray:
    """ZXY yaw extraction (the reference's RotToRPY convention,
    ``reinmav_env.py:341-346``), vectorised over (T, 4)."""
    out = np.empty(quats.shape[0])
    for i, q in enumerate(quats):
        rot = _quat_to_rotmat(q)
        # ZXY: psi = atan2(-R[0,1], R[1,1])
        out[i] = np.arctan2(-rot[0, 1], rot[1, 1])
    return out


def _desired_traces(env_name: str, tgrid: np.ndarray):
    """(desired position-x, desired velocity-x, desired yaw) over time.

    reinmav-v0: the quintic min-jerk reference the embedded controller
    tracks (``trj_gen``, ``reinmav_env.py:128-136``).  Hover-style envs:
    their constant reference point and zero yaw."""
    if env_name == "reinmav-v0":
        from ..envs.reinmav13 import Params

        p = Params()
        tc = np.clip(tgrid, 0.0, p.t_max) / p.t_max
        pos = 10.0 * tc**3 - 15.0 * tc**4 + 6.0 * tc**5
        vel = (30.0 / p.t_max) * tc**2 - (60.0 / p.t_max) * tc**3 + (30.0 / p.t_max) * tc**4
        return pos, vel, pos  # yaw reference is the same quintic (Q9)
    zeros = np.zeros_like(tgrid)
    if env_name == "quadrotor3d-v0":
        return zeros, zeros, zeros  # ref (0, 0, 2): x-reference is 0
    return zeros, zeros, zeros


def plot_trajectory(env_name: str, states: np.ndarray, path_prefix: str = "trajectory",
                    dt: float = 0.01, desired: np.ndarray | None = None):
    """The reference ``plot_state`` set for a (T, D) state history:
    position/velocity/yaw vs desired + 3D path.  Returns saved paths."""
    states = host(states)
    desired = None if desired is None else host(desired)
    tgrid = np.arange(states.shape[0]) * dt
    paths = []
    pos_sl, vel_sl, quat_sl, _ = _layout(env_name)
    if desired is not None and desired.shape[1] >= 10:
        # trj_gen layout [pos3, vel3, acc3, yaw, dyaw] (reinmav-v0)
        des_pos, des_vel, des_yaw = desired[:, 0], desired[:, 3], desired[:, 9]
    elif desired is not None:
        # compact [pos_x, vel_x, yaw] layout
        des_pos = desired[:, 0]
        des_vel = desired[:, 1] if desired.shape[1] > 1 else None
        des_yaw = desired[:, 2] if desired.shape[1] > 2 else None
    else:
        des_pos, des_vel, des_yaw = _desired_traces(env_name, tgrid)

    def series_fig(name, ylab, trace, des, labels):
        plt, fig = _agg_figure()
        ax = fig.add_subplot(111)
        ax.plot(tgrid, trace, "b", label=labels[0])
        if des is not None:
            ax.plot(tgrid, des, "r-.", label=labels[1])
        ax.set_xlabel("Time (s)")
        ax.set_ylabel(ylab)
        ax.grid(True)
        ax.legend()
        p = f"{path_prefix}_{name}.pdf"
        fig.savefig(p, format="pdf")
        paths.append(p)
        plt.close(fig)

    if "2d" in env_name:
        series_fig("position", "m", states[:, 0], des_pos, ["position x", "desired x"])
        series_fig("velocity", "m/s", states[:, 3], des_vel, ["velocity x", "desired vel x"])
        series_fig("yaw", "rad", states[:, 2], des_yaw, ["attitude", "desired attitude"])
    else:
        series_fig("position", "m", states[:, pos_sl][:, 0], des_pos,
                   ["position x", "desired x"])
        series_fig("velocity", "m/s", states[:, vel_sl][:, 0], des_vel,
                   ["velocity x", "desired vel x"])
        series_fig("yaw", "rad", _yaw_from_quat(states[:, quat_sl]), des_yaw,
                   ["yaw", "desired yaw"])

    if states.shape[1] >= 6:
        plt, fig = _agg_figure()
        ax = fig.add_subplot(111, projection="3d")
        if "2d" in env_name:
            ax.plot(states[:, 0], np.zeros_like(states[:, 0]), states[:, 1])
        else:
            ax.plot(states[:, 0], states[:, 1], states[:, 2])
        ax.set_xlabel("x (m)")
        ax.set_ylabel("y (m)")
        ax.set_zlabel("z (m)")
        p = f"{path_prefix}_path3d.pdf"
        fig.savefig(p, format="pdf")
        paths.append(p)
        plt.close(fig)
    return paths


def save_gif(env_name: str, states: np.ndarray, path: str, every: int = 4,
             fps: int = 25) -> str:
    """Render a (T, D) state history to an animated GIF (the role of the
    reference's demo GIFs in ``gym_reinmav/resources/``)."""
    from PIL import Image

    states = host(states)
    frames = [
        Image.fromarray(render_frame(env_name, states[i]))
        for i in range(0, states.shape[0], every)
    ]
    frames[0].save(
        path, save_all=True, append_images=frames[1:],
        duration=int(1000 / fps), loop=0,
    )
    return path


def render_frame(env_name: str, state: np.ndarray, extent: float = 3.0) -> np.ndarray:
    """One rgb_array frame of the current state."""
    state = host(state)
    plt, fig = _agg_figure((4.8, 4.8))
    ax = fig.add_subplot(111)
    ax.set_xlim(-extent, extent)
    ax.set_ylim(-extent, extent)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)

    if "2d" in env_name:
        x, z, th = state[0], state[1], state[2]
        arm = 0.25
        dx, dz = arm * np.cos(th), arm * np.sin(th)
        ax.plot([x - dx, x + dx], [z - dz, z + dz], "k-", lw=3)
        ax.plot([0.0], [0.0], "r.", ms=10)  # reference
        if state.shape[0] >= 9:  # slung load
            ax.plot([x, state[5]], [z, state[6]], "gray", lw=1)
            ax.plot([state[5]], [state[6]], "bo", ms=6)
    else:
        pos_sl, _, quat_sl, load_sl = _layout(env_name)
        pos = state[pos_sl]
        rot = _quat_to_rotmat(state[quat_sl])
        x, y, z = pos

        # X-configuration arms rotated by the attitude (the vpython
        # scene's quad body, quadrotor3d.py:210-259), projected top-down.
        arm = 0.35
        tips = []
        for bx, by in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
            tip_b = np.array([bx, by, 0.0]) * arm / np.sqrt(2.0)
            tip_w = pos + rot @ tip_b
            tips.append(tip_w)
        for i, (a, b) in enumerate(((0, 2), (1, 3))):
            ax.plot([tips[a][0], tips[b][0]], [tips[a][1], tips[b][1]],
                    "k-", lw=2.5)
        for i, tip in enumerate(tips):
            # Rotor discs; front rotors (body +x) red like the vpython
            # orientation cue.
            color = "r" if i in (0, 1) else "0.4"
            ax.add_patch(plt.Circle((tip[0], tip[1]), 0.09, fill=False,
                                    color=color, lw=1.5))
        # Projected body axes: x red, y green, z blue.
        for axis, color in ((0, "r"), (1, "g"), (2, "b")):
            tip = pos + rot[:, axis] * 0.5
            ax.plot([x, tip[0]], [y, tip[1]], color, lw=1.2)

        ax.plot([0.0], [0.0], "r.", ms=10)
        ax.barh(-extent + 0.2, max(min(z, extent), -extent), height=0.1, color="c")
        ax.text(-extent + 0.1, -extent + 0.4, f"z={float(z):.2f}")
        if load_sl is not None:  # slung load + tether projection
            load = state[load_sl]
            ax.plot([x, load[0]], [y, load[1]], "gray", lw=1)
            ax.plot([load[0]], [load[1]], "bo", ms=6)

    frame = _fig_to_rgb(fig)
    plt.close(fig)
    return frame
