"""The port's five examples (reinmav_tpu_torch.examples) at their reduced
size (``--quick``) on the CPU, each checked on its own output: the two
controllers' final position near the demos' circle (R = 0.5; the
mass-blind geometric controller settles above the commanded altitude of
1 m, the PID near it) and their PDFs, reinmav-v0 on its min-jerk
trajectory and its PDFs, PPO's finite rewards and play return, the
vector-env loop's finite rewards.  The three simulations are held, in
float64 at their reduced size, to the JAX package's examples' loops
(examples/control_quat.py, control_rpy.py, reinmav_sim.py: the same scan
bodies) from the same reset state.  Where matplotlib or gymnasium is
missing, the example exits naming it; and nothing of the JAX package is
imported by the port's examples.
"""

import importlib
import importlib.util
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu
from reinmav_tpu.controllers import geometric as jgeometric
from reinmav_tpu.controllers import rpy_pid as jrpy_pid
from reinmav_tpu.envs import reinmav13 as jreinmav13

EXAMPLES = ("control_quat", "control_rpy", "reinmav_sim", "train_quadrotor2d_ppo",
            "train_vector_env")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(name, tmp_path):
    module = importlib.import_module(f"reinmav_tpu_torch.examples.{name}")
    return module.main(["--device=cpu", "--quick", f"--out_dir={tmp_path}"])


def _pdfs(tmp_path, stem, paths):
    expected = {str(tmp_path / f"{stem}_{k}.pdf") for k in ("position", "velocity", "yaw",
                                                            "path3d")}
    assert set(paths) == expected
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(5) == b"%PDF-"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_at_its_reduced_size(name, tmp_path, capsys):
    out = _run(name, tmp_path)
    printed = capsys.readouterr().out
    if name in ("control_quat", "control_rpy"):
        traj, paths = out
        assert np.isfinite(traj).all() and traj.shape == (150, 13)
        radius = math.hypot(*traj[-1, :2])
        assert abs(radius - 0.5) < 0.2, traj[-1]  # chip_smoke.py's CIRCLE_TOL
        z = traj[-1, 2]
        assert (1.5 < z < 2.5) if name == "control_quat" else abs(z - 1.0) < 0.2, traj[-1]
        _pdfs(tmp_path, name, paths)
    elif name == "reinmav_sim":
        traj, desired, paths = out
        assert traj.shape == (100, 13) and desired.shape == (100, 11)
        assert np.abs(traj[:, :3] - desired[:, :3]).max() < 0.01
        _pdfs(tmp_path, name, paths)
    elif name == "train_quadrotor2d_ppo":
        rewards, ret = out
        assert len(rewards) == 2 and all(math.isfinite(r) for r in rewards)
        assert math.isfinite(ret) and "play return" in printed
    else:
        assert len(out) == 3 and all(math.isfinite(r) for r in out)
    assert "final position" in printed or name.startswith("train")


def _jax_control_quat(steps):
    """examples/control_quat.py's loop, ``steps`` steps."""
    env = reinmav_tpu.make("MujocoQuadQuat-v0")
    dt = env.params.dt * env.params.frame_skip
    gains = jgeometric.Gains(gravity=-9.81)

    def body(s, t):
        ref_pos = jgeometric.circle_reference(dt * t, radius=0.5, omega=1.0, z=1.0)
        out = env.step(s, jgeometric.control(gains, s[0:3], s[3:7], s[7:10], ref_pos))
        return out.state, out.state

    s0 = env.reset(jax.random.PRNGKey(0))
    return (np.asarray(jax.jit(lambda s: jax.lax.scan(body, s, jnp.arange(float(steps))))(s0)[1]),)


def _jax_control_rpy(steps):
    """examples/control_rpy.py's loop, ``steps`` steps."""
    env = reinmav_tpu.make("MujocoQuadForce-v0")
    p = env.params
    dt = p.dt * p.frame_skip
    gains = jrpy_pid.Gains()

    def body(carry, t):
        s, pid = carry
        pos_d = jnp.stack([0.5 * jnp.cos(dt * t), 0.5 * jnp.sin(dt * t), 1.0])
        yaw_d = jnp.mod(dt * t + jnp.pi, 2 * jnp.pi) - jnp.pi
        forces, pid = jrpy_pid.control(gains, pid, s[0:3], s[3:7], pos_d, yaw_d, dt, p.mass,
                                       p.gravity)
        out = env.step(s, forces)
        return (out.state, pid), out.state

    s0 = env.reset(jax.random.PRNGKey(0))
    _, traj = jax.jit(lambda s, c: jax.lax.scan(body, (s, c), jnp.arange(float(steps))))(
        s0, jrpy_pid.init_carry(s0.dtype))
    return (np.asarray(traj),)


def _jax_reinmav_sim(steps):
    """examples/reinmav_sim.py's loop and desired overlay, ``steps`` steps."""
    env = reinmav_tpu.make("reinmav-v0")

    def body(s, _):
        out = env.step(s, jnp.zeros(0))
        return out.state, out.obs

    _, traj = jax.jit(lambda s: jax.lax.scan(body, s, None, length=steps))(
        env.reset(jax.random.PRNGKey(0)))
    times = np.arange(1, steps + 1) / 100.0
    return np.asarray(traj), np.stack([np.asarray(jreinmav13.trj_gen(env.params, t))
                                       for t in times])


JAX_LOOPS = {"control_quat": _jax_control_quat, "control_rpy": _jax_control_rpy,
             "reinmav_sim": _jax_reinmav_sim}


@pytest.mark.parametrize("name", list(JAX_LOOPS))
def test_simulation_matches_the_jax_example(name):
    module = importlib.import_module(f"reinmav_tpu_torch.examples.{name}")
    got = module.simulate(module.QUICK_STEPS, "cpu", dtype=torch.float64)
    ref = JAX_LOOPS[name](module.QUICK_STEPS)
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref):
        assert g.dtype == torch.float64 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,module", [("control_quat", "matplotlib"),
                                         ("reinmav_sim", "matplotlib"),
                                         ("train_vector_env", "gymnasium")])
def test_example_refuses_by_name_without_its_package(name, module, monkeypatch, tmp_path):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda m, *a: None if m == module else real(m, *a))
    with pytest.raises(SystemExit, match=f"{name}: .* needs {module}, which is not installed"):
        _run(name, tmp_path)


def test_examples_import_nothing_of_jax():
    code = ("import sys\n"
            + "".join(f"import reinmav_tpu_torch.examples.{n}\n" for n in EXAMPLES)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
              "or m == 'reinmav_tpu' or m.startswith('reinmav_tpu.')]\n"
              "print('IMPORTED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert "IMPORTED []" in out.stdout, out.stdout + out.stderr
