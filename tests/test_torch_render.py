"""The port's renderers (reinmav_tpu_torch.render) and profiling helpers
(reinmav_tpu_torch.utils.profiling) on the CPU.

``save_html`` writes byte for byte the JAX package's page for the same
states (given as a tensor to the port, as NumPy to the JAX package), for
every family of env layouts.  A GIF and the plot set are written.  The
live viewer binds port 0 and answers one page request and one frames
request, at the URL built from the address it bound.  ``time_fn``,
``trace`` and ``NanGuard`` run on a small eager rollout.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import reinmav_tpu_torch
from reinmav_tpu.render import html_view as jhtml
from reinmav_tpu_torch.render import LiveViewer, plot_trajectory, render_frame, save_gif, save_html
from reinmav_tpu_torch.utils import profiling


def _trajectory(env_id, steps=40):
    env = reinmav_tpu_torch.make(env_id)
    gen = torch.Generator().manual_seed(0)
    s = env.reset(gen)
    out = []
    for _ in range(steps):
        a = env.control(s) if env.control_fn is not None else torch.zeros(max(env.action_dim, 1))
        s = env.step(s, a).state
        out.append(s)
    return torch.stack(out)


@pytest.mark.parametrize("env_id", ["quadrotor3d-v0", "quadrotor2d-v0",
                                    "quadrotor2d-slungload-v0", "quadrotor3d-slungload-v0",
                                    "MujocoQuadForce-v1", "reinmav-v0"])
def test_save_html_is_the_jax_page(env_id, tmp_path):
    states = _trajectory(env_id, 12)
    got = save_html(env_id, states, str(tmp_path / "port"), every=2)
    want = jhtml.save_html(env_id, states.numpy(), str(tmp_path / "jax.html"), every=2)
    assert got.endswith(".html")
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_gif_frame_and_plots_are_written(tmp_path):
    states = _trajectory("quadrotor3d-v0", 16)
    frame = render_frame("quadrotor3d-v0", states[-1])
    assert frame.shape[2] == 3 and frame.dtype == np.uint8
    gif = save_gif("quadrotor3d-v0", states, str(tmp_path / "fly.gif"), every=8)
    with open(gif, "rb") as f:
        assert f.read(6) in (b"GIF87a", b"GIF89a")
    paths = plot_trajectory("quadrotor2d-v0", _trajectory("quadrotor2d-v0", 10),
                            str(tmp_path / "q2d"))
    assert len(paths) == 3 and all(os.path.getsize(p) > 0 for p in paths)


def test_live_viewer_on_port_zero_answers_a_request():
    viewer = LiveViewer("quadrotor3d-v0", port=0)
    try:
        assert viewer.port > 0 and viewer.url == f"http://127.0.0.1:{viewer.port}/"
        for s in _trajectory("quadrotor3d-v0", 3):
            viewer.push(s)
        viewer.finish()
        with urllib.request.urlopen(viewer.url, timeout=10) as r:
            assert r.status == 200 and b"LIVE" in r.read()
        with urllib.request.urlopen(viewer.url + "frames.json?since=0", timeout=10) as r:
            body = json.loads(r.read())
        assert body["seq"] == 3 and body["done"] and len(body["frames"]) == 3
    finally:
        viewer.close()


def test_time_fn_trace_and_nan_guard(tmp_path):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    states = env.vreset(torch.Generator().manual_seed(1), 64)

    def run(s):
        return reinmav_tpu_torch.throughput_rollout(env, s, torch.Generator().manual_seed(2), 5)

    seconds, (final, rew) = profiling.time_fn(run, states, warmup=1, iters=3)
    assert seconds > 0 and final.shape == (64, 10)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        run(states)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))
    assert len(prof.key_averages()) > 0
    profiling.NanGuard.check({"final": final, "rew": (rew, 1.0)}, "rollout")
    with pytest.raises(FloatingPointError, match="rollout leaf 2"):
        profiling.NanGuard.check([final, rew, torch.tensor([0.0, float("nan")])], "rollout")


def test_the_modules_around_the_learners_import_no_jax():
    """The GRU learner, the CLI, the controllers, the gymnasium adapters,
    the renderers and profiling import neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = ("import sys, reinmav_tpu_torch.rl.recurrent, reinmav_tpu_torch.rl.run, "
            "reinmav_tpu_torch.controllers, reinmav_tpu_torch.compat, reinmav_tpu_torch.render, "
            "reinmav_tpu_torch.utils.profiling; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'reinmav_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
