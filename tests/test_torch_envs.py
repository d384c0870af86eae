"""The port's env core and quadrotor3d-v0 (reinmav_tpu_torch.envs) against
the JAX package, float64 on the CPU.

Inputs come from a NumPy seed and go through both packages.  A single
step and the controller agree to rtol 1e-12 (same expressions, same
order); a 100-step closed loop to the goldens' rtol 1e-8 / atol 1e-9;
a 100-step batched rollout to rtol 1e-10 (ulp differences grow a
little over the horizon)."""

import dataclasses
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.envs import quadrotor3d as jq3
from reinmav_tpu_torch.envs import core, quadrotor3d

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "quadrotor3d-v0.npz")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def envs():
    return reinmav_tpu.make("quadrotor3d-v0"), reinmav_tpu_torch.make("quadrotor3d-v0")


def _t(a):
    return torch.tensor(a, dtype=F64)


def test_step_matches_jax(envs, rng):
    jenv, tenv = envs
    s = rng.uniform(-1, 1, (128, 10))
    s[:16, 0] = 3.5  # outside the envelope: done
    a = rng.uniform(-10, 10, (128, 4))
    ref = jenv.vstep(jnp.asarray(s), jnp.asarray(a))
    got = tenv.vstep(_t(s), _t(a))
    for name in ("state", "obs", "reward"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))
    assert got.done.any() and not got.done.all()


def test_control_matches_jax(envs, rng):
    jenv, tenv = envs
    s = rng.uniform(-1, 1, (128, 10))
    np.testing.assert_allclose(tenv.vcontrol(_t(s)).numpy(), np.asarray(jenv.vcontrol(jnp.asarray(s))),
                               rtol=1e-12, atol=1e-13)


def test_single_env_matches_batched(envs, rng):
    _, tenv = envs
    s = _t(rng.uniform(-1, 1, (4, 10)))
    a = tenv.vcontrol(s)
    for i in range(4):
        np.testing.assert_array_equal(tenv.control(s[i]).numpy(), a[i].numpy())
        np.testing.assert_array_equal(tenv.step(s[i], a[i]).state.numpy(),
                                      tenv.vstep(s, a).state[i].numpy())
    one = tenv.reset(torch.Generator().manual_seed(0), dtype=F64)
    assert one.shape == (10,) and one.dtype == F64


def test_closed_loop_matches_golden(envs):
    _, tenv = envs
    data = np.load(GOLDEN)
    s = _t(data["init"])
    traj, rewards = [], []
    for _ in range(100):
        out = tenv.step(s, tenv.control(s))
        s = out.state
        traj.append(out.state.numpy())
        rewards.append(float(out.reward))
    np.testing.assert_allclose(np.stack(traj), data["traj"][:100], rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(rewards, data["rewards"][:100], rtol=1e-8, atol=1e-10)


def test_control_rollout_matches_jax(envs, rng):
    jenv, tenv = envs
    s = rng.uniform(-1, 1, (64, 10))
    j_final, j_traj = jax.jit(
        lambda x, k: reinmav_tpu.control_rollout(jenv, x, k, 100, auto_reset=False)
    )(jnp.asarray(s), jax.random.PRNGKey(0))
    t_final, t_traj = reinmav_tpu_torch.control_rollout(
        tenv, _t(s), torch.Generator().manual_seed(0), 100, auto_reset=False)
    np.testing.assert_allclose(t_final.numpy(), np.asarray(j_final), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t_traj.state.numpy(), np.asarray(j_traj.state), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t_traj.reward.numpy(), np.asarray(j_traj.reward), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(t_traj.done.numpy(), np.asarray(j_traj.done))


def test_rollout_with_controller_policy_equals_control_rollout(envs, rng):
    _, tenv = envs
    s = _t(rng.uniform(-1, 1, (32, 10)))
    s[:4, 7] = 15.0  # done at the first step: reset
    f1, tr1 = reinmav_tpu_torch.rollout(tenv, reinmav_tpu_torch.controller_policy(tenv), s,
                                        torch.Generator().manual_seed(5), 40)
    f2, tr2 = reinmav_tpu_torch.control_rollout(tenv, s, torch.Generator().manual_seed(5), 40)
    np.testing.assert_array_equal(f1.numpy(), f2.numpy())
    np.testing.assert_array_equal(tr1.reward.numpy(), tr2.reward.numpy())
    assert tr2.done.any(), "the auto-reset path was not exercised"


def test_autoreset_semantics(envs, rng):
    """Done envs are redrawn inside U(-1,1); the others equal vstep."""
    _, tenv = envs
    s = _t(rng.uniform(-1, 1, (256, 10)))
    s[:64, 7] = 15.0  # fast enough to be done after one step
    a = tenv.vcontrol(s)
    plain = tenv.vstep(s, a)
    out = tenv.autoreset_step(s, a, torch.Generator().manual_seed(1))
    done = plain.done
    assert done[:64].all() and not done.all()
    np.testing.assert_array_equal(out.state[~done].numpy(), plain.state[~done].numpy())
    redrawn = out.state[done]
    assert ((redrawn >= -1) & (redrawn < 1)).all()
    assert not torch.equal(redrawn, plain.state[done])
    np.testing.assert_array_equal(out.reward.numpy(), plain.reward.numpy())
    # The (D, B) form is the same step.
    out_t = tenv.autoreset_step_t(s.T, a.T, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(out_t.state.numpy(), out.state.T.numpy())


def test_params_from_jax_round_trip():
    jp = jq3.Params(mass=1.5, dt=0.005, ref_z=1.0, tau=0.25)
    tp = quadrotor3d.params_from_jax(jp)
    assert tp._fields == jp._fields
    for name in jp._fields:
        assert getattr(tp, name) == getattr(jp, name), name
    assert quadrotor3d.params_from_jax(jq3.Params()) == quadrotor3d.Params()
    as_numpy = {k: np.float64(v) for k, v in jp._asdict().items()}
    assert quadrotor3d.params_from_jax(as_numpy) == tp
    reordered = dict(reversed(list(as_numpy.items())))
    with pytest.raises(ValueError, match="fields"):
        quadrotor3d.params_from_jax(reordered)


def test_nondefault_params_match_jax(rng):
    jp = jq3.Params(mass=1.3, ref_x=0.5, ref_z=1.5, kp=-4.0, tau=0.4)
    jenv, tenv = jq3.make(jp), quadrotor3d.make(quadrotor3d.params_from_jax(jp))
    s = rng.uniform(-1, 1, (32, 10))
    a = np.asarray(jenv.vcontrol(jnp.asarray(s)))
    np.testing.assert_allclose(tenv.vcontrol(_t(s)).numpy(), a, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(tenv.vstep(_t(s), _t(a)).state.numpy(),
                               np.asarray(jenv.vstep(jnp.asarray(s), jnp.asarray(a)).state),
                               rtol=1e-12, atol=1e-14)


def test_fused_kernel_mismatch():
    env = quadrotor3d.make()
    assert core.fused_kernel_mismatch(env) is None
    wrapped = dataclasses.replace(env, step_fn=lambda p, s, a: quadrotor3d.step(p, s, a))
    assert "wrapped" in core.fused_kernel_mismatch(wrapped)
    new_ctrl = dataclasses.replace(env, control_fn=lambda p, s: quadrotor3d.control(p, s))
    assert "wrapped" in core.fused_kernel_mismatch(new_ctrl)
    # The kernel takes the Params as arguments: a param sweep stays eligible.
    assert core.fused_kernel_mismatch(quadrotor3d.make(quadrotor3d.Params(ref_z=1.0))) is None
    foreign = dataclasses.replace(env, params=jq3.Params())
    assert "not the kernel's Params" in core.fused_kernel_mismatch(foreign)
    other = dataclasses.replace(env, name="quadrotor3d-custom-v0")
    assert core.fused_kernel_mismatch(other) == "no fused kernel for quadrotor3d-custom-v0"
    # Every id has its kernel; another env's functions under its name are refused.
    assert "wrapped" in core.fused_kernel_mismatch(dataclasses.replace(env, name="reinmav-v0"))


def test_fused_kernel_mismatch_for_policy_kernels():
    """The JAX signature's require_control / packed_params
    (reinmav_tpu/envs/core.py:432-475): K2 drives the env with the policy,
    so a replaced controller is no reason to refuse it; a kernel that bakes
    the default Params refuses any other values."""
    env = quadrotor3d.make()
    new_ctrl = dataclasses.replace(env, control_fn=lambda p, s: quadrotor3d.control(p, s))
    assert core.fused_kernel_mismatch(new_ctrl, require_control=False) is None
    wrapped = dataclasses.replace(env, reset_fn=lambda *a: quadrotor3d.reset(*a))
    assert "wrapped" in core.fused_kernel_mismatch(wrapped, require_control=False)
    swept = quadrotor3d.make(quadrotor3d.Params(ref_z=1.0))
    assert core.fused_kernel_mismatch(swept, packed_params=True) is None
    assert "non-default params" in core.fused_kernel_mismatch(swept, packed_params=False)
    assert core.fused_kernel_mismatch(env, packed_params=False) is None


def test_registry_unknown_id_raises_same_keyerror_as_jax():
    with pytest.raises(KeyError) as t_err:
        reinmav_tpu_torch.make("nope-v0")
    with pytest.raises(KeyError) as j_err:
        reinmav_tpu.make("nope-v0")
    assert str(t_err.value) == str(j_err.value)
    assert reinmav_tpu_torch.registered_ids() == [
        "MujocoQuadForce-v0", "MujocoQuadForce-v1", "MujocoQuadQuat-v0",
        "quadrotor2d-slungload-v0", "quadrotor2d-v0", "quadrotor3d-slungload-v0",
        "quadrotor3d-v0", "reinmav-v0"]


@pytest.mark.parametrize("env_id", sorted(set(reinmav_tpu.registered_ids()) - {"quadrotor3d-v0"}))
def test_registry_unported_ids_raise_not_implemented(env_id):
    """Every JAX id: an id not ported yet raises, naming its ROADMAP item;
    an id ported since builds the env of that name."""
    if env_id in reinmav_tpu_torch.registered_ids():
        env = reinmav_tpu_torch.make(env_id)
        assert env.name == env_id and env.obs_dim == reinmav_tpu.make(env_id).obs_dim
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        reinmav_tpu_torch.make(env_id)


def test_throughput_rollout_dispatch_on_cpu(envs, rng, caplog):
    """On a CPU tensor "auto" runs the eager loop and says why; "kernel"
    raises; the eager loop's reward sum is control_rollout's."""
    _, tenv = envs
    s = _t(rng.uniform(-1, 1, (16, 10)))
    with caplog.at_level(logging.INFO, logger="reinmav_tpu_torch.envs.core"):
        f, r = reinmav_tpu_torch.throughput_rollout(tenv, s, torch.Generator().manual_seed(2), 30)
    assert "eager loop" in caplog.text and "needs a CUDA tensor" in caplog.text
    f2, tr = reinmav_tpu_torch.control_rollout(tenv, s, torch.Generator().manual_seed(2), 30)
    np.testing.assert_array_equal(f.numpy(), f2.numpy())
    np.testing.assert_array_equal(r.numpy(), tr.reward.sum(0).numpy())
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        reinmav_tpu_torch.throughput_rollout(tenv, s, torch.Generator(), 3, backend="kernel")
    wrapped = dataclasses.replace(tenv, reset_fn=core.uniform_reset(10))
    with pytest.raises(ValueError, match="wrapped"):
        reinmav_tpu_torch.throughput_rollout(wrapped, s, torch.Generator(), 3, backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        reinmav_tpu_torch.throughput_rollout(tenv, s, torch.Generator(), 3, backend="pallas")


def test_import_leaves_jax_out():
    code = ("import sys, reinmav_tpu_torch, reinmav_tpu_torch.ops.rollout, "
            "reinmav_tpu_torch.envs.tpuquad, reinmav_tpu_torch.ops.hover_rollout, "
            "reinmav_tpu_torch.ops.ppo_rollout, reinmav_tpu_torch.ops.ppo_loss, "
            "reinmav_tpu_torch.rl.ppo, reinmav_tpu_torch.profile_main_path, "
            "reinmav_tpu_torch.envs.reinmav13, reinmav_tpu_torch.ops.reinmav_rollout, "
            "reinmav_tpu_torch.ops.contact_rollout, "
            "reinmav_tpu_torch._build; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'reinmav_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_library_name_hashes_sources_and_headers(tmp_path, monkeypatch):
    """An edited source or shared header names a new library, so a stale
    build is never reused; the K2, K3 and K5 entry points are declared."""
    from reinmav_tpu_torch import _build

    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.SRC_DIR.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", src)
    names = {_build._library_path().name}
    header = src / "quad3d_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    names.add(_build._library_path().name)
    (src / "ppo_loss.cu").write_text((src / "ppo_loss.cu").read_text() + "\n")
    names.add(_build._library_path().name)
    assert len(names) == 3
    header = src / "hover_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    names.add(_build._library_path().name)
    assert len(names) == 4
    assert {"ppo_rollout_launch", "ppo_loss_launch", "ppo_loss_blocks",
            "hover_rollout_launch"} <= set(_build._SIGNATURES)
