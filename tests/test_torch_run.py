"""The port's training surface on the CPU: the CLI (reinmav_tpu_torch.rl.run),
checkpoints and their manager, the metrics logger, and evaluation against
the JAX package's.

The CLI runs with ``--device=cpu`` (the kernels' plain twins).  Resume is
bitwise, as tests/test_resume.py holds the JAX package: 4 updates
uninterrupted against 2, a checkpoint, a restore into a state of another
seed, and 2 more.  Evaluation is held to ``reinmav_tpu.rl.evaluate`` from
the JAX package's initial states, on a horizon where no env ends, in
float64 (the suite's JAX x64) at rtol 1e-9.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.rl import evaluate as jevaluate
from reinmav_tpu_torch import run as run_alias
from reinmav_tpu_torch.rl import evaluate, ppo, recurrent, run
from reinmav_tpu_torch.utils import CheckpointManager, MetricsLogger
from reinmav_tpu_torch.utils import checkpoint as ckpt

SMALL = ["--device=cpu", "--num_env=64", "--rollout_len=16"]


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("alg", ["ppo", "a2c", "ppo_kl"])
def test_cli_trains_logs_saves_and_plays(alg, tmp_path, capsys):
    ck, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    run.main([*SMALL, f"--alg={alg}", "--num_timesteps=2048", "--log_interval=1",
              f"--save_path={ck}", "--eval_interval=2", "--eval_envs=8", "--eval_horizon=10",
              f"--log_dir={logs}"])
    lines = _lines(capsys.readouterr().out)
    train = [row for row in lines if "env_steps" in row]
    assert [row["env_steps"] for row in train] == [1024.0, 2048.0]
    for row in train:
        assert all(math.isfinite(v) for v in row.values()), row
        assert row["steps_per_sec"] > 0
    evals = [row for row in lines if "eval_survival_frac" in row]
    assert len(evals) == 1 and 0.0 <= evals[0]["eval_survival_frac"] <= 1.0
    with open(f"{logs}/metrics.jsonl") as f:
        header = json.loads(f.readline())
    assert header["config"]["alg"] == alg and header["config"]["device"] == "cpu"

    run_alias.main([*SMALL, f"--alg={alg}", "--play", f"--load_path={ck}", "--play_steps=30"])
    (played,) = _lines(capsys.readouterr().out)
    assert played["play_steps"] == 30 and math.isfinite(played["total_reward"])


def test_cli_trains_and_plays_the_hover_task(tmp_path, capsys):
    """The README's hover command, on the CPU: PPO on MujocoQuadForce-v1
    through the kernels' plain twins, a checkpoint, an evaluation, play."""
    ck = str(tmp_path / "hover")
    run.main(["--env=MujocoQuadForce-v1", *SMALL, "--num_timesteps=2048", "--log_interval=1",
              f"--save_path={ck}", "--eval_interval=2", "--eval_envs=8", "--eval_horizon=30"])
    lines = _lines(capsys.readouterr().out)
    train = [row for row in lines if "env_steps" in row]
    assert [row["env_steps"] for row in train] == [1024.0, 2048.0]
    assert all(math.isfinite(v) for row in train for v in row.values())
    assert all(50.0 < row["mean_reward"] < 100.0 for row in train)
    (ev,) = [row for row in lines if "eval_survival_frac" in row]
    assert 0.0 <= ev["eval_survival_frac"] <= 1.0
    run.main(["--env=MujocoQuadForce-v1", *SMALL, "--play", f"--load_path={ck}",
              "--play_steps=40"])
    (played,) = _lines(capsys.readouterr().out)
    assert played["play_steps"] == 40 and math.isfinite(played["total_reward"])


def _state_leaves(state):
    """Every tensor and scalar of a TrainState, the generator as its state."""
    out = []
    for field in state:
        if isinstance(field, torch.Generator):
            out.append(field.get_state())
        elif isinstance(field, tuple):
            out.extend(field)
        else:
            out.append(field)
    return out


def test_bitwise_resume(tmp_path):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=32, rollout_len=8, num_epochs=1, num_minibatches=2,
                        hidden=(16, 16), fused_update="on")
    ref = ppo.init_train_state(env, cfg, 5, device="cpu")
    for _ in range(4):
        ref, _ = ppo.train_step(env, cfg, ref)

    state = ppo.init_train_state(env, cfg, 5, device="cpu")
    for _ in range(2):
        state, _ = ppo.train_step(env, cfg, state)
    ckpt.save(str(tmp_path / "mid"), state)
    del state
    restored = ckpt.restore(str(tmp_path / "mid"), ppo.init_train_state(env, cfg, 99, device="cpu"))
    for _ in range(2):
        restored, _ = ppo.train_step(env, cfg, restored)

    assert restored.update_step == ref.update_step == 4
    for a, b in zip(_state_leaves(ref), _state_leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_restore_refuses_another_structure(tmp_path):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=32, rollout_len=8, hidden=(16, 16))
    path = str(tmp_path / "ck")
    ckpt.save(path, ppo.init_train_state(env, cfg, 0, device="cpu"))
    for other in (cfg._replace(hidden=(32, 32)), cfg._replace(num_envs=64)):
        with pytest.raises(ckpt.CheckpointStructureError, match="num_envs"):
            ckpt.restore(path, ppo.init_train_state(env, other, 0, device="cpu"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "missing"), ppo.init_train_state(env, cfg, 0, device="cpu"))


def test_checkpoint_manager_rotates_and_restores_the_latest(tmp_path):
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=16, rollout_len=4, hidden=(8, 8))
    target = ppo.init_train_state(env, cfg, 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "run"), keep=2, save_interval=2)
    assert mgr.restore_latest(target) == (target, None)
    saved = [mgr.save(step, target._replace(update_step=step)) for step in range(7)]
    assert saved == [True, False, True, False, True, False, True]
    assert [s for s, _ in mgr._step_dirs()] == [4, 6] and mgr.latest_step() == 6
    assert mgr.save(7, target._replace(update_step=7), force=True)
    restored, step = mgr.restore_latest(target)
    assert step == 7 and restored.update_step == 7
    assert torch.equal(restored.params, target.params)


@pytest.mark.parametrize("mode", ["--shard_map", "mesh"])
def test_cli_trains_on_two_ranks_under_torchrun(mode, tmp_path):
    """``torch.distributed.run --nproc_per_node=2`` on the CPU (gloo): 3
    updates of the shard_map step or of the mesh mode, rank 0 alone logging
    (3 lines, not 6), finite metrics, a collective checkpoint of 2 shards."""
    import os
    import subprocess
    import sys

    ck = tmp_path / "ck"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "reinmav_tpu_torch.rl.run", *SMALL, "--num_timesteps=3072", "--log_interval=1",
           f"--save_path={ck}", *([mode] if mode == "--shard_map" else [])]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rows = [row for row in _lines(out.stdout) if "env_steps" in row]
    assert [row["env_steps"] for row in rows] == [1024.0, 2048.0, 3072.0], out.stdout[-3000:]
    for row in rows:
        assert all(math.isfinite(v) for v in row.values()), row
    assert sorted(p.name for p in ck.iterdir()) == ["shard_0.pt", "shard_1.pt", "train_state.pt"]


def test_cli_trains_with_bf16_products(capsys):
    """--compute_dtype=bfloat16 on the CPU: one update through the eager
    loop and autograd, finite metrics."""
    run.main([*SMALL, "--compute_dtype=bfloat16", "--num_timesteps=1024", "--log_interval=1"])
    (row,) = [r for r in _lines(capsys.readouterr().out) if "env_steps" in r]
    assert row["env_steps"] == 1024.0 and all(math.isfinite(v) for v in row.values()), row


def test_cli_flags_are_the_jax_clis_plus_device():
    from reinmav_tpu.rl import run as jrun

    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    ours, theirs = flags(run.build_parser()), flags(jrun.build_parser())
    assert set(ours) == set(theirs) | {"device"} and ours.pop("device") == "cuda"
    assert ours == theirs


def test_cli_gif_without_its_renderer_exits_before_training(monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with pytest.raises(SystemExit, match="--gif needs matplotlib, which is not installed"):
        run.main([*SMALL, "--play", "--gif=out.gif"])


GRU = ["--device=cpu", "--network=gru", "--env=quadrotor2d-v0", "--num_env=32",
       "--rollout_len=16", "--num_hidden=16"]


def test_cli_gru_train_save_play_with_html_and_gif(tmp_path, capsys):
    """tests/test_recurrent.py's round trip on the port: train a few
    updates, checkpoint, then --play restores it and writes the HTML
    animation and the GIF of the greedy rollout."""
    save, html, gif = (str(tmp_path / n) for n in ("gru_ckpt", "gru_play.html", "gru_play.gif"))
    run.main([*GRU, "--num_timesteps=1024", "--log_interval=1", "--updates_per_jit=2",
              f"--save_path={save}"])
    train = [row for row in _lines(capsys.readouterr().out) if "env_steps" in row]
    assert [row["env_steps"] for row in train] == [1024.0]
    assert all(math.isfinite(v) for v in train[0].values())
    assert {"loss", "pg_loss", "v_loss", "ratio_dev", "mean_reward"} <= set(train[0])
    run.main([*GRU, "--play", "--play_steps=60", f"--load_path={save}", f"--html={html}",
              f"--gif={gif}"])
    (played,) = _lines(capsys.readouterr().out)
    assert played["play_steps"] == 60 and played["html"] == html and played["gif"] == gif
    assert math.isfinite(played["total_reward"])
    with open(html) as f:
        assert len(f.read()) > 1000
    with open(gif, "rb") as f:
        assert f.read(3) == b"GIF"
    with pytest.raises(SystemExit, match="--network=gru supports --alg=ppo only"):
        run.main([*GRU, "--alg=a2c"])


@pytest.mark.parametrize("alg", ["sac", "td3", "ddpg"])
def test_cli_offpolicy_ignores_network_gru(alg, capsys):
    """As the JAX CLI (reinmav_tpu/rl/run.py:533-542): --network=gru with an
    off-policy --alg trains the off-policy learner; only the on-policy
    algorithms other than ppo are refused."""
    run.main([*SMALL, f"--alg={alg}", "--network=gru", "--buffer_capacity=1024",
              "--batch_size=64", "--warmup_steps=0", "--num_timesteps=128", "--log_interval=1"])
    rows = [row for row in _lines(capsys.readouterr().out) if "env_steps" in row]
    assert [row["env_steps"] for row in rows] == [64.0, 128.0]
    for row in rows:
        assert "buffer_filled" in row and all(math.isfinite(v) for v in row.values()), row


def test_cli_gru_resume_is_bitwise(tmp_path, capsys):
    """4 updates straight against 2, a checkpoint, and 2 more resumed from
    it through --load_path: every leaf of the saved states equal."""
    steps = 32 * 16
    run.main([*GRU, f"--num_timesteps={4 * steps}", f"--save_path={tmp_path / 'straight'}"])
    run.main([*GRU, f"--num_timesteps={2 * steps}", f"--save_path={tmp_path / 'half'}"])
    run.main([*GRU, f"--num_timesteps={2 * steps}", f"--load_path={tmp_path / 'half'}",
              f"--save_path={tmp_path / 'resumed'}"])
    capsys.readouterr()
    env = reinmav_tpu_torch.make("quadrotor2d-v0")
    target = recurrent.init_train_state(env, run.recurrent_config(run.build_parser().parse_args(
        GRU)), 99, device="cpu")
    ref = ckpt.restore(str(tmp_path / "straight"), target)
    got = ckpt.restore(str(tmp_path / "resumed"), target)
    assert ref.update_step == got.update_step == 4
    for a, b in zip(_state_leaves(ref), _state_leaves(got)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_gru_play_threads_and_masks_the_hidden():
    """The play loop's hidden carries between steps and is masked after an
    episode's end: held against policy_step run by hand, on an env cut to
    3-step episodes by a time limit (a truncation masks in play)."""
    from reinmav_tpu_torch.envs import wrappers

    args = run.build_parser().parse_args([*GRU, "--play", "--play_steps=7"])
    env = wrappers.time_limit(reinmav_tpu_torch.make("quadrotor2d-v0"), 3)
    cfg = run.recurrent_config(args)
    state = recurrent.init_train_state(env, cfg, 0, device="cpu")
    state = state._replace(params=state.params + 0.05)  # a policy head that acts
    played, total, episodes = run._greedy_rollout(env, args, "cpu",
                                                  *run.recurrent_play_policy(env, cfg, state))
    assert played.shape == (7, env.obs_dim) and episodes == 2

    tree = recurrent.GruLayout.of(env, cfg).unflatten(state.params)
    h, d, ref = torch.zeros((16, 1)), torch.zeros(1), []
    s = env.reset(torch.Generator().manual_seed(args.seed + 1))
    for t in range(7):
        h, mean, _, _ = recurrent.policy_step(tree, h, s[:env.obs_dim, None], d)
        out = env.step(s, mean[:, 0])
        ref.append(out.obs)
        ended = bool(out.done) or bool(out.truncated)
        d = torch.full((1,), float(ended))
        s = env.reset(torch.Generator().manual_seed(args.seed + 3 + t)) if ended else out.state
    assert torch.equal(played, torch.stack(ref))
    # Without the mask (no observe), the rollout differs after the first
    # episode's end.
    policy, _ = run.recurrent_play_policy(env, cfg, state)
    played_no_mask, _, _ = run._greedy_rollout(env, args, "cpu", policy)
    assert torch.equal(played_no_mask[:3], played[:3]) and not torch.equal(played_no_mask, played)


def test_cli_play_serves_the_live_view(tmp_path, capsys):
    """--play --live --live_port=0 on the PPO, the GRU and the SAC paths:
    the URL of the bound server is printed, the rollout runs, the server
    is closed afterwards."""
    import urllib.error
    import urllib.request

    sac = ["--alg=sac", "--buffer_capacity=1024", "--batch_size=64", "--warmup_steps=128"]
    for flags in (["--alg=ppo"], GRU[1:], sac):
        # One short training call, then the play of its state.
        run.main([*SMALL, *flags, "--num_timesteps=1024", "--log_interval=100", "--play",
                  "--play_steps=20", "--live", "--live_port=0"])
        out = capsys.readouterr().out
        (url,) = [line.split(": ", 1)[1] for line in out.splitlines()
                  if line.startswith("# live view: ")]
        assert url.startswith("http://127.0.0.1:") and url.endswith("/")
        (played,) = [row for row in _lines(out) if "play_steps" in row]
        assert played["play_steps"] == 20
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(url, timeout=5)


def test_metrics_logger_writes_jsonl_and_csv(tmp_path, capsys):
    logger = MetricsLogger(log_dir=str(tmp_path), csv=True, config={"lr": 3e-4})
    logger.log(1, {"loss": torch.tensor(0.5), "count": torch.tensor(3, dtype=torch.int32),
                   "name": "x"})
    logger.close()
    (row,) = _lines(capsys.readouterr().out)
    assert (row["step"], row["loss"], row["count"], row["name"]) == (1, 0.5, 3.0, "x")
    jsonl = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert json.loads(jsonl[0]) == {"config": {"lr": 3e-4}} and json.loads(jsonl[1]) == row
    csv = (tmp_path / "metrics.csv").read_text().splitlines()
    assert csv[0] == "step,wall_s,loss,count,name" and csv[1].startswith("1,")


def test_evaluate_policy_matches_jax_from_the_same_states():
    jenv = reinmav_tpu.make("quadrotor3d-v0")
    key = jax.random.PRNGKey(4)
    num_envs, horizon = 64, 60
    ref = jevaluate.evaluate_policy(jenv, jenv.vcontrol, key, num_envs=num_envs, horizon=horizon)
    assert int(ref.num_episodes) == 0  # no env ends on this horizon
    k_reset, _ = jax.random.split(key)  # evaluate_policy's own draw of the initial states
    states = torch.from_numpy(np.array(jenv.vreset(jax.random.split(k_reset, num_envs))))
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    got = evaluate._rollout_stats(env, env.vcontrol, states, torch.Generator().manual_seed(0),
                                  horizon)
    assert int(got.num_episodes) == 0
    assert math.isnan(float(got.mean_return)) and math.isnan(float(got.mean_length))
    assert math.isnan(float(ref.mean_return)) and math.isnan(float(ref.mean_length))
    for name in ("mean_reward", "mean_running_return", "survival_frac"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(ref, name)),
                                   rtol=1e-9, err_msg=name)

    params = ppo.init_train_state(env, ppo.PpoConfig(num_envs=8, rollout_len=4), 0,
                                  device="cpu").params
    stats = evaluate.evaluate(env, params, None, torch.Generator().manual_seed(1), num_envs=16,
                              horizon=20)
    assert 0.0 <= float(stats.survival_frac) <= 1.0 and math.isfinite(float(stats.mean_reward))
