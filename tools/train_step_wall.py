"""The wall of PPO ``train_step`` on the card, per update, at two equal
hidden widths: the default path of the ``reinmav_tpu_torch`` beside this
script's folder (or under ``--root``), so that two trees can be run in
turns and their walls compared within one machine.

    python tools/train_step_wall.py --hidden 256 128 --dtype float32 bfloat16

For each (width, dtype) it builds a train state on quadrotor3d-v0 at
``--num_envs`` x ``--rollout_len`` (seed 0; 4 epochs x 4 minibatches, the
config's defaults), runs ``--warmup`` updates, then times ``--updates``
more, each between two ``torch.cuda.synchronize()``, and prints one JSON
line: the walls in ms, their median, the learner's log line that names
the update's path, and the card (``nvidia-smi`` name and power limit).
It needs a CUDA card and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import logging
import statistics
import subprocess
import sys
import time
from pathlib import Path


def gpu_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class _PathLog(logging.Handler):
    """Keeps the learner's log lines that name the update's path."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        msg = record.getMessage()
        if "update:" in msg:
            self.lines.append(msg)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="the tree whose reinmav_tpu_torch is timed")
    parser.add_argument("--hidden", type=int, nargs="+", default=[256, 128])
    parser.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"])
    parser.add_argument("--num_envs", type=int, default=32768)
    parser.add_argument("--rollout_len", type=int, default=32)
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument("--updates", type=int, default=3)
    parser.add_argument("--label", default="", help="a tag copied into every line")
    args = parser.parse_args(argv)
    sys.path.insert(0, args.root)

    import torch

    if not torch.cuda.is_available():
        print("train_step_wall: no CUDA card", file=sys.stderr)
        return 1
    import reinmav_tpu_torch
    from reinmav_tpu_torch.rl import ppo

    log = _PathLog()
    logger = logging.getLogger("reinmav_tpu_torch.rl.ppo")
    logger.setLevel(logging.INFO)
    logger.addHandler(log)
    gpu = gpu_label()
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    for h in args.hidden:
        for dtype in args.dtype:
            cfg = ppo.PpoConfig(num_envs=args.num_envs, rollout_len=args.rollout_len,
                                hidden=(h, h), compute_dtype=dtype)
            state = ppo.init_train_state(env, cfg, 0, device="cuda")
            log.lines.clear()
            walls = []
            for i in range(args.warmup + args.updates):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, summary = ppo.train_step(env, cfg, state)
                torch.cuda.synchronize()
                if i >= args.warmup:
                    walls.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({
                "label": args.label, "root": args.root, "hidden": h, "dtype": dtype,
                "num_envs": args.num_envs, "rollout_len": args.rollout_len, "walls_ms": walls,
                "median_ms": statistics.median(walls),
                "mean_reward": float(summary["mean_reward"]),
                "path": log.lines[-1] if log.lines else None, "gpu": gpu}), flush=True)
            del state
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
