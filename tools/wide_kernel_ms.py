"""The card time of the wide K3 and K4 instances (``ppo_loss_wide.cu``,
``ppo_update_wide.cu``) of the ``reinmav_tpu_torch`` under ``--root`` (this
script's tree by default), so that two trees can be timed in turns within
one machine:

    python tools/wide_kernel_ms.py --root OTHER_TREE --hidden 256 128 --label parent

For each hidden width and dtype it builds phase 45's inputs
(``chip_smoke.py`` of this script's tree: K3 wide on one 262,144-sample
minibatch at (10, 4), K4 wide on one 4 x 4 update of the eager rollout of
quadrotor3d-v0 at 32,768 x 32), times ``--reps`` launches of each between
CUDA events after one warm-up, and prints one JSON line: the medians and
ranges in ms, the twin-free launch counts, and the card (``nvidia-smi``
name and power limit).  It needs a CUDA card and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE), help="the tree whose kernels are timed")
    parser.add_argument("--hidden", type=int, nargs="+", default=[256, 128])
    parser.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--label", default="", help="a tag copied into every line")
    args = parser.parse_args(argv)
    sys.path.insert(0, args.root)
    sys.path.insert(1, str(HERE))

    import torch

    if not torch.cuda.is_available():
        print("wide_kernel_ms: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import reinmav_tpu_torch
    from reinmav_tpu_torch.ops import ppo_loss as pl
    from reinmav_tpu_torch.ops import ppo_update as pu

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_label()
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    d, a = env.obs_dim, env.action_dim
    for h in args.hidden:
        data, tidx, stats, net = cs.wide_k3_inputs(torch, dev, d, a, h, 45 + h)
        kcfg = dict(d=d, adim=a, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5,
                    tile=cs.TILE_WIDE, hidden=h)
        cfg, params, traj, adv, tile, n_tiles = cs.wide_trajectory(torch, dev, env, h)
        perm_all, k4_stats, params, opt, kw = cs.k4_setup(torch, dev, cfg, params, adv, tile,
                                                          n_tiles, d, a)
        kw["hidden"] = h
        for dtype in args.dtype:
            cd = None if dtype == "float32" else dtype
            k3 = lambda: pl.ppo_loss_grads_gather(data, stats, tidx, net, ent_coef=0.01,  # noqa: E731
                                                  compute_dtype=cd, **kcfg)
            k4 = lambda: pu.ppo_update(traj, k4_stats, perm_all, params, opt, None,  # noqa: E731
                                       compute_dtype=cd, **kw)
            before = (pl._launch_wide.launches, pu._launch_wide.launches)
            k3()
            k4()
            k3_ms, _ = cs.cuda_ms(k3, args.reps)
            k4_ms, _ = cs.cuda_ms(k4, args.reps)
            launches = (pl._launch_wide.launches - before[0], pu._launch_wide.launches - before[1])
            print(json.dumps({
                "label": args.label, "root": args.root, "hidden": h, "dtype": dtype,
                "k3_ms": statistics.median(k3_ms), "k3_range": [min(k3_ms), max(k3_ms)],
                "k4_ms": statistics.median(k4_ms), "k4_range": [min(k4_ms), max(k4_ms)],
                "launches": {"K3 wide": launches[0], "K4 wide": launches[1]},
                "k3_at": f"minibatch of {cs.MB_WIDE}, ({d}, {a}), hidden ({h}, {h})",
                "k4_at": f"{cfg.num_epochs} x {cfg.num_minibatches} passes at "
                         f"{cfg.num_envs} x {cfg.rollout_len}", "gpu": gpu}), flush=True)
        del data, tidx, stats, net, traj, params, opt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
