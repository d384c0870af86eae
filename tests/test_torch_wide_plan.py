"""The plan of the wide K3/K4 body (``reinmav_tpu_torch.ops.ppo_loss.wide_plan``),
which the wrappers compute and pass with each launch, and which the kernels
recompute (``csrc/ppo_loss_body_wide.cuh::make_shape``) and refuse when it
differs: at every hidden width from 1 to 256, over obs dims up to 32 and
action dims up to 8, in both dtypes, its shared memory fits a CTA on sm_90
and its units and obs rows are padded to the next multiple of 16 (the
kernels' n16 blocks); the grid takes every sub-block of a minibatch exactly
once a tower.  On the CPU: no kernel runs.
"""

import pytest

from reinmav_tpu_torch.ops import ppo_loss as pl

OBS = (1, 5, 9, 10, 13, 16, 17, 32)
ACTIONS = (1, 2, 4, 8)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plan_fits_and_takes_every_unit_once(bf16):
    for h in range(1, pl.WIDE_MAX_HIDDEN + 1):
        for d in OBS:
            for a in ACTIONS:
                plan = pl.wide_plan(d, a, h, bf16)
                where = f"(d, a, h, bf16) = ({d}, {a}, {h}, {bf16})"
                assert plan["smem_bytes"] <= pl.WIDE_SMEM_LIMIT, where
                units, rows = plan["units"], plan["obs_rows"]
                assert units % 16 == 0 and h <= units < h + 16, where
                assert rows % 16 == 0 and d <= rows < d + 16, where


def test_plan_at_the_main_path_widths():
    """(10, 4) at 256 and 128: the numbers the kernels' ppo_wide_plan gives
    on the card (its C computation, checked by the wrappers there)."""
    f32 = pl.wide_plan(10, 4, 256, False, 262_144, 132)
    assert (f32["samples"], f32["sp"], f32["units"], f32["obs_rows"]) == (64, 72, 256, 16)
    assert f32["group"] == (1 + 3 * 16) * 8 * 32 and f32["groups"] == 63
    assert f32["packed"] == 2 * 2 * (16 * 2 + 2 * 16 * 32) * 32
    bf = pl.wide_plan(10, 4, 128, True, 262_144, 132)
    assert (bf["sp"], bf["group"], bf["groups"]) == (68, (1 + 3 * 8) * 4 * 32, 63)
    assert bf["packed"] == 2 * ((8 * 1 + 2 * 8 * 8) * 32 + (128 * 16 + 128 * 128) // 8)
    assert max(pl.wide_plan(32, 8, 256, bf16, 1, 2)["smem_bytes"] for bf16 in (False, True)) \
        == 213_376


@pytest.mark.parametrize("sms", [132, 8, 2])
def test_grid_takes_every_sub_block_once_a_tower(sms):
    for mb in (1, 63, 64, 65, 160, 4096, 128 * 201, 262_144):
        blocks = pl.wide_grid(mb, sms)
        assert blocks >= 2 and blocks % 2 == 0 and blocks <= sms, (mb, sms)
        sub = -(-mb // pl.WIDE_SAMPLES)
        groups = pl.wide_plan(10, 4, 64, False, mb, blocks)["groups"]
        ctas = blocks // 2
        for tower in (0, 1):
            taken = []
            for cta in range(ctas):
                mine = list(range(cta, sub, ctas))
                assert len(mine) <= groups, (mb, sms, tower, cta)
                taken += mine
            assert sorted(taken) == list(range(sub)), (mb, sms, tower)
