"""The PPO twin's logp -> ratio rounding (reinmav_tpu_torch.ops.ppo_loss.logp_ratio)
and value head (``value_head``), the orders that K3/K4's body
(csrc/ppo_loss_body.cuh) copies, held bit for bit to NumPy float32
arithmetic one operation at a time: quad = diff * diff / var, qsum and
ls_sum added left to right from 0 over the action dim, logp = ((-0.5 qsum)
- ls_sum) - 0.5 A log(2 pi), ratio = exp(logp - old_logp); the value as
products and sums rounded apart in unit order, then the bias.  On samples
placed within a few ulps of the clip edge 1 +- clip_eps, a ratio that
rounds otherwise would clip in one and not in the other.  Exact: no
tolerance."""

import math

import numpy as np
import pytest
import torch

from reinmav_tpu_torch.ops import ppo_loss as pl

F = np.float32
CLIP_EPS = 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _numpy_logp(diff, var, ls):
    """logp in float32, one rounded operation at a time, left to right."""
    a = diff.shape[0]
    quad = (diff * diff) / var
    qsum = np.zeros(diff.shape[1], F)
    ls_sum = F(0.0)
    for i in range(a):
        qsum = (qsum + quad[i]).astype(F)
        ls_sum = F(ls_sum + ls[i])
    return ((F(-0.5) * qsum - ls_sum) - F(0.5 * a * math.log(2.0 * math.pi))).astype(F)


def _edge_samples(rng, a, n, edge):
    """diff, var, ls and old_logp such that ratio = exp(logp - old_logp)
    lies within a few ulps of ``edge``."""
    ls = rng.uniform(-1.0, 0.5, a).astype(F)
    var = np.exp(F(2.0) * ls).astype(F)[:, None]
    diff = rng.normal(0.0, 1.0, (a, n)).astype(F)
    logp = _numpy_logp(diff, var, ls)
    old = (logp.astype(np.float64) - math.log(edge)).astype(F)
    step = np.spacing(np.abs(old)).astype(F)
    old = (old + step * rng.integers(-4, 5, n).astype(F)).astype(F)
    return diff, var, ls, old


@pytest.mark.parametrize("a", [2, 4])
@pytest.mark.parametrize("edge", [1.0 - CLIP_EPS, 1.0 + CLIP_EPS])
def test_logp_ratio_is_numpy_float32_one_operation_at_a_time(a, edge):
    rng = np.random.default_rng(12 + a)
    diff, var, ls, old = _edge_samples(rng, a, 4096, edge)
    quad, logp, ratio = pl.logp_ratio(torch.from_numpy(diff), torch.from_numpy(var),
                                      torch.from_numpy(ls), torch.from_numpy(old))
    want = _numpy_logp(diff, var, ls)
    np.testing.assert_array_equal(quad.numpy(), (diff * diff) / var)
    np.testing.assert_array_equal(logp.numpy(), want)
    arg = (want - old).astype(F)
    np.testing.assert_array_equal(ratio.numpy(), torch.exp(torch.from_numpy(arg)).numpy())
    # The samples straddle the edge: both sides of the clip are live.
    eps = F(CLIP_EPS)
    inside = np.abs(ratio.numpy() - F(1.0)) < eps
    assert 0 < inside.sum() < inside.size


def test_the_sum_over_the_action_dim_runs_left_to_right():
    """quad = [2^20, 2^-4, 2^-4, 2^-4]: left to right each small term is
    half an ulp of 2^20 and rounds away (to even), in pairs they survive
    ((2^20 + 2^-4) + (2^-4 + 2^-4) = 2^20 + 2^-3), and so does the
    difference in logp."""
    diff = np.array([[1024.0], [0.25], [0.25], [0.25]], F)
    var = np.ones((4, 1), F)
    ls = np.zeros(4, F)
    old = np.zeros(1, F)
    _, logp, _ = pl.logp_ratio(torch.from_numpy(diff), torch.from_numpy(var),
                               torch.from_numpy(ls), torch.from_numpy(old))
    left_to_right = F(-0.5) * F(2.0 ** 20) - F(2.0 * math.log(2.0 * math.pi))
    pairwise = F(-0.5) * F(2.0 ** 20 + 2.0 ** -3) - F(2.0 * math.log(2.0 * math.pi))
    assert left_to_right != pairwise
    assert logp.numpy()[0] == left_to_right


def test_value_head_rounds_each_product_and_sum_apart():
    rng = np.random.default_rng(7)
    h = np.tanh(rng.normal(0.0, 1.0, (64, 4096))).astype(F)
    w = rng.normal(0.0, 0.2, 64).astype(F)
    b = F(0.37)
    want = np.zeros(4096, F)
    for j in range(64):
        want = (want + (h[j] * w[j]).astype(F)).astype(F)
    want = (want + b).astype(F)
    got = pl.value_head(torch.from_numpy(h), torch.from_numpy(w), torch.tensor(b))
    np.testing.assert_array_equal(got.numpy(), want)
    fused = (h.astype(np.float64) * w[:, None]).sum(axis=0).astype(F) + b
    assert not np.array_equal(fused, want)  # the order shows in the bits
