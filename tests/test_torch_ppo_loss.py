"""Kernel K3's plain twin (reinmav_tpu_torch.ops.ppo_loss) against the JAX
package's K3 (``pallas_ppo.ppo_loss_grads_pallas_gather``, run in
interpret mode as tests/test_pallas_ppo.py runs it), against
``jax.value_and_grad(ppo.ppo_loss)`` and against ``torch.autograd`` of the
port's own ``ppo_loss``, on the CPU in float32.

Clip and KL modes, with and without the entropy term, with the gather
through a non-identity tile permutation and a non-trivial advantage
normalisation; at the obs dim of quadrotor3d-v0 (10) and, in the cases
marked ``hover``, of the tpuquad family (13), the two dims the kernel is
built for.  Tolerances are the JAX package's own
(tests/test_pallas_ppo.py): metrics rtol 2e-4 / atol 1e-6, gradients
rtol 2e-3 / atol 2e-6.  The JAX kernel's fused gradients are compared
on the tower blocks ``ppo._unfuse_grads`` keeps; the port computes only
those.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinmav_tpu.ops import pallas_ppo
from reinmav_tpu.rl import networks as jnet
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu_torch.ops import ppo_loss as pl
from reinmav_tpu_torch.rl import networks, ppo

D, A, N, TILE = 10, 4, 1024, 128
PERM = [5, 2, 7, 0]  # 4 of the 8 tiles, out of order
ADV_SHIFT, ADV_INV, BETA = 0.1, 1.3, 0.7
METRIC_TOL = dict(rtol=2e-4, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=2e-6)
MODES = [("clip", 0.0), ("clip", 1e-2), ("kl", 0.0), ("kl", 1e-2)]
#: MODES at D = 10 (their ids unchanged), and two of them at D = 13.
CASES = ([pytest.param(m, e, D, id=f"{m}-{e}") for m, e in MODES]
         + [pytest.param(m, e, 13, id=f"{m}-{e}-hover") for m, e in (("clip", 1e-2), ("kl", 0.0))])


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _case(seed, d=D):
    """Params (log_std off its init) and a float32 batch from a NumPy seed."""
    params = jnet.init_params(jax.random.PRNGKey(seed), jnet.MlpConfig(d, A, (64, 64)))
    params["log_std"] = params["log_std"] + 0.1
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    obs, act = f32(d, N), f32(A, N)
    old_logp = f32(N) * np.float32(0.3) - np.float32(4.0)
    old_value = f32(N)
    adv = f32(N)
    ret = old_value + f32(N) * np.float32(0.5)
    return params, (obs, act, old_logp, old_value, adv, ret)


def _cfg(mode, ent):
    return dict(clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, ent_coef=ent,
                kl_mode=mode == "kl")


def _port(params, batch, mode, ent):
    data = pl.stack_batch(*(torch.from_numpy(x) for x in batch))
    stats = torch.tensor([ADV_SHIFT, ADV_INV, BETA if mode == "kl" else 0.0, 0.0])
    net = networks.params_from_jax(_np_tree(params))
    return pl.ppo_loss_grads_gather(data, stats, torch.tensor(PERM, dtype=torch.int32), net,
                                    d=batch[0].shape[0], adim=A, tile=TILE, **_cfg(mode, ent))


def _flat(tree):
    return networks.params_from_jax(_np_tree(tree)).numpy()


def _minibatch(batch):
    cols = (np.asarray(PERM)[:, None] * TILE + np.arange(TILE)).reshape(-1)
    obs, act, old_logp, old_value, adv, ret = (x[..., cols] for x in batch)
    adv = (adv - np.float32(ADV_SHIFT)) * np.float32(ADV_INV)
    return obs, act, old_logp, old_value, adv, ret


@pytest.mark.parametrize("mode,ent,d", CASES)
def test_twin_matches_jax_kernel_in_interpret_mode(mode, ent, d):
    from jax.experimental.pallas import tpu as pltpu

    params, batch = _case(0, d)
    grads, metrics = _port(params, batch, mode, ent)
    layers, wo, bo = jnet.fused_weights(params)
    (w1, b1), (w2, b2) = layers
    data = pallas_ppo.stack_batch(*(jnp.asarray(x) for x in batch))
    stats = jnp.asarray([[ADV_SHIFT, ADV_INV, BETA if mode == "kl" else 0.0, 0.0]], jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        j_g, j_m = pallas_ppo.ppo_loss_grads_pallas_gather(
            data, stats, jnp.asarray(PERM, jnp.int32), w1, b1, w2, b2, wo, bo,
            params["log_std"], d=d, adim=A, tile=TILE, compute_dtype="float32",
            **_cfg(mode, ent))
    for name in pl.METRICS:
        np.testing.assert_allclose(float(metrics[name]), float(j_m[name]), **METRIC_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(grads.numpy(), _flat(jppo._unfuse_grads(j_g, 64, A)), **GRAD_TOL)


@pytest.mark.parametrize("mode,ent", MODES)
def test_twin_matches_jax_autodiff(mode, ent):
    params, batch = _case(1)
    grads, metrics = _port(params, batch, mode, ent)
    obs, act, old_logp, old_value, adv, ret = (jnp.asarray(x) for x in _minibatch(batch))
    cfg = jppo.PpoConfig(entropy_coef=ent, kl_target=0.01 if mode == "kl" else None)
    mb = jppo.Transition(obs, act, old_logp, old_value, jnp.zeros_like(adv),
                         jnp.zeros(adv.shape, bool))
    (_, j_m), j_g = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        params, cfg, mb, adv, ret, None, jnp.float32(BETA) if mode == "kl" else None)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(metrics[name]), float(j_m[name]), **METRIC_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(grads.numpy(), _flat(j_g), **GRAD_TOL)


@pytest.mark.parametrize("mode,ent,d", CASES)
def test_twin_matches_torch_autograd(mode, ent, d):
    params, batch = _case(2, d)
    grads, metrics = _port(params, batch, mode, ent)
    obs, act, old_logp, old_value, adv, ret = (torch.from_numpy(x) for x in _minibatch(batch))
    cfg = ppo.PpoConfig(entropy_coef=ent, kl_target=0.01 if mode == "kl" else None)
    net = networks.params_from_jax(_np_tree(params)).requires_grad_(True)
    mb = ppo.Transition(obs, act, old_logp, old_value, torch.zeros_like(adv),
                        torch.zeros(adv.shape, dtype=torch.bool))
    loss, ref_m = ppo.ppo_loss(networks.Layout(d, A).unflatten(net), cfg, mb, adv, ret, None,
                               torch.tensor(BETA) if mode == "kl" else None)
    (ref_g,) = torch.autograd.grad(loss, net)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(metrics[name]), float(ref_m[name].detach()), **METRIC_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(grads.numpy(), ref_g.numpy(), **GRAD_TOL)


def test_contiguous_form_and_other_widths():
    """ppo_loss_grads (the whole batch as one tile) equals the gather form
    over the identity permutation, and the twin takes other widths."""
    params, batch = _case(3)
    net = networks.params_from_jax(_np_tree(params))
    tensors = [torch.from_numpy(x) for x in batch]
    cfg = dict(clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, ent_coef=0.0)
    g1, m1 = pl.ppo_loss_grads(*tensors, net, **cfg)
    g2, m2 = pl.ppo_loss_grads_gather(
        pl.stack_batch(*tensors), torch.tensor([0.0, 1.0, 0.0, 0.0]),
        torch.arange(N // TILE, dtype=torch.int32), net, d=D, adim=A, tile=TILE, **cfg)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-5, atol=1e-8)
    for name in pl.METRICS:
        np.testing.assert_allclose(float(m1[name]), float(m2[name]), rtol=1e-5)
    small = jnet.init_params(jax.random.PRNGKey(4), jnet.MlpConfig(D, A, (16, 16)))
    g3, _ = pl.ppo_loss_grads(*tensors, networks.params_from_jax(_np_tree(small)), hidden=16,
                              **cfg)
    assert g3.shape == (networks.Layout(D, A, (16, 16)).size,) and torch.isfinite(g3).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    params, batch = _case(5)
    data = pl.stack_batch(*(torch.from_numpy(x) for x in batch))
    net = networks.params_from_jax(_np_tree(params))
    stats = torch.tensor([0.0, 1.0, 0.0, 0.0])
    perm = torch.tensor(PERM, dtype=torch.int32)
    kw = dict(d=D, adim=A, clip_eps=0.2, value_clip_eps=0.2, value_coef=0.5, ent_coef=0.0)
    before = pl.ppo_loss_grads_gather.launches
    with pytest.raises(TypeError, match="data"):
        pl.ppo_loss_grads_gather(data.double(), stats, perm, net, tile=TILE, **kw)
    with pytest.raises(ValueError, match="perm"):
        pl.ppo_loss_grads_gather(data, stats, perm.long(), net, tile=TILE, **kw)
    with pytest.raises(ValueError, match="tile"):
        pl.ppo_loss_grads_gather(data, stats, perm, net, tile=100, **kw)
    with pytest.raises(ValueError, match="rows"):
        pl.ppo_loss_grads_gather(data[1:].contiguous(), stats, perm, net, tile=TILE, **kw)
    with pytest.raises(ValueError, match="net"):
        pl.ppo_loss_grads_gather(data, stats, perm, net[:-1], tile=TILE, **kw)
    pl.ppo_loss_grads_gather(data, stats, perm, net, tile=TILE, **kw)
    assert pl.ppo_loss_grads_gather.launches == before  # the CPU ran the twin
    # The widths the kernel is built for, as the learner's refusal names them.
    assert pl.kernel_dims_refusal(10, 4, (64, 64)) is None
    assert pl.kernel_dims_refusal(13, 4, (64, 64)) is None
    assert "(10, 4), (13, 4)" in pl.kernel_dims_refusal(7, 4, (64, 64))
    assert "hidden" in pl.kernel_dims_refusal(13, 4, (32, 32))
    for d, a in ((5, 2), (9, 2), (16, 4)):
        assert pl.kernel_dims_refusal(d, a, (64, 64)) is None
    with pytest.raises(ValueError, match="K3 kernel refuses obs/action dims"):
        pl.require_kernel_dims("K3", 16, 2, 64)
