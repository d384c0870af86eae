"""The port's actor-critic (reinmav_tpu_torch.rl.networks) and optimiser
(reinmav_tpu_torch.rl.ppo.ClipAdam) against the JAX package, on the CPU.

The networks run in float64 on both sides from the same carried params
and agree to rtol 1e-12 (the same expressions; only the order of the
matmul sums differs).  The optimiser runs in float32 and agrees with
optax's ``chain(clip_by_global_norm(0.5), adam(3e-4, eps=1e-5))`` over
5 steps: params and first moments to rtol 1e-6 / atol 1e-9, second
moments to atol 1e-12 (float32 rounding of the same formulas; the
global norm is summed in another order, which moves every clipped
gradient by about 1e-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reinmav_tpu.rl import networks as jnet
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu_torch.rl import networks, ppo

F64 = torch.float64
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_params(seed, d=10, a=4, hidden=(64, 64), dtype=jnp.float64):
    params = jnet.init_params(jax.random.PRNGKey(seed), jnet.MlpConfig(d, a, hidden), dtype)
    params["log_std"] = params["log_std"] + 0.3
    rng = np.random.default_rng(seed)
    # Non-zero biases, so that every leaf is exercised.
    return jax.tree.map(lambda x: x + jnp.asarray(rng.normal(0, 0.1, x.shape), dtype), params)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("hidden", [(64, 64), (32, 32, 16)])
def test_layout_is_jax_leaf_order(hidden):
    params = _jax_params(0, hidden=hidden)
    flat = networks.params_from_jax(_np_tree(params), dtype=F64)
    expected = np.concatenate([np.ravel(x) for x in jax.tree.leaves(params)])
    np.testing.assert_array_equal(flat.numpy(), expected)
    layout = networks.Layout(10, 4, hidden)
    assert layout.size == flat.numel()
    tree = layout.unflatten(flat)
    for (path, ref), leaf in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                 jax.tree.leaves(jax.tree.map(lambda x: x, tree,
                                                              is_leaf=torch.is_tensor))):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref), err_msg=str(path))
    np.testing.assert_array_equal(layout.flatten(tree, dtype=F64).numpy(), expected)


def test_layout_rejects_wrong_shapes():
    layout = networks.Layout(10, 4)
    with pytest.raises(ValueError, match="flat params"):
        layout.unflatten(torch.zeros(layout.size + 1))
    tree = _np_tree(_jax_params(0))
    tree["pi"][1]["w"] = tree["pi"][1]["w"][:, :-1]
    with pytest.raises(ValueError, match=r"\('pi', 1, 'w'\)"):
        layout.flatten(tree)


def test_apply_t_and_log_prob_match_jax_float64():
    params = _jax_params(1)
    tree = networks.Layout(10, 4).unflatten(networks.params_from_jax(_np_tree(params), dtype=F64))
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(10, 257))
    act = rng.normal(size=(4, 257))
    mean, log_std, value = networks.apply_t(tree, torch.tensor(obs))
    j_mean, j_ls, j_value = jnet.apply_t(params, jnp.asarray(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=RTOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=RTOL)
    np.testing.assert_array_equal(log_std.numpy(), np.asarray(j_ls))
    lp = networks.gaussian_log_prob_t(mean, log_std, torch.tensor(act))
    j_lp = jnet.gaussian_log_prob_t(j_mean, j_ls, jnp.asarray(act))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), rtol=RTOL)
    np.testing.assert_allclose(float(networks.entropy(log_std)), float(jnet.entropy(j_ls)),
                               rtol=RTOL)
    # The fused stack is the JAX one, zero blocks included.
    layers, w_out, b_out = networks.fused_weights(tree)
    j_layers, j_w_out, j_b_out = jnet.fused_weights(params)
    for (w, b), (jw, jb) in zip(layers, j_layers):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(w_out.numpy(), np.asarray(j_w_out))
    np.testing.assert_array_equal(b_out.numpy(), np.asarray(j_b_out))


def test_sample_action_t_at_a_fixed_noise_matches_jax():
    """The port's sample with its generator's noise, against the JAX
    sample formula (``sample_action_t``: mean + exp(log_std) * noise,
    logp of that action) fed the same noise."""
    params = _jax_params(2)
    tree = networks.Layout(10, 4).unflatten(networks.params_from_jax(_np_tree(params), dtype=F64))
    obs = np.random.default_rng(2).normal(size=(10, 64))
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn((4, 64), generator=torch.Generator().manual_seed(5), dtype=F64)
    action, logp, value = networks.sample_action_t(tree, torch.tensor(obs), gen)
    j_mean, j_ls, j_value = jnet.apply_t(params, jnp.asarray(obs))
    j_action = j_mean + jnp.exp(j_ls)[:, None] * jnp.asarray(noise.numpy())
    np.testing.assert_allclose(action.numpy(), np.asarray(j_action), rtol=RTOL)
    np.testing.assert_allclose(
        logp.numpy(), np.asarray(jnet.gaussian_log_prob_t(j_mean, j_ls, j_action)), rtol=RTOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=RTOL)


def test_actor_critic_module_and_init():
    gen = torch.Generator().manual_seed(0)
    net = networks.ActorCritic(10, 4, generator=gen)
    assert net.flat.shape == (networks.Layout(10, 4).size,)
    p = net.params()
    for tower in ("pi", "vf"):
        w0 = p[tower][0]["w"].detach()
        # Orthogonal with gain sqrt(2): the rows of the (10, 64) weight are orthogonal.
        np.testing.assert_allclose((w0 @ w0.T).numpy(), 2.0 * np.eye(10), atol=1e-5)
        assert float(p[tower][0]["b"].detach().abs().max()) == 0.0
    wo = p["pi_out"]["w"].detach()
    np.testing.assert_allclose((wo.T @ wo).numpy(), 1e-4 * np.eye(4), atol=1e-8)
    assert float(p["log_std"].detach().abs().max()) == 0.0
    mean, _, value = net(torch.zeros(10, 3))
    assert mean.shape == (4, 3) and value.shape == (3,)
    (mean.sum() + value.sum()).backward()
    assert net.flat.grad is not None and float(net.flat.grad.abs().sum()) > 0
    # compute_dtype="bfloat16" runs (tests/test_torch_bf16_learners.py holds
    # it to the JAX package); any other compute dtype is refused.
    bf16 = networks.ActorCritic(10, 4, compute_dtype="bfloat16")
    bf_mean, _, bf_value = bf16(torch.ones(10, 3))
    assert bf_mean.dtype == bf_value.dtype == torch.float32 and bool(torch.isfinite(bf_mean).all())
    with pytest.raises(ValueError, match="compute_dtype"):
        networks.ActorCritic(10, 4, compute_dtype="float16")
    with pytest.raises(ValueError, match="compute_dtype"):
        networks.apply_t(p, torch.zeros(10, 3), compute_dtype="float16")


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["below-clip", "above-clip"])
def test_clip_adam_matches_optax(grad_scale):
    """5 steps of the port's optimiser against optax's chain from the same
    params and gradients: one leg whose gradients stay under the global
    norm 0.5, one whose gradients are clipped."""
    params = _jax_params(3, dtype=jnp.float32)
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4, eps=1e-5))
    opt_state = opt.init(params)
    cfg = ppo.PpoConfig()
    port_opt = ppo.make_optimizer(cfg)
    flat = networks.params_from_jax(_np_tree(params))
    state = port_opt.init(flat)
    rng = np.random.default_rng(3)
    for _ in range(5):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(0, grad_scale / 30.0, x.shape), jnp.float32), params)
        g_norm = float(optax.global_norm(grads))
        assert (g_norm < 0.5) == (grad_scale < 1.0)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        flat, state = port_opt.update(networks.params_from_jax(_np_tree(grads)), state, flat)
        ref = networks.params_from_jax(_np_tree(params))
        np.testing.assert_allclose(flat.numpy(), ref.numpy(), rtol=1e-6, atol=1e-9)
        carried = ppo.adam_state_from_jax(_np_tree(opt_state))
        assert int(state.count) == int(carried.count)
        np.testing.assert_allclose(state.mu.numpy(), carried.mu.numpy(), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(state.nu.numpy(), carried.nu.numpy(), rtol=1e-6, atol=1e-12)


def test_adam_state_from_jax_matches_the_optax_layout():
    params = _jax_params(4, dtype=jnp.float32)
    opt_state = jppo.make_optimizer(jppo.PpoConfig()).init(params)
    carried = ppo.adam_state_from_jax(_np_tree(opt_state))
    assert carried.count.dtype == torch.int32 and int(carried.count) == 0
    assert carried.mu.shape == carried.nu.shape == (networks.Layout(10, 4).size,)


def test_params_and_adam_state_from_jax_at_obs_dim_13():
    """The tpuquad family's 13-dim observation: the JAX params and optax
    state carry over leaf by leaf, and the actor-critic agrees in float64."""
    params = _jax_params(6, d=13)
    flat = networks.params_from_jax(_np_tree(params), dtype=F64)
    layout = networks.Layout(13, 4)
    assert flat.shape == (layout.size,) and layout.size == networks.Layout(10, 4).size + 3 * 128
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([np.ravel(x) for x in jax.tree.leaves(params)]))
    obs = np.random.default_rng(6).normal(size=(13, 32))
    mean, log_std, value = networks.apply_t(layout.unflatten(flat), torch.from_numpy(obs))
    j_mean, j_ls, j_value = jnet.apply_t(params, jnp.asarray(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=RTOL, atol=1e-14)
    opt_state = jppo.make_optimizer(jppo.PpoConfig()).init(
        jax.tree.map(lambda x: x.astype(jnp.float32), params))
    carried = ppo.adam_state_from_jax(_np_tree(opt_state))
    assert carried.mu.shape == carried.nu.shape == (layout.size,)
