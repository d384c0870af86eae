"""The port's bf16 learner paths (``compute_dtype="bfloat16"``) against the
JAX package's, on the CPU: the eager paths, no kernel and no interpret mode.

Both sides compute in float32 from the same float32 inputs, made with a
numpy seed (the hopper-kernels guide: compare bf16 in float32 where the
point is the algorithm).  On each side each product's two operands are
rounded to bf16 and the exact products summed in float32
(``preferred_element_type=float32``; ``networks.bf16_mm``), the
nonlinearities keep a bf16 autodiff residual, and the rest stays float32.
What differs between the sides is the order of the float32 sums (XLA's
dot and torch's matmul), and a last-bit difference in a sum can move a
value that is rounded to bf16 later by one bf16 ulp (2^-8 relative).  So
the tolerances are bf16-sized, and each is tighter than the JAX package's
own bf16 tolerances: tests/test_pallas_ppo.py:150-176 (metrics rtol 2e-2 /
atol 2e-3, gradient blocks within 0.15 of their scale) and
tests/test_sac.py:167-172 (loss rtol 0.05, gradient norms within 0.15):

- values and losses: rtol 2e-3, atol 2e-4 (VALUE_TOL), save at most 1% of
  the entries of an array (a bf16 flip upstream; XLA's CPU tanh is not
  libm's, so such flips come more often than the sums' order alone would
  give), which lie within the JAX package's metric tolerance, rtol 2e-2 /
  atol 2e-3 (FLIP_TOL);
- gradients: the error's norm within 1e-2 of the reference's
  (GRAD_NORM_TOL), and every entry within rtol 2e-2, atol 2e-4 plus 2e-2
  of the reference's largest entry (GRAD_TOL).

The last test is ``tests/test_ppo.py::test_bfloat16_compute_dtype_trains``
for the port: a bf16 ``train_step`` on the CPU (the eager loop and
autograd, and the K2 and K4 twins) from the float32 path's state, whose
metrics are finite, whose master params stay float32, and whose
``v_loss`` lies within 0.2 (1 + |v_loss|) of the float32 path's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reinmav_tpu
import reinmav_tpu_torch
from reinmav_tpu.rl import networks as jnet
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu.rl import sac as jsac
from reinmav_tpu.rl import td3 as jtd3
from reinmav_tpu_torch.rl import networks, ppo, sac, td3

VALUE_TOL = dict(rtol=2e-3, atol=2e-4)
FLIP_TOL = dict(rtol=2e-2, atol=2e-3)
MAX_FLIPS = 0.01
GRAD_TOL = dict(rtol=2e-2, atol=2e-4)
GRAD_NORM_TOL = 1e-2
HIDDEN = (32, 32)
BF16 = "bfloat16"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the suite runs six workers on the
    host's cores, and torch's intra-op threads oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _f32(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(_f32(x).copy())


def _close(got, ref, what):
    """Every entry within FLIP_TOL, all but MAX_FLIPS of them within
    VALUE_TOL."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, ref = got.astype(np.float64), _f32(ref).astype(np.float64)
    np.testing.assert_allclose(got, ref, **FLIP_TOL, err_msg=what)
    outside = ~np.isclose(got, ref, **VALUE_TOL)
    assert outside.sum() <= MAX_FLIPS * outside.size, (what, int(outside.sum()), outside.size)


def _grads_close(got, ref, what):
    """``got`` against ``ref`` (flat vectors of one layout): the error's
    norm within GRAD_NORM_TOL of the reference's, each entry within
    GRAD_TOL of the largest."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all(), what
    err = np.linalg.norm(got - ref)
    assert err <= GRAD_NORM_TOL * max(np.linalg.norm(ref), 1e-6), (what, err, np.linalg.norm(ref))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=GRAD_TOL["rtol"],
                               atol=GRAD_TOL["atol"] + GRAD_TOL["rtol"] * scale, err_msg=what)


def _ac_params(seed, d, a):
    """A 2 x 64 actor-critic (float32, JAX layout) with every block off its
    init, so that every product matters."""
    rng = np.random.default_rng(seed)
    params = jnet.init_params(jax.random.PRNGKey(seed), jnet.MlpConfig(d, a, (64, 64)))
    return jax.tree.map(lambda x: jnp.asarray(
        _f32(x) + np.float32(0.1) * rng.standard_normal(x.shape).astype(np.float32)), params)


def _port_params(tree):
    return networks.params_from_jax(jax.tree.map(_f32, tree))


def test_bf16_helpers():
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -3.0e-3, 1e30], dtype=torch.float64)
    # Round to nearest even at the 8-bit mantissa: a tie goes to the even one.
    assert networks.bf16_round(x).tolist()[:2] == [1.0, 1.0 + 2 * 2.0 ** -7]
    a = torch.randn(3, 50, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    b = torch.randn(50, 4, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    got = networks.bf16_mm(a, b)
    assert got.dtype == torch.float32
    exact = networks.bf16_round(a).double() @ networks.bf16_round(b).double()
    assert float((got.double() - exact).abs().max()) < 1e-5  # float32 sums, not bf16 ones
    assert networks.is_bf16("bfloat16") and not networks.is_bf16(None)
    with pytest.raises(ValueError, match="compute_dtype"):
        networks.is_bf16("float16")


@pytest.mark.parametrize("d,a", [(10, 4), (13, 4)])
def test_apply_t_and_its_gradient_match_jax(d, a):
    params = _ac_params(d, d, a)
    rng = np.random.default_rng(d + 1)
    obs = rng.standard_normal((d, 256)).astype(np.float32)
    cm = rng.standard_normal((a, 256)).astype(np.float32)
    cv = rng.standard_normal(256).astype(np.float32)

    def jloss(p):
        mean, _, value = jnet.apply_t(p, jnp.asarray(obs), jnp.bfloat16)
        return jnp.sum(mean * cm) + jnp.sum(value * cv), (mean, value)

    (_, (j_mean, j_value)), j_g = jax.value_and_grad(jloss, has_aux=True)(params)
    layout = networks.Layout(d, a)
    flat = _port_params(params).requires_grad_(True)
    mean, log_std, value = networks.apply_t(layout.unflatten(flat), _t(obs), BF16)
    assert mean.dtype == value.dtype == torch.float32
    _close(mean, j_mean, "mean")
    _close(value, j_value, "value")
    (g,) = torch.autograd.grad((mean * _t(cm)).sum() + (value * _t(cv)).sum(), flat)
    _grads_close(g, _port_params(j_g), "apply_t gradient")
    # bf16 is not float32: the products moved.
    f32_mean, _, _ = networks.apply_t(layout.unflatten(flat.detach()), _t(obs))
    assert float((f32_mean - mean.detach()).abs().max()) > 1e-5


@pytest.mark.parametrize("mode", ["clip", "kl"])
def test_ppo_loss_and_grads_match_jax(mode):
    d, a, n = 10, 4, 512
    params = _ac_params(3, d, a)
    params["log_std"] = params["log_std"] + 0.1
    rng = np.random.default_rng(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    obs, act, adv, old_value = f(d, n), f(a, n), f(n), f(n)
    old_logp = f(n) * np.float32(0.3) - np.float32(4.0)
    ret = old_value + f(n) * np.float32(0.5)
    beta = np.float32(0.7)
    kw = dict(entropy_coef=0.01, kl_target=0.01 if mode == "kl" else None)
    mb = jppo.Transition(*(jnp.asarray(x) for x in (obs, act, old_logp, old_value)),
                         jnp.zeros(n, jnp.float32), jnp.zeros(n, bool))
    (j_loss, j_m), j_g = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        params, jppo.PpoConfig(**kw), mb, jnp.asarray(adv), jnp.asarray(ret), jnp.bfloat16,
        jnp.float32(beta) if mode == "kl" else None)

    layout = networks.Layout(d, a)
    flat = _port_params(params).requires_grad_(True)
    pmb = ppo.Transition(_t(obs), _t(act), _t(old_logp), _t(old_value), torch.zeros(n),
                         torch.zeros(n, dtype=torch.bool))
    loss, m = ppo.ppo_loss(layout.unflatten(flat), ppo.PpoConfig(**kw), pmb, _t(adv), _t(ret),
                           BF16, torch.tensor(beta) if mode == "kl" else None)
    (g,) = torch.autograd.grad(loss, flat)
    _close(loss, j_loss, "loss")
    for name in ("pg_loss", "v_loss", "entropy", "approx_kl", "clip_frac"):
        _close(m[name], j_m[name], name)
    _grads_close(g, _port_params(j_g), f"{mode} gradient")


def _mlp(rng, dims, key):
    layers = jsac._mlp_init(jax.random.PRNGKey(key), dims)
    return [{k: jnp.asarray(_f32(v) + np.float32(0.3) * rng.standard_normal(v.shape)
                            .astype(np.float32)) for k, v in layer.items()} for layer in layers]


def _layers_t(tree):
    return [{k: _t(v) for k, v in layer.items()} for layer in tree]


def _sac_case(seed, env_id, batch=128):
    rng = np.random.default_rng(seed)
    env = reinmav_tpu.make(env_id)
    d, a = env.obs_dim, env.action_dim
    actor = _mlp(rng, (d, *HIDDEN, 2 * a), seed)
    q1, q2 = _mlp(rng, (d + a, *HIDDEN, 1), seed + 1), _mlp(rng, (d + a, *HIDDEN, 1), seed + 2)
    q1t, q2t = _mlp(rng, (d + a, *HIDDEN, 1), seed + 3), _mlp(rng, (d + a, *HIDDEN, 1), seed + 4)
    rows = rng.standard_normal((2 * d + a + 2, batch)).astype(np.float32)
    rows[d:d + a] = np.tanh(rows[d:d + a])
    rows[2 * d + a + 1] = rng.random(batch) < 0.2
    eps = rng.standard_normal((a, batch)).astype(np.float32)
    return env, reinmav_tpu_torch.make(env_id), actor, q1, q2, q1t, q2t, rows, eps


def test_sac_networks_match_jax():
    env, _, actor, q1, q2, _, _, rows, eps = _sac_case(0, "MujocoQuadForce-v1")
    d, a = env.obs_dim, env.action_dim
    obs, act = rows[:d], rows[d:d + a]
    ref = jsac.twin_q_value_t(q1, q2, jnp.asarray(obs), jnp.asarray(act), jnp.bfloat16)
    got = sac.twin_q_value_t(_layers_t(q1), _layers_t(q2), _t(obs), _t(act), BF16)
    for g, r, name in zip(got, ref, ("q1", "q2")):
        _close(g, r, f"twin {name}")
    _close(sac.q_value_t(_layers_t(q1), _t(obs), _t(act), BF16),
           jsac.q_value_t(q1, jnp.asarray(obs), jnp.asarray(act), jnp.bfloat16), "q_value_t")
    ref_a, ref_lp = jsac.sample_squashed_eps_t(actor, jnp.asarray(obs), jnp.asarray(eps), a,
                                               jnp.bfloat16)
    got_a, got_lp = sac.sample_squashed_eps_t(_layers_t(actor), _t(obs), _t(eps), a, BF16)
    _close(got_a, ref_a, "squashed action")
    _close(got_lp, ref_lp, "log_prob")


def test_sac_critic_loss_and_grads_match_jax():
    env, penv, actor, q1, q2, q1t, q2t, rows, eps = _sac_case(1, "quadrotor3d-v0")
    log_alpha = jnp.float32(-0.7)
    cfg = jsac.SacConfig(reward_scale=1.5, gamma=0.97)
    (ref, ref_aux), ref_g = jax.value_and_grad(jsac._critic_loss_eps, has_aux=True)(
        {"q1": q1, "q2": q2}, cfg, env, jnp.asarray(rows), (q1t, q2t), jnp.asarray(eps), actor,
        log_alpha, jnp.bfloat16)
    lq = sac.critic_layout(penv, HIDDEN)
    flat = lq.flatten(q1, q2).requires_grad_(True)
    loss, aux = sac._critic_loss_eps(
        {"q1": lq.layers(flat, 0), "q2": lq.layers(flat, 1)},
        sac.SacConfig(reward_scale=1.5, gamma=0.97), penv, _t(rows),
        (_layers_t(q1t), _layers_t(q2t)), _t(eps), _layers_t(actor), _t(log_alpha), BF16)
    (grad,) = torch.autograd.grad(loss, flat)
    _close(loss, ref, "critic loss")
    for g, r, name in zip(aux, ref_aux, ("q_mean", "target_mean")):
        _close(g, r, name)
    _grads_close(grad, lq.flatten(ref_g["q1"], ref_g["q2"]), "critic grads")


def test_sac_actor_alpha_loss_and_grads_match_jax():
    env, penv, actor, q1, q2, _, _, rows, eps = _sac_case(2, "MujocoQuadForce-v1")
    a = env.action_dim
    log_alpha = jnp.float32(0.4)
    (ref, ref_aux), ref_g = jax.value_and_grad(jsac._actor_alpha_loss_eps, has_aux=True)(
        {"actor": actor, "log_alpha": log_alpha}, jsac.SacConfig(), env, jnp.asarray(rows),
        q1, q2, jnp.asarray(eps), -4.0, jnp.bfloat16)
    la = sac.actor_layout(penv, HIDDEN, 2 * a)
    flat = la.flatten(actor).requires_grad_(True)
    la_t = _t(log_alpha).requires_grad_(True)
    loss, aux = sac._actor_alpha_loss_eps({"actor": la.layers(flat), "log_alpha": la_t},
                                          sac.SacConfig(), penv, _t(rows), _layers_t(q1),
                                          _layers_t(q2), _t(eps), -4.0, BF16)
    g_actor, g_alpha = torch.autograd.grad(loss, (flat, la_t))
    _close(loss, ref, "actor+alpha loss")
    for g, r, name in zip(aux, ref_aux, ("pi_loss", "entropy", "alpha")):
        _close(g, r, name)
    _grads_close(g_actor, la.flatten(ref_g["actor"]), "actor grads")
    _close(g_alpha, ref_g["log_alpha"], "log_alpha grad")


@pytest.mark.parametrize("alg", ["td3", "ddpg"])
def test_td3_losses_and_grads_match_jax(alg):
    env_id = "quadrotor3d-v0" if alg == "td3" else "MujocoQuadForce-v1"
    env, penv, _, q1, q2, q1t, q2t, rows, _ = _sac_case(3, env_id)
    d, a, batch = env.obs_dim, env.action_dim, rows.shape[1]
    actor = _mlp(np.random.default_rng(5), (d, *HIDDEN, a), 5)
    kw = (dict(single_critic=True, policy_noise=0.0, noise_clip=0.0, policy_delay=1)
          if alg == "ddpg" else dict(policy_noise=0.25, noise_clip=0.375))
    jcfg = jtd3.Td3Config(hidden=HIDDEN, reward_scale=1.5, gamma=0.97, **kw)
    pcfg = td3.Td3Config(**jcfg._asdict())
    if alg == "ddpg":
        q2 = q2t = None
    k_tgt = jax.random.PRNGKey(7)
    qd = jtd3._qdict(jcfg, q1, q2)
    (ref, ref_aux), ref_g = jax.value_and_grad(jtd3.critic_loss, has_aux=True)(
        qd, jcfg, env, jnp.asarray(rows), (q1t, q2t), k_tgt, actor, jnp.bfloat16)
    la, lq = td3.layouts(penv, pcfg)
    names = ("q1",) if alg == "ddpg" else ("q1", "q2")
    flat = lq.flatten(*(qd[n] for n in names)).requires_grad_(True)
    targets = {n: _layers_t(t) for n, t in zip(names, (q1t, q2t))}
    noise = _t(jax.random.normal(k_tgt, (a, batch), jnp.float32))
    loss, aux = td3._critic_loss_noise(td3.qdict(pcfg, lq, flat), pcfg, penv, _t(rows), targets,
                                       noise, _layers_t(actor), BF16)
    (grad,) = torch.autograd.grad(loss, flat)
    _close(loss, ref, f"{alg} critic loss")
    for g, r, name in zip(aux, ref_aux, ("q_mean", "target_mean")):
        _close(g, r, name)
    _grads_close(grad, lq.flatten(*(ref_g[n] for n in names)), f"{alg} critic grads")

    ref_pi, ref_pg = jax.value_and_grad(jtd3.actor_loss)(actor, env, jnp.asarray(rows), q1,
                                                          jnp.bfloat16)
    a_flat = la.flatten(actor).requires_grad_(True)
    pi = td3.actor_loss(la.layers(a_flat), penv, _t(rows), _layers_t(q1), BF16)
    (pg,) = torch.autograd.grad(pi, a_flat)
    _close(pi, ref_pi, f"{alg} actor loss")
    _grads_close(pg, la.flatten(ref_pg), f"{alg} actor grads")
    _close(td3.actor_action_t(_layers_t(actor), _t(rows[:d]), BF16),
           jtd3.actor_action_t(actor, jnp.asarray(rows[:d]), jnp.bfloat16), "actor_action_t")


@pytest.mark.parametrize("fused", ["off", "on"])
def test_bf16_train_step_on_the_cpu(fused):
    """tests/test_ppo.py:176-194 for the port: one bf16 update from the
    float32 path's state, on the eager loop and autograd ("off") or the K2
    and K4 twins ("on")."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    common = dict(num_envs=64, rollout_len=16, num_epochs=2, num_minibatches=2, hidden=(64, 64),
                  fused_rollout=fused, fused_update=fused, fused_loss=fused)
    cfg32 = ppo.PpoConfig(**common)
    cfg16 = cfg32._replace(compute_dtype=BF16)
    s32 = ppo.init_train_state(env, cfg32, 0, device="cpu")
    state = ppo.init_train_state(env, cfg16, 0, device="cpu")
    assert torch.equal(state.params, s32.params)
    a, ma = ppo.train_step(env, cfg32, s32)
    b, mb = ppo.train_step(env, cfg16, state)
    assert all(np.isfinite(float(v)) for v in mb.values()), mb
    assert b.params.dtype == b.opt_state.mu.dtype == b.opt_state.nu.dtype == torch.float32
    assert bool(torch.isfinite(b.params).all()) and not torch.equal(a.params, b.params)
    v32, v16 = float(ma["v_loss"]), float(mb["v_loss"])
    assert abs(v32 - v16) < 0.2 * (1 + abs(v32)), (v32, v16)
    with pytest.raises(ValueError, match="compute_dtype"):
        ppo.train_step(env, cfg32._replace(compute_dtype="float16"), s32)
