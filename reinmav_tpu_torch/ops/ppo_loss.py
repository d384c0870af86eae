"""Kernel K3: the PPO loss forward and hand-derived backward over one
minibatch, gathered in the kernel; and its plain twin.

The counterpart of :mod:`reinmav_tpu.ops.pallas_ppo`.  The whole
flattened rollout is stacked once per update into ``(R, n)`` rows
(:func:`stack_batch`: obs, action, old logp, old value, RAW advantage,
return); a minibatch is the list ``perm`` of shuffle-tile indices into
it, and sample ``q`` of the minibatch is column ``perm[q // tile] * tile
+ q % tile``.  :func:`ppo_loss_grads_gather` runs the loss, its gradient
with respect to the flat actor-critic parameters
(:class:`reinmav_tpu_torch.rl.networks.Layout`) and the metric sums in
one CUDA kernel written by hand for Hopper (``csrc/ppo_loss.cu``), which
reads the minibatch straight from the full batch.
:func:`ppo_loss_grads_reference` is its plain twin: the same
hand-derived backward in eager PyTorch, on the gathered minibatch.  The
JAX tie conventions for ``minimum``/``maximum`` are kept, so both agree
with ``torch.autograd`` / ``jax.value_and_grad`` of ``ppo_loss``.

The gradients come out in the layout of the parameters themselves: the
towers' blocks, without the zero blocks of the fused layer that the TPU
kernel differentiates and ``ppo._unfuse_grads`` then drops.

``compute_dtype="bfloat16"`` is the TPU kernel's bf16 mode (its ``_mm``):
the two operands of each product rounded to bf16 and the exact products
summed in float32, in the forward (the weights, the obs, ``h1`` and
``h2``) and in the five backward products (their ``dout``, ``dpre2`` and
``dpre1`` cotangents and the activations of the weight gradients); the
``(1 - h^2)`` factors take the float32 ``h``, and the bias gradients sum
the float32 cotangents.  The kernel's bf16 instance runs its products on
the tensor cores (``csrc/ppo_loss_body_bf16.cuh``): the same exact
products, summed in float32 in the tensor cores' own order, a few ulps
from this twin's sums; its bf16 activations and its loss's clip decisions
are this twin's, each recomputed in this twin's order where the order of
summation could change them (:func:`ppo_loss_bf16_probe` counts both).

Two kernels take the widths: the 64-wide instances (``csrc/ppo_loss.cu``),
built for hidden (64, 64) at the :data:`KERNEL_DIMS` pairs, and the wide
instances (``csrc/ppo_loss_wide.cu``, launched by :func:`_launch_wide`), which
take two equal hidden widths from 1 to 256, obs dims up to 32 and action
dims up to 8 at run time (:func:`kernel_instance`); above that the kernels
refuse by name (:func:`kernel_dims_refusal`).  The wide body runs its
products on the tensor cores, in float32 as 3xTF32 and in bf16 as the
64-wide bf16 body does; its plan (:func:`wide_plan`) goes with each launch.

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel of the dtype and widths asked for or
raises.
"""

from __future__ import annotations

import math

import torch

from ..rl.networks import Layout, bf16_mm, bf16_round, is_bf16

#: The (obs, action) dims the 64-wide K3 and K4 instances are built for
#: (quadrotor3d-v0, the tpuquad family, quadrotor2d-v0, the 2D and 3D
#: slung-load envs: ``csrc/ppo_loss_body.cuh::with_kernel_dims``), and their
#: 2x64 actor-critic.
KERNEL_DIMS = ((10, 4), (13, 4), (5, 2), (9, 2), (16, 4))
HIDDEN = (64, 64)
#: The wide instances' limits (``csrc/ppo_loss_body_wide.cuh``): two equal
#: hidden widths up to this, obs and action dims up to these.
WIDE_MAX_HIDDEN, WIDE_MAX_OBS, WIDE_MAX_ACTION = 256, 32, 8
METRICS = ("pg_loss", "v_loss", "approx_kl", "clip_frac")
_LOG_2PI = math.log(2.0 * math.pi)
#: The offsets of ``csrc/actor_critic.cuh::RtLayout``, in its order.
WIDE_LAYOUT_KEYS = ("w1", "b2", "w2", "tower_hidden", "pi", "pi_out_b", "pi_out_w", "vf",
                    "vf_out_b", "vf_out_w", "net_size")


def kernel_instance(d: int, adim: int, hidden) -> str | None:
    """Which K3/K4 kernel takes these widths: ``"64"`` (the 64-wide
    instances: a :data:`KERNEL_DIMS` pair and hidden (64, 64)), ``"wide"``
    (any other two equal hidden widths from 1 to :data:`WIDE_MAX_HIDDEN`,
    obs dims up to :data:`WIDE_MAX_OBS`, action dims up to
    :data:`WIDE_MAX_ACTION`), or None (neither)."""
    hidden = tuple(hidden)
    if len(hidden) != 2 or hidden[0] != hidden[1]:
        return None
    if (d, adim) in KERNEL_DIMS and hidden == HIDDEN:
        return "64"
    if 1 <= hidden[0] <= WIDE_MAX_HIDDEN and 1 <= d <= WIDE_MAX_OBS and 1 <= adim <= WIDE_MAX_ACTION:
        return "wide"
    return None


def kernel_dims_refusal(d: int, adim: int, hidden) -> str | None:
    """Why no K3/K4 kernel takes these widths (None = one does,
    :func:`kernel_instance`); the reason names the width refused."""
    if kernel_instance(d, adim, hidden) is not None:
        return None
    hidden = tuple(hidden)
    if len(hidden) != 2 or hidden[0] != hidden[1]:
        return f"hidden {hidden} is not two equal layers"
    if not 1 <= hidden[0] <= WIDE_MAX_HIDDEN:
        return (f"hidden {hidden}: the K3/K4 kernels take two equal widths from 1 to "
                f"{WIDE_MAX_HIDDEN}")
    return (f"obs/action dims ({d}, {adim}): the K3/K4 kernels take obs dims up to "
            f"{WIDE_MAX_OBS} and action dims up to {WIDE_MAX_ACTION} (the 64-wide instances "
            f"{', '.join(map(str, KERNEL_DIMS))})")


def require_kernel_dims(name: str, d: int, adim: int, hidden: int, instance: str | None = None
                        ) -> str:
    """The instance that takes these widths (``hidden`` the width of both
    layers); raise ``ValueError`` when none does, or when ``instance`` is
    asked for and it is another."""
    reason = kernel_dims_refusal(d, adim, (hidden, hidden))
    if reason is not None:
        raise ValueError(f"the {name} kernel refuses {reason}")
    got = kernel_instance(d, adim, (hidden, hidden))
    if instance is not None and got != instance:
        raise ValueError(f"the {name} kernel's {instance} instance refuses obs/action dims "
                         f"({d}, {adim}) at hidden {hidden}: these take the {got} instance")
    return got


def wide_layout(d: int, adim: int, h: int) -> dict:
    """The flat layout's offsets as the wide kernels compute them at run
    time (``csrc/actor_critic.cuh::RtLayout``, keys
    :data:`WIDE_LAYOUT_KEYS`): inside a tower from its base (``w1``,
    ``b2``, ``w2``, ``tower_hidden``; ``b1`` at 0), and from the vector's
    start (the log-std at 0)."""
    out = {"w1": h}
    out["b2"] = out["w1"] + d * h
    out["w2"] = out["b2"] + h
    out["tower_hidden"] = out["w2"] + h * h
    out["pi"] = adim
    out["pi_out_b"] = out["pi"] + out["tower_hidden"]
    out["pi_out_w"] = out["pi_out_b"] + adim
    out["vf"] = out["pi_out_w"] + h * adim
    out["vf_out_b"] = out["vf"] + out["tower_hidden"]
    out["vf_out_w"] = out["vf_out_b"] + 1
    out["net_size"] = out["vf_out_w"] + h
    return out


def check_wide_layout(lib, d: int, adim: int, h: int) -> None:
    """Raise unless the library's run-time layout at these widths is
    :func:`wide_layout`'s."""
    import ctypes

    got = (ctypes.c_int * len(WIDE_LAYOUT_KEYS))()
    if lib.ppo_wide_layout(d, adim, h, got) != 0:
        raise ValueError(f"the wide K3/K4 kernels refuse widths ({d}, {adim}, {h})")
    want = wide_layout(d, adim, h)
    if dict(zip(WIDE_LAYOUT_KEYS, got)) != want:
        raise RuntimeError(f"the wide kernels' layout {list(got)} is not the wrapper's {want}")


#: The wide body's sub-block (samples), CTA (threads), recompute queue, the
#: 16-byte words of a warp's ring of weight words in flight in phase A and
#: of the CTA's stages of panel words in phase B
#: (``csrc/ppo_loss_body_wide.cuh``: kS, kThreads, kRecCap, kRingA, kStages
#: x kStageWords).
WIDE_SAMPLES, WIDE_THREADS, WIDE_REC_CAP = 64, 512, 1024
WIDE_RING_A, WIDE_STAGES_B = 2 * 2 * 32, 3 * 4 * 16 * 32
#: A CTA's dynamic shared memory on sm_90 (bytes).
WIDE_SMEM_LIMIT = 232448
#: The keys of the plan that the wide launches take and check (in order).
WIDE_PLAN_KEYS = ("samples", "smem_bytes", "groups", "group", "packed")


def wide_grid(mb: int, sms: int) -> int:
    """CTAs of the wide K3/K4 launch over ``mb`` samples on ``sms`` SMs: two
    a sub-block of :data:`WIDE_SAMPLES` (one a tower), at most one an SM,
    an even number (``grid_blocks``)."""
    return 2 * min(-(-mb // WIDE_SAMPLES), sms // 2)


def wide_plan(d: int, adim: int, h: int, bf16: bool, mb: int | None = None,
              blocks: int | None = None) -> dict:
    """The wide body's plan at obs dim ``d``, action dim ``adim``, hidden
    width ``h`` and dtype (``csrc/ppo_loss_body_wide.cuh::make_shape``): its
    sub-block (``samples``), its dynamic shared memory (``smem_bytes``), the
    16-byte words of a sub-block's panels (``group``) and of both towers'
    packed weights (``packed``), the row stride of its [unit][sample]
    arrays (``sp``), the units and obs rows padded to 16 (``units``,
    ``obs_rows``); and, given the minibatch ``mb`` and the grid ``blocks``,
    the panels' groups a CTA (``groups``)."""
    def r16(v):
        return -(-v // 16) * 16

    def r4(v):
        return -(-v // 4) * 4

    s = WIDE_SAMPLES
    hp, dp = r16(h), r16(d)
    nb, db = hp // 16, dp // 16
    ks = 16 if bf16 else 8
    kb = s // ks
    sp = s + (4 if bf16 else 8)
    floats = (2 * hp * sp + dp * sp + (adim + 4) * sp + (adim + 1) * sp + (adim + 4) * sp
              + 2 * hp + hp * adim + r4(adim + 1) + r4(adim) + r4(2 + WIDE_REC_CAP)
              + WIDE_THREADS // 32 * WIDE_RING_A * 4)
    floats = max(floats, WIDE_STAGES_B * 4)  # phase B's stages take the whole area
    planes = 1 if bf16 else 2  # the tf32 hi and lo of each weight in float32
    # A tower's packed words: W1, W2 and W2^T as fragments, and in bf16 the
    # twin-order chain's rows of W1 and W2 (bf16, 8 a word).
    tower = (nb * (dp // ks) + 2 * nb * (hp // ks)) * 32 + ((hp * dp + hp * hp) // 8 if bf16 else 0)
    plan = dict(samples=s, smem_bytes=4 * floats, group=(db + 3 * nb) * kb * 32,
                packed=planes * 2 * tower, sp=sp, units=hp, obs_rows=dp)
    if mb is not None and blocks is not None:
        sub_blocks = -(-mb // s)
        plan["groups"] = -(-sub_blocks // (blocks // 2))
    return plan


def check_wide_plan(lib, d: int, adim: int, h: int, bf16: bool, mb: int, blocks: int) -> dict:
    """:func:`wide_plan` for this launch, raising unless the library's
    (``ppo_wide_plan``) is the same."""
    import ctypes

    plan = wide_plan(d, adim, h, bf16, mb, blocks)
    got = (ctypes.c_longlong * 8)()
    if lib.ppo_wide_plan(d, adim, h, int(bf16), mb, blocks, got) != 0:
        raise ValueError(f"the wide K3/K4 kernels refuse widths ({d}, {adim}, {h}) on {blocks} "
                         f"CTAs")
    want = [plan[k] for k in (*WIDE_PLAN_KEYS, "sp", "units", "obs_rows")]
    if list(got) != want:
        raise RuntimeError(f"the wide kernels' plan {list(got)} is not the wrapper's {want}")
    return plan


def wide_plan_args(plan: dict):
    """The plan as the wide launches take it: :data:`WIDE_PLAN_KEYS`, int64
    on the host."""
    import ctypes

    return (ctypes.c_longlong * len(WIDE_PLAN_KEYS))(*(plan[k] for k in WIDE_PLAN_KEYS))


def wide_scratch(plan: dict, blocks: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The wide launches' scratch: the packed weights (zeroed: their padding
    stays 0) and the CTAs' panels, as int32 tensors."""
    packed = torch.zeros(plan["packed"] * 4, dtype=torch.int32, device=device)
    panels = torch.empty(blocks * plan["groups"] * plan["group"] * 4, dtype=torch.int32,
                         device=device)
    return packed, panels


def stack_batch(obs, act, old_logp, old_value, adv, ret) -> torch.Tensor:
    """The flattened batch as the kernel's ``(D + A + 4, n)`` float32 rows:
    obs (D), action (A), old logp, old value, RAW advantage, return."""
    return torch.cat([obs.to(torch.float32), act.to(torch.float32),
                      torch.stack([old_logp, old_value, adv, ret]).to(torch.float32)]).contiguous()


def _gather_columns(perm: torch.Tensor, tile: int) -> torch.Tensor:
    """Columns of the minibatch defined by shuffle-tile indices ``perm``."""
    offs = torch.arange(tile, device=perm.device)
    return (perm.to(torch.int64)[:, None] * tile + offs).reshape(-1)


def value_head(h, w, b):
    """The value head ``sum_j h[j] w[j] + b`` of K3/K4's body, rounded as
    it rounds it: each product and each sum in float32 apart, in j order
    from 0, then the bias (a one-column matmul is no FMA chain in cuBLAS,
    so the kernel and its twin both take this order).  ``h`` ``(H, n)``,
    ``w`` ``(H,)``, ``b`` 0-d."""
    value = torch.zeros_like(h[0])
    for j in range(h.shape[0]):
        value = value + h[j] * w[j]
    return value + b


def logp_ratio(diff, var, ls, old_logp):
    """The policy term's ``(quad, logp, ratio)`` of K3/K4's body
    (csrc/ppo_loss_body.cuh), rounded as it rounds them, one float32
    operation at a time: ``quad = diff * diff / var`` by action, ``qsum``
    and ``ls_sum`` added left to right from 0 over the action dim, ``logp =
    ((-0.5 qsum) - ls_sum) - 0.5 A log(2 pi)`` and ``ratio = exp(logp -
    old_logp)``.  ``diff``, ``var`` ``(A, n)`` (``var`` may broadcast),
    ``ls`` ``(A,)``, ``old_logp`` ``(n,)``.  A ratio on the clip edge
    (1 +- clip_eps) clips in both or in neither, when the inputs agree."""
    quad = diff * diff / var
    qsum = torch.zeros_like(old_logp)
    ls_sum = torch.zeros((), dtype=ls.dtype, device=ls.device)
    for a in range(quad.shape[0]):
        qsum = qsum + quad[a]
        ls_sum = ls_sum + ls[a]
    logp = -0.5 * qsum - ls_sum - 0.5 * quad.shape[0] * _LOG_2PI
    return quad, logp, torch.exp(logp - old_logp)


def ppo_loss_grads_reference(data, adv_stats, perm, net, *, d: int, adim: int,
                             clip_eps: float, value_clip_eps: float, value_coef: float,
                             tile: int, kl_mode: bool = False, hidden: int = 64,
                             compute_dtype=None) -> torch.Tensor:
    """Plain twin of K3: raw SUMS over the minibatch of the loss gradient in
    the flat layout of ``net``, then the metric sums ``[pg, v, kl,
    clipfrac]``.  Any obs and action width and any two equal hidden
    layers of width ``hidden``.  ``adv_stats`` ``[shift, inv_scale,
    kl_beta, 0]``.  ``compute_dtype`` "bfloat16": the bf16 products of
    the module docstring."""
    bf16 = is_bf16(compute_dtype)
    r = bf16_round if bf16 else (lambda t: t)  # noqa: E731

    def mm(a, b):  # a @ b, or its bf16 product
        return bf16_mm(a, b) if bf16 else a @ b

    layout = Layout(d, adim, (hidden, hidden))
    p = layout.unflatten(net)
    mb = data[:, _gather_columns(perm, tile)]
    x, act = mb[:d], mb[d:d + adim]
    old_logp, old_value, ret = mb[d + adim], mb[d + adim + 1], mb[d + adim + 3]
    adv = (mb[d + adim + 2] - adv_stats[0]) * adv_stats[1]
    ls = p["log_std"]

    # ---- forward, tower by tower (the fused layer's zero blocks skipped) ----
    acts = {}
    for tower in ("pi", "vf"):
        hs, h = [], x
        for layer in p[tower]:
            h = torch.tanh(mm(layer["w"].T, h) + layer["b"][:, None])
            hs.append(h)
        acts[tower] = hs
    mean = mm(p["pi_out"]["w"].T, acts["pi"][-1]) + p["pi_out"]["b"][:, None]
    value = value_head(r(acts["vf"][-1]), r(p["vf_out"]["w"][:, 0]), p["vf_out"]["b"][0])

    # ---- policy-gradient term (pallas_ppo._tile_loss_grads) ----------------
    var = torch.exp(2.0 * ls)[:, None]
    diff = act - mean
    quad, logp, ratio = logp_ratio(diff, var, ls, old_logp)
    kl = old_logp - logp
    if kl_mode:
        beta = adv_stats[2]
        dlogp = -ratio * adv - beta
        pg = -(ratio * adv) + beta * kl
    else:
        clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
        pg1, pg2 = ratio * adv, clipped * adv
        inside = ((ratio - 1.0).abs() < clip_eps).to(ratio.dtype)
        sel1 = (pg1 < pg2).to(ratio.dtype)
        sel2 = (pg2 < pg1).to(ratio.dtype)
        tie = 1.0 - sel1 - sel2
        dlogp = -(adv * (sel1 + sel2 * inside + 0.5 * tie * (1.0 + inside))) * ratio
        pg = -torch.minimum(pg1, pg2)

    # ---- value term ---------------------------------------------------------
    vdiff = value - old_value
    vcl = old_value + torch.clamp(vdiff, -value_clip_eps, value_clip_eps)
    e1, e2 = value - ret, vcl - ret
    sq1, sq2 = e1 * e1, e2 * e2
    vin = (vdiff.abs() < value_clip_eps).to(value.dtype)
    vs1 = (sq1 > sq2).to(value.dtype)
    vs2 = (sq2 > sq1).to(value.dtype)
    vtie = 1.0 - vs1 - vs2
    dvalue = value_coef * (vs1 * e1 + vs2 * e2 * vin + 0.5 * vtie * (e1 + e2 * vin))
    dmean = dlogp * (diff / var)

    # ---- backward through each tower ---------------------------------------
    g = {"pi": [{} for _ in p["pi"]], "vf": [{} for _ in p["vf"]], "pi_out": {}, "vf_out": {}}
    for tower, dout in (("pi", dmean), ("vf", dvalue[None])):
        hs = acts[tower]
        g[f"{tower}_out"] = {"w": mm(hs[-1], dout.T), "b": dout.sum(dim=1)}
        dh = mm(p[f"{tower}_out"]["w"], dout)
        for i in range(len(hs) - 1, -1, -1):
            dpre = dh * (1.0 - hs[i] * hs[i])
            below = hs[i - 1] if i else x
            g[tower][i] = {"w": mm(below, dpre.T), "b": dpre.sum(dim=1)}
            if i:
                dh = mm(p[tower][i]["w"], dpre)
    g["log_std"] = (dlogp * (quad - 1.0)).sum(dim=1)
    metrics = torch.stack([pg.sum(), 0.5 * torch.maximum(sq1, sq2).sum(), kl.sum(),
                           ((ratio - 1.0).abs() > clip_eps).to(ratio.dtype).sum()])
    return torch.cat([layout.flatten(g, device=net.device, dtype=net.dtype), metrics])


def _finish(sums: torch.Tensor, n: int, ent_coef: float, layout: Layout):
    """Raw sums -> ``(grads, metrics)``: the loss-mean gradient in the flat
    layout, the entropy term's ``-ent_coef`` added to the log-std entries
    (``pallas_ppo._finish``), and the metric means."""
    inv_n = 1.0 / n
    grads = sums[:layout.size] * inv_n
    grads[layout.slices[("log_std",)]] -= ent_coef
    means = sums[layout.size:] * inv_n
    return grads, dict(zip(METRICS, means.unbind()))


def ppo_loss_grads_gather(data, adv_stats, perm, net, *, d: int, adim: int, clip_eps: float,
                          value_clip_eps: float, value_coef: float, ent_coef: float, tile: int,
                          kl_mode: bool = False, hidden: int = 64, compute_dtype=None):
    """K3: the PPO loss gradient over the minibatch DEFINED by ``perm``
    (int32 ``(m,)`` shuffle-tile indices into the full batch ``data``, the
    :func:`stack_batch` rows), in one CUDA launch plus a second that adds
    the CTAs' partial sums in a fixed order.

    ``adv_stats`` ``(4,)`` float32 on the device: ``[adv shift, adv
    inv_scale, kl_beta, 0]`` (the per-minibatch advantage normalisation,
    ``[0, 1, .]`` when off; ``kl_beta`` read in ``kl_mode`` only).
    Returns ``(grads, metrics)``: ``grads`` the loss-mean gradient in the
    flat layout of ``net`` (entropy term included), ``metrics``
    ``{pg_loss, v_loss, approx_kl, clip_frac}`` as 0-d tensors (means).
    ``compute_dtype`` None or "float32", or "bfloat16" (the kernel's bf16
    instance, the twin's bf16 products).
    Launches on the current stream and does not synchronise.  A CPU
    tensor runs the plain twin; a CUDA tensor runs the 64-wide kernel (the
    :data:`KERNEL_DIMS` pairs, hidden 64; counted here) or the wide one
    (counted on :func:`_launch_wide`) as :func:`kernel_instance` picks, or
    raises.
    """
    bf16 = is_bf16(compute_dtype)
    layout = Layout(d, adim, (hidden, hidden))
    for name, t in (("data", data), ("adv_stats", adv_stats), ("net", net)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, data on {data.device}")
    if perm.dtype != torch.int32 or perm.dim() != 1 or perm.device != data.device:
        raise ValueError("perm must be a 1-D int32 tensor on the device of data")
    rows, n = data.shape
    if rows != d + adim + 4:
        raise ValueError(f"data must have {d + adim + 4} rows, got {rows}")
    if tile < 1 or n % tile:
        raise ValueError(f"tile {tile} must divide the batch {n}")
    if net.shape != (layout.size,) or adv_stats.shape != (4,):
        raise ValueError(f"net must be ({layout.size},) and adv_stats (4,), got "
                         f"{tuple(net.shape)} and {tuple(adv_stats.shape)}")
    m = perm.shape[0]
    cfg = dict(d=d, adim=adim, clip_eps=clip_eps, value_clip_eps=value_clip_eps,
               value_coef=value_coef, tile=tile, kl_mode=kl_mode, compute_dtype=compute_dtype)
    if data.device.type == "cpu":
        sums = ppo_loss_grads_reference(data, adv_stats, perm, net, hidden=hidden, **cfg)
        return _finish(sums, m * tile, ent_coef, layout)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    instance = require_kernel_dims("K3", d, adim, hidden)
    if m == 0:
        raise ValueError("perm is empty")
    if instance == "wide":
        sums = _launch_wide(data, adv_stats, perm, net, layout, hidden=hidden, **cfg)
        return _finish(sums, m * tile, ent_coef, layout)
    from .._build import check, load_library

    lib = load_library()
    with torch.cuda.device(data.device):
        blocks = lib.ppo_loss_blocks(m * tile)
        if blocks <= 0:
            raise RuntimeError(f"ppo_loss_blocks returned {blocks}")
        out_size = lib.ppo_loss_out_size(d, adim)
        if out_size != layout.size + len(METRICS):
            raise RuntimeError(f"the K3 library writes {out_size} sums, the flat layout has "
                               f"{layout.size} + {len(METRICS)}")
        partials = torch.empty((blocks, out_size), dtype=torch.float32, device=data.device)
        sums = torch.empty(out_size, dtype=torch.float32, device=data.device)
        rc = lib.ppo_loss_launch(
            d, adim, data.data_ptr(), n, perm.data_ptr(), m, tile, adv_stats.data_ptr(), net.data_ptr(),
            clip_eps, value_clip_eps, value_coef, int(kl_mode), int(bf16), blocks,
            partials.data_ptr(), sums.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(rc, "ppo_loss_launch")
    ppo_loss_grads_gather.launches += 1
    return _finish(sums, m * tile, ent_coef, layout)


#: Launches of the 64-wide kernel so far (a run can show that its path went
#: through K3).
ppo_loss_grads_gather.launches = 0


def _launch_wide(data, adv_stats, perm, net, layout: Layout, *, d: int, adim: int,
                 clip_eps: float, value_clip_eps: float, value_coef: float, tile: int,
                 kl_mode: bool, hidden: int, compute_dtype=None, probe_lib=None,
                 rec_counts=None) -> torch.Tensor:
    """K3 wide (``csrc/ppo_loss_wide.cu``) on the CUDA inputs that
    :func:`ppo_loss_grads_gather` checked and sends here: the raw sums, in
    the flat layout then the metrics.  Launches on the current stream and
    does not synchronise.  The plan (:func:`wide_plan`) is checked against
    the library's and passed with the launch, which refuses another.
    ``probe_lib``: the same kernel with its phase probe on
    (``_build.load_probe_library``), a diagnostic launch that is not
    counted.  ``rec_counts``: an int64 CUDA tensor of 2 to which the bf16
    instance adds the h1's and h2's it recomputed in the twin's order."""
    from .._build import check, load_library

    lib = probe_lib or load_library()
    bf16 = is_bf16(compute_dtype)
    m = perm.shape[0]
    with torch.cuda.device(data.device):
        check_wide_layout(lib, d, adim, hidden)
        blocks = lib.ppo_loss_wide_blocks(m * tile)
        if blocks <= 0:
            raise RuntimeError(f"ppo_loss_wide_blocks returned {blocks}")
        plan = check_wide_plan(lib, d, adim, hidden, bf16, m * tile, blocks)
        out_size = lib.ppo_loss_wide_out_size(d, adim, hidden)
        if out_size != layout.size + len(METRICS):
            raise RuntimeError(f"the K3 wide library writes {out_size} sums, the flat layout has "
                               f"{layout.size} + {len(METRICS)}")
        partials = torch.empty((blocks, out_size), dtype=torch.float32, device=data.device)
        packed, panels = wide_scratch(plan, blocks, data.device)
        sums = torch.empty(out_size, dtype=torch.float32, device=data.device)
        rc = lib.ppo_loss_wide_launch(
            d, adim, hidden, data.data_ptr(), data.shape[1], perm.data_ptr(), m, tile,
            adv_stats.data_ptr(), net.data_ptr(), clip_eps, value_clip_eps, value_coef,
            int(kl_mode), int(bf16), blocks, wide_plan_args(plan), partials.data_ptr(),
            packed.data_ptr(), panels.data_ptr(),
            None if rec_counts is None else rec_counts.data_ptr(), sums.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "ppo_loss_wide_launch")
    if probe_lib is None:
        _launch_wide.launches += 1
    return sums


#: Launches of the wide kernel so far (a run can show that its path went
#: through K3 wide).
_launch_wide.launches = 0


def ppo_loss_bf16_probe(data, adv_stats, perm, net, *, d: int, adim: int, clip_eps: float,
                        value_clip_eps: float, value_coef: float, tile: int):
    """The forward of K3's bf16 body, sample by sample, in the clipped mode:
    ``(ratio_tc, value_tc, ratio, value)``, each ``(m * tile,)`` in
    minibatch order: the ratio and value of the tensor cores' forward, and
    as the kernel's loss takes them (the twin's own forward for a sample
    within ``kEdge`` of a decision, ``csrc/ppo_loss_body_bf16.cuh``).  A
    diagnostic on the card (a kernel of its own, launched by no training
    path and counted in no launch count): held against the twin's forward,
    it counts the samples whose forward the tensor cores' order of
    summation changed, the decisions that would have flipped, and those
    that did.  The arguments are :func:`ppo_loss_grads_gather`'s."""
    if data.device.type != "cuda":
        raise ValueError("the probe runs K3's bf16 kernel, on a CUDA tensor only")
    require_kernel_dims("K3", d, adim, HIDDEN[0], instance="64")
    from .._build import check, load_library

    lib = load_library()
    m = perm.shape[0]
    with torch.cuda.device(data.device):
        blocks = lib.ppo_loss_blocks(m * tile)
        partials = torch.empty((blocks, lib.ppo_loss_out_size(d, adim)), dtype=torch.float32,
                               device=data.device)
        probe = torch.empty((m * tile, 4), dtype=torch.float32, device=data.device)
        rc = lib.ppo_loss_probe_launch(
            d, adim, data.data_ptr(), data.shape[1], perm.data_ptr(), m, tile,
            adv_stats.data_ptr(), net.data_ptr(), clip_eps, value_clip_eps, value_coef, blocks,
            partials.data_ptr(), probe.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(rc, "ppo_loss_probe_launch")
    return probe.unbind(1)


def ppo_loss_grads(obs, act, old_logp, old_value, adv, ret, net, *, clip_eps: float,
                   value_clip_eps: float, value_coef: float, ent_coef: float,
                   kl_beta: float | None = None, hidden: int = 64, compute_dtype=None):
    """K3 over a CONTIGUOUS transposed minibatch (``obs`` ``(D, n)``,
    ``act`` ``(A, n)``, per-sample rows ``(n,)``, ``adv`` already
    normalised): :func:`ppo_loss_grads_gather` with the whole batch as one
    tile.  ``kl_beta`` set selects the adaptive-KL surrogate."""
    data = stack_batch(obs, act, old_logp, old_value, adv, ret)
    beta = 0.0 if kl_beta is None else float(kl_beta)
    adv_stats = torch.tensor([0.0, 1.0, beta, 0.0], dtype=torch.float32, device=data.device)
    perm = torch.zeros(1, dtype=torch.int32, device=data.device)
    return ppo_loss_grads_gather(
        data, adv_stats, perm, net, d=obs.shape[0], adim=act.shape[0], clip_eps=clip_eps,
        value_clip_eps=value_clip_eps, value_coef=value_coef, ent_coef=ent_coef,
        tile=data.shape[1], kl_mode=kl_beta is not None, hidden=hidden,
        compute_dtype=compute_dtype)
