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

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from ..rl.networks import Layout

#: The (obs, action) dims the K3 and K4 kernels are built for
#: (quadrotor3d-v0, the tpuquad family, quadrotor2d-v0, the 2D and 3D
#: slung-load envs: ``csrc/ppo_loss_body.cuh::with_kernel_dims``), and their
#: 2x64 actor-critic.
KERNEL_DIMS = ((10, 4), (13, 4), (5, 2), (9, 2), (16, 4))
HIDDEN = (64, 64)
METRICS = ("pg_loss", "v_loss", "approx_kl", "clip_frac")
_LOG_2PI = math.log(2.0 * math.pi)


def kernel_dims_refusal(d: int, adim: int, hidden) -> str | None:
    """Why the K3/K4 kernels cannot take these widths (None = they can):
    the library is built for the :data:`KERNEL_DIMS` (obs, action) pairs
    and the 2x64 actor-critic."""
    if (d, adim) not in KERNEL_DIMS:
        return (f"obs/action dims ({d}, {adim}): the K3/K4 kernels are built for "
                f"{', '.join(map(str, KERNEL_DIMS))}")
    if tuple(hidden) != HIDDEN:
        return f"hidden {tuple(hidden)}: the K3/K4 kernels are built for {HIDDEN}"
    return None


def require_kernel_dims(name: str, d: int, adim: int, hidden: int) -> None:
    """Raise ``ValueError`` unless the kernel ``name`` is built for these
    widths (``hidden`` the width of both layers)."""
    reason = kernel_dims_refusal(d, adim, (hidden, hidden))
    if reason is not None:
        raise ValueError(f"the {name} kernel refuses {reason}")


def stack_batch(obs, act, old_logp, old_value, adv, ret) -> torch.Tensor:
    """The flattened batch as the kernel's ``(D + A + 4, n)`` float32 rows:
    obs (D), action (A), old logp, old value, RAW advantage, return."""
    return torch.cat([obs.to(torch.float32), act.to(torch.float32),
                      torch.stack([old_logp, old_value, adv, ret]).to(torch.float32)]).contiguous()


def _gather_columns(perm: torch.Tensor, tile: int) -> torch.Tensor:
    """Columns of the minibatch defined by shuffle-tile indices ``perm``."""
    offs = torch.arange(tile, device=perm.device)
    return (perm.to(torch.int64)[:, None] * tile + offs).reshape(-1)


def ppo_loss_grads_reference(data, adv_stats, perm, net, *, d: int, adim: int,
                             clip_eps: float, value_clip_eps: float, value_coef: float,
                             tile: int, kl_mode: bool = False, hidden: int = 64) -> torch.Tensor:
    """Plain twin of K3: raw SUMS over the minibatch of the loss gradient in
    the flat layout of ``net``, then the metric sums ``[pg, v, kl,
    clipfrac]``.  Any obs and action width and any two equal hidden
    layers of width ``hidden``.  ``adv_stats`` ``[shift, inv_scale,
    kl_beta, 0]``."""
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
            h = torch.tanh(layer["w"].T @ h + layer["b"][:, None])
            hs.append(h)
        acts[tower] = hs
    mean = p["pi_out"]["w"].T @ acts["pi"][-1] + p["pi_out"]["b"][:, None]
    value = (p["vf_out"]["w"].T @ acts["vf"][-1] + p["vf_out"]["b"][:, None])[0]

    # ---- policy-gradient term (pallas_ppo._tile_loss_grads) ----------------
    var = torch.exp(2.0 * ls)[:, None]
    diff = act - mean
    quad = diff * diff / var
    logp = -0.5 * quad.sum(dim=0) - ls.sum() - 0.5 * adim * _LOG_2PI
    ratio = torch.exp(logp - old_logp)
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
        g[f"{tower}_out"] = {"w": hs[-1] @ dout.T, "b": dout.sum(dim=1)}
        dh = p[f"{tower}_out"]["w"] @ dout
        for i in range(len(hs) - 1, -1, -1):
            dpre = dh * (1.0 - hs[i] * hs[i])
            below = hs[i - 1] if i else x
            g[tower][i] = {"w": below @ dpre.T, "b": dpre.sum(dim=1)}
            if i:
                dh = p[tower][i]["w"] @ dpre
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
                          kl_mode: bool = False, hidden: int = 64):
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
    Launches on the current stream and does not synchronise.  A CPU
    tensor runs the plain twin; a CUDA tensor runs the kernel (the
    :data:`KERNEL_DIMS` pairs, hidden 64) or raises.
    """
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
               value_coef=value_coef, tile=tile, kl_mode=kl_mode)
    if data.device.type == "cpu":
        sums = ppo_loss_grads_reference(data, adv_stats, perm, net, hidden=hidden, **cfg)
        return _finish(sums, m * tile, ent_coef, layout)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    require_kernel_dims("K3", d, adim, hidden)
    if m == 0:
        raise ValueError("perm is empty")
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
            clip_eps, value_clip_eps, value_coef, int(kl_mode), blocks, partials.data_ptr(),
            sums.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(rc, "ppo_loss_launch")
    ppo_loss_grads_gather.launches += 1
    return _finish(sums, m * tile, ent_coef, layout)


#: Kernel launches so far (a run can show that its path went through K3).
ppo_loss_grads_gather.launches = 0


def ppo_loss_grads(obs, act, old_logp, old_value, adv, ret, net, *, clip_eps: float,
                   value_clip_eps: float, value_coef: float, ent_coef: float,
                   kl_beta: float | None = None, hidden: int = 64):
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
        tile=data.shape[1], kl_mode=kl_beta is not None, hidden=hidden)
