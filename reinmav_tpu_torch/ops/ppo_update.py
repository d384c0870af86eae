"""Kernel K4: the whole PPO update phase in one launch; and its plain twin.

The counterpart of :mod:`reinmav_tpu.ops.pallas_ppo_update`.
:func:`ppo_update` runs every epoch x minibatch pass of an update (K3's
loss gradient over the minibatch, clip-by-global-norm, Adam and the
optional log-std floor) in one cooperative CUDA kernel written by hand
for Hopper (``csrc/ppo_update.cu``), with the parameters and Adam
moments updated in device memory between passes.  The minibatches are
read through the epoch-concatenated tile permutation straight from the
stacked batch (:func:`reinmav_tpu_torch.ops.ppo_loss.stack_batch`), as
K3 reads one.  :func:`ppo_update_reference` is its plain twin: a loop
over the passes of K3's twin, :func:`clip_adam` and the floor, with the
same metric sums.

The TPU kernel's packed parameter plane and structure masks
(``pack_plane``, ``unpack_plane``, ``_structure_masks``) have no
counterpart: the flat :class:`reinmav_tpu_torch.rl.networks.Layout`
vector holds only the towers' real blocks.

``compute_dtype="bfloat16"``: each pass's loss gradient with K3's bf16
products (:mod:`reinmav_tpu_torch.ops.ppo_loss`); the params, the Adam
moments and the optimiser's arithmetic stay float32.

As K3, two kernels take the widths (:func:`reinmav_tpu_torch.ops.ppo_loss.
kernel_instance`): the 64-wide instances (``csrc/ppo_update.cu``) at hidden
(64, 64) and the ``ppo_loss.KERNEL_DIMS`` pairs, and the wide instances
(``csrc/ppo_update_wide.cu``, launched by :func:`_launch_wide`) at any two equal
hidden widths from 1 to 256; wider ones are refused by name.

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel of the dtype and widths asked for or
raises (a grid that cannot be co-resident raises too: there is no fallback
to the per-minibatch loop).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..rl import networks
from ..rl.networks import Layout, is_bf16
from . import ppo_loss as loss_ops

#: The kernel's raw metric sums: [pg, v, kl, clipfrac] over every processed
#: sample, the pre-step entropy summed over passes, the KL over the last
#: epoch's samples, and two zeros.
N_METRIC_SUMS = 8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5


class UpdateOut(NamedTuple):
    """What :func:`ppo_update` returns: the new flat params, the new Adam
    state (the caller's type, ``(count, mu, nu)``), the metric means (0-d
    tensors: ``pg_loss``, ``v_loss``, ``approx_kl``, ``clip_frac``,
    ``entropy``, and ``approx_kl_last`` in KL mode), and pass 0's finished
    gradient when asked for (else None)."""

    params: torch.Tensor
    opt_state: tuple
    metrics: dict
    grad0: torch.Tensor | None


def clip_adam(grads, count, mu, nu, params, *, max_norm: float | None, lr: float, b1: float = ADAM_B1,
              b2: float = ADAM_B2, eps: float = ADAM_EPS):
    """One step of optax's ``chain(clip_by_global_norm(max_norm), adam(lr,
    eps))`` on flat vectors, as K4 computes it: the gradient is scaled by
    ``max_norm / norm`` only when its global norm is at least ``max_norm``,
    then bias-corrected Adam with ``eps`` outside the square root.
    ``count`` is the step's Adam count (after the increment), a 0-d
    tensor; ``1 - b**count`` is taken in float64, then the moments' type:
    in float32, ``1 - f32(0.999)`` is off by 1.3e-5 relative at count 1.
    ``max_norm`` None: plain Adam, no clipping.  Returns ``(params, mu,
    nu)``."""
    g = grads
    if max_norm is not None:
        g_norm = torch.linalg.vector_norm(grads)
        g = torch.where(g_norm < max_norm, grads, grads / g_norm * max_norm)
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    c = count.to(torch.float64)
    bc1 = 1 - torch.pow(torch.full_like(c, b1), c)
    bc2 = 1 - torch.pow(torch.full_like(c, b2), c)
    step = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + eps)
    return params + (-lr) * step, mu, nu


def floor_log_std(params, layout: Layout, floor: float | None):
    """``params`` with the log-std entries clamped from below at ``floor``
    (unchanged when ``floor`` is None)."""
    if floor is None:
        return params
    ls = layout.slices[("log_std",)]
    return torch.cat([params[:ls.start], torch.clamp(params[ls], min=floor), params[ls.stop:]])


def _metric_means(sums, n_passes: int, n_minibatches: int, mb: int, kl_mode: bool) -> dict:
    """The kernel's raw sums -> the per-sample and per-pass means."""
    means = dict(zip(loss_ops.METRICS, (sums[:4] / (n_passes * mb)).unbind()))
    means["entropy"] = sums[4] / n_passes
    if kl_mode:
        means["approx_kl_last"] = sums[5] / (n_minibatches * mb)
    return means


def ppo_update_reference(data, adv_stats, perm_all, params, opt_state, kl_beta, *, d: int,
                         adim: int, tile: int, n_minibatches: int, n_epochs: int,
                         clip_eps: float, value_clip_eps: float, value_coef: float,
                         ent_coef: float, lr: float, max_grad_norm: float,
                         log_std_floor: float | None = None, kl_mode: bool = False,
                         hidden: int = 64, compute_dtype=None):
    """Plain twin of K4: for each pass, K3's twin
    (:func:`reinmav_tpu_torch.ops.ppo_loss.ppo_loss_grads_reference`) and
    :func:`reinmav_tpu_torch.ops.ppo_loss._finish`, then :func:`clip_adam`
    and the floor.  Returns ``(params, (count, mu, nu), metric sums (8,),
    pass 0's gradient)``; the arguments are :func:`ppo_update`'s."""
    layout = Layout(d, adim, (hidden, hidden))
    n_passes = n_epochs * n_minibatches
    tpm = perm_all.shape[0] // n_passes
    mb = tpm * tile
    count, mu, nu = opt_state
    zero = torch.zeros((), dtype=torch.float32, device=data.device)
    beta = kl_beta.to(torch.float32).reshape(()) if kl_mode else zero
    metric4 = torch.zeros(4, dtype=torch.float32, device=data.device)
    ent, kl_last, grad0 = zero, zero, None
    for p in range(n_passes):
        stats = torch.stack([adv_stats[p, 0], adv_stats[p, 1], beta, zero])
        sums = loss_ops.ppo_loss_grads_reference(
            data, stats, perm_all[p * tpm:(p + 1) * tpm], params, d=d, adim=adim,
            clip_eps=clip_eps, value_clip_eps=value_clip_eps, value_coef=value_coef, tile=tile,
            kl_mode=kl_mode, hidden=hidden, compute_dtype=compute_dtype)
        grads, _ = loss_ops._finish(sums, mb, ent_coef, layout)
        grad0 = grads if p == 0 else grad0
        ent = ent + networks.entropy(params[layout.slices[("log_std",)]])
        metric4 = metric4 + sums[layout.size:]
        if p >= n_passes - n_minibatches:
            kl_last = kl_last + sums[layout.size + 2]
        params, mu, nu = clip_adam(grads, count + (p + 1), mu, nu, params, max_norm=max_grad_norm,
                                   lr=lr)
        params = floor_log_std(params, layout, log_std_floor)
    metric_sums = torch.cat([metric4, ent.reshape(1), kl_last.reshape(1), zero.repeat(2)])
    return params, type(opt_state)(count + n_passes, mu, nu), metric_sums, grad0


def ppo_update(data, adv_stats, perm_all, params, opt_state, kl_beta, *, d: int, adim: int,
               tile: int, n_minibatches: int, n_epochs: int, clip_eps: float,
               value_clip_eps: float, value_coef: float, ent_coef: float, lr: float,
               max_grad_norm: float, log_std_floor: float | None = None, kl_mode: bool = False,
               hidden: int = 64, keep_grad0: bool = False, compute_dtype=None) -> UpdateOut:
    """K4: one full PPO update, ``n_epochs x n_minibatches`` passes, in one
    CUDA launch.

    ``data`` the ``(d + adim + 4, n)`` stacked batch with the RAW advantage
    row; ``adv_stats`` ``(E*M, 2)`` float32, each pass's advantage
    ``[shift, inv_scale]`` (``[0, 1]`` when off); ``perm_all`` ``(E *
    n_tiles,)`` int32, every epoch's tile permutation concatenated, pass
    ``p`` reading its slice ``p``; ``params`` the flat parameters;
    ``opt_state`` ``(count, mu, nu)`` with ``count`` an int32 0-d tensor
    (the Adam count before the update); ``kl_beta`` a float32 0-d tensor,
    read in ``kl_mode`` only (None otherwise).  Nothing is read back to
    the host.  ``compute_dtype`` None or "float32", or "bfloat16" (the
    bf16 instance: K3's bf16 products in every pass).  Returns
    :class:`UpdateOut`; the inputs are not modified.
    Launches on the current stream and does not synchronise.  A CPU tensor
    runs the plain twin; a CUDA tensor runs the 64-wide kernel (the
    ``ppo_loss.KERNEL_DIMS`` pairs, hidden 64; counted here) or the wide
    one (counted on :func:`_launch_wide`) as ``ppo_loss.kernel_instance``
    picks, or raises.
    """
    bf16 = is_bf16(compute_dtype)
    layout = Layout(d, adim, (hidden, hidden))
    count, mu, nu = opt_state
    for name, t in (("data", data), ("adv_stats", adv_stats), ("params", params), ("mu", mu),
                    ("nu", nu)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, data on {data.device}")
    if (perm_all.dtype != torch.int32 or perm_all.dim() != 1 or not perm_all.is_contiguous()
            or perm_all.device != data.device):
        raise ValueError("perm_all must be a contiguous 1-D int32 tensor on the device of data")
    if count.dtype != torch.int32 or count.shape != () or count.device != data.device:
        raise ValueError("the Adam count must be an int32 0-d tensor on the device of data")
    if kl_mode and (kl_beta is None or kl_beta.dtype != torch.float32 or kl_beta.numel() != 1
                    or kl_beta.device != data.device):
        raise ValueError("kl_mode needs kl_beta as a float32 scalar tensor on the device of data")
    rows, n = data.shape
    n_passes = n_epochs * n_minibatches
    if rows != d + adim + 4:
        raise ValueError(f"data must have {d + adim + 4} rows, got {rows}")
    if tile < 1 or n % tile or (n // tile) % n_minibatches:
        raise ValueError(f"tile {tile} x {n_minibatches} minibatches must divide the batch {n}")
    tpm = n // tile // n_minibatches
    if perm_all.shape != (n_epochs * n // tile,) or adv_stats.shape != (n_passes, 2):
        raise ValueError(f"perm_all must be ({n_epochs * n // tile},) and adv_stats "
                         f"({n_passes}, 2), got {tuple(perm_all.shape)} and "
                         f"{tuple(adv_stats.shape)}")
    for name, t in (("params", params), ("mu", mu), ("nu", nu)):
        if t.shape != (layout.size,):
            raise ValueError(f"{name} must be ({layout.size},), got {tuple(t.shape)}")
    mb = tpm * tile
    cfg = dict(d=d, adim=adim, tile=tile, n_minibatches=n_minibatches, n_epochs=n_epochs,
               clip_eps=clip_eps, value_clip_eps=value_clip_eps, value_coef=value_coef,
               ent_coef=ent_coef, lr=lr, max_grad_norm=max_grad_norm,
               log_std_floor=log_std_floor, kl_mode=kl_mode, hidden=hidden,
               compute_dtype=compute_dtype)
    if data.device.type == "cpu":
        new_params, new_opt, sums, grad0 = ppo_update_reference(
            data, adv_stats, perm_all, params, opt_state, kl_beta, **cfg)
        return UpdateOut(new_params, new_opt, _metric_means(sums, n_passes, n_minibatches, mb,
                                                            kl_mode), grad0 if keep_grad0 else None)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    wide = loss_ops.require_kernel_dims("K4", d, adim, hidden) == "wide"
    from .._build import check, load_library

    lib = load_library()
    dev = data.device
    with torch.cuda.device(dev):
        if wide:
            loss_ops.check_wide_layout(lib, d, adim, hidden)
            blocks = lib.ppo_loss_wide_blocks(mb)  # K3 wide's grid
        else:
            blocks = lib.ppo_loss_blocks(mb)  # K3's grid
        if blocks <= 0:
            raise RuntimeError(f"the K4 grid would be {blocks} CTAs")
        if lib.ppo_update_metrics_size() != N_METRIC_SUMS:
            raise RuntimeError("the K4 library writes another number of metric sums")
        new_params, new_mu, new_nu = params.clone(), mu.clone(), nu.clone()
        new_count = torch.empty((), dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        partials = torch.empty((blocks, layout.size + len(loss_ops.METRICS)), **f32)
        gbuf, slots = torch.empty(layout.size, **f32), torch.empty(blocks, **f32)
        sums = torch.empty(N_METRIC_SUMS, **f32)
        grad0 = torch.empty(layout.size, **f32) if keep_grad0 else None
        args = (
            data.data_ptr(), n, perm_all.data_ptr(), tile, tpm, n_passes, n_minibatches,
            adv_stats.data_ptr(), kl_beta.data_ptr() if kl_mode else None, count.data_ptr(),
            new_count.data_ptr(), new_params.data_ptr(), new_mu.data_ptr(), new_nu.data_ptr(),
            clip_eps, value_clip_eps, value_coef, 1.0 / mb, ent_coef, lr, max_grad_norm,
            ADAM_B1, ADAM_B2, ADAM_EPS, int(log_std_floor is not None),
            0.0 if log_std_floor is None else log_std_floor, int(kl_mode), int(bf16), blocks,
            partials.data_ptr(), gbuf.data_ptr(), slots.data_ptr(), sums.data_ptr(),
            None if grad0 is None else grad0.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if wide:
            plan = loss_ops.check_wide_plan(lib, d, adim, hidden, bf16, mb, blocks)
            packed, panels = loss_ops.wide_scratch(plan, blocks, dev)
            _launch_wide(lib, d, adim, hidden, loss_ops.wide_plan_args(plan), packed.data_ptr(),
                         panels.data_ptr(), *args)
        else:
            check(lib.ppo_update_launch(d, adim, *args), "ppo_update_launch")
            ppo_update.launches += 1
    return UpdateOut(new_params, type(opt_state)(new_count, new_mu, new_nu),
                     _metric_means(sums, n_passes, n_minibatches, mb, kl_mode), grad0)


#: Launches of the 64-wide kernel so far (a run can show that its path went
#: through K4).
ppo_update.launches = 0


def _launch_wide(lib, d: int, adim: int, hidden: int, plan, packed, panels, *args) -> None:
    """K4 wide (``csrc/ppo_update_wide.cu``) on the CUDA inputs that
    :func:`ppo_update` checked and sends here: the hidden width, the body's
    plan (``ppo_loss.wide_plan_args``) and the pointers of its packed
    weights and panels (``ppo_loss.wide_scratch``), then
    ``ppo_update_launch``'s arguments after the dims."""
    from .._build import check

    check(lib.ppo_update_wide_launch(d, adim, hidden, plan, packed, panels, *args),
          "ppo_update_wide_launch")
    _launch_wide.launches += 1


#: Launches of the wide kernel so far (a run can show that its path went
#: through K4 wide).
_launch_wide.launches = 0
