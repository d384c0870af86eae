"""Actor-critic MLP of the PyTorch port: the reference's 2x64 tanh policy
with a diagonal-Gaussian head and a linear value head.

The counterpart of :mod:`reinmav_tpu.rl.networks`.  The parameters keep
the JAX pytree's layout (``pi[i].w/b``, ``vf[i].w/b``, ``pi_out``,
``vf_out``, ``log_std``; ``w`` as ``(in, out)``), stored as ONE flat
vector: the pytree's leaves in ``jax.tree.leaves`` order (dict keys
sorted, lists in index order), each raveled row-major (:class:`Layout`).
:meth:`Layout.unflatten` gives the pytree as views of that vector, so the
eager code reads ``params["pi"][0]["w"]`` as the JAX code does, while the
optimiser updates one tensor and the CUDA kernels (K2, K3) take one
pointer.  A JAX params pytree maps onto the vector leaf by leaf
(:func:`params_from_jax`).

Activations are batch-minor, ``(D, B)``, as in the JAX package's
transposed path (``apply_t``).  ``compute_dtype="bfloat16"`` (the JAX
package's bf16 matmul inputs with a bf16 autodiff residual) is not
ported: it raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

_LOG_2PI = math.log(2.0 * math.pi)
_BF16_NOT_PORTED = ("compute_dtype='bfloat16' (reinmav_tpu.rl.networks: bf16 matmul inputs "
                    "with a bf16 autodiff residual) is not ported yet: ROADMAP.md queue 1 item 5")


def _require_f32_compute(compute_dtype) -> None:
    if compute_dtype not in (None, "float32"):
        raise NotImplementedError(_BF16_NOT_PORTED)


class Layout:
    """Where each leaf of the params pytree lies in the flat vector.

    ``entries`` lists ``(path, shape)`` in ``jax.tree.leaves`` order, with
    ``path`` like ``("pi", 0, "w")``; ``slices`` maps a path to its
    ``slice`` of the flat vector."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64)):
        self.obs_dim, self.action_dim, self.hidden = obs_dim, action_dim, tuple(hidden)
        entries = [(("log_std",), (action_dim,))]
        for tower, head_dim in (("pi", action_dim), ("vf", 1)):
            in_dim = obs_dim
            for i, h in enumerate(self.hidden):
                entries += [((tower, i, "b"), (h,)), ((tower, i, "w"), (in_dim, h))]
                in_dim = h
            entries += [((f"{tower}_out", "b"), (head_dim,)),
                        ((f"{tower}_out", "w"), (in_dim, head_dim))]
        self.entries = entries
        self.slices, off = {}, 0
        for path, shape in entries:
            size = math.prod(shape)
            self.slices[path] = slice(off, off + size)
            off += size
        self.size = off

    @classmethod
    def of_tree(cls, tree) -> "Layout":
        """The layout of a params pytree (JAX's or :meth:`unflatten`'s)."""
        return cls(tree["pi"][0]["w"].shape[0], tree["log_std"].shape[0],
                   tuple(layer["w"].shape[1] for layer in tree["pi"]))

    def unflatten(self, flat: torch.Tensor) -> dict:
        """The params pytree as views of ``flat`` (gradients flow through)."""
        if flat.shape != (self.size,):
            raise ValueError(f"flat params must be ({self.size},), got {tuple(flat.shape)}")
        tree = {"pi": [{} for _ in self.hidden], "vf": [{} for _ in self.hidden],
                "pi_out": {}, "vf_out": {}}
        for path, shape in self.entries:
            leaf = flat[self.slices[path]].view(shape)
            if path == ("log_std",):
                tree["log_std"] = leaf
            elif len(path) == 3:
                tree[path[0]][path[1]][path[2]] = leaf
            else:
                tree[path[0]][path[1]] = leaf
        return tree

    def flatten(self, tree, device=None, dtype=torch.float32) -> torch.Tensor:
        """A params pytree (leaves as NumPy arrays or tensors) -> the flat
        vector.  Raises ``ValueError`` on a leaf of the wrong shape."""
        leaves = []
        for path, shape in self.entries:
            node = tree
            for key in path:
                node = node[key]
            leaf = node if isinstance(node, torch.Tensor) else torch.from_numpy(np.array(node))
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf {path} has shape {tuple(leaf.shape)}, expected {shape}")
            leaves.append(leaf.reshape(-1).to(device=device, dtype=dtype))
        return torch.cat(leaves)


def params_from_jax(tree, device=None, dtype=torch.float32) -> torch.Tensor:
    """The JAX package's params pytree (NumPy or JAX arrays) -> the port's
    flat parameter vector (:class:`Layout` of the tree's widths)."""
    return Layout.of_tree(tree).flatten(tree, device=device, dtype=dtype)


def init_params(layout: Layout, generator: torch.Generator, init_log_std: float = 0.0,
                dtype=torch.float32) -> torch.Tensor:
    """Orthogonal init as the JAX package does it (``networks.init_params``):
    gain sqrt(2) on the hidden layers, 0.01 on the policy head, 1 on the
    value head, zero biases, ``log_std = init_log_std``.  Drawn on the
    generator's device, in ``layout`` order."""
    flat = torch.zeros(layout.size, dtype=dtype, device=generator.device)
    for path, shape in layout.entries:
        if path[-1] != "w":
            continue
        gain = {"pi_out": 0.01, "vf_out": 1.0}.get(path[0], math.sqrt(2.0))
        w = torch.empty(shape, dtype=dtype, device=generator.device)
        nn.init.orthogonal_(w, gain=gain, generator=generator)
        flat[layout.slices[path]] = w.reshape(-1)
    flat[layout.slices[("log_std",)]] = init_log_std
    return flat


class ActorCritic(nn.Module):
    """The actor-critic as a module: one flat ``nn.Parameter`` in
    :class:`Layout` order; :meth:`params` is the JAX-layout pytree of
    views, :meth:`forward` is :func:`apply_t`."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64),
                 init_log_std: float = 0.0, generator: torch.Generator | None = None,
                 dtype=torch.float32, compute_dtype: str = "float32"):
        super().__init__()
        _require_f32_compute(compute_dtype)
        self.layout = Layout(obs_dim, action_dim, hidden)
        generator = generator or torch.Generator().manual_seed(0)
        self.flat = nn.Parameter(init_params(self.layout, generator, init_log_std, dtype))

    def params(self) -> dict:
        return self.layout.unflatten(self.flat)

    def forward(self, obs_t: torch.Tensor):
        return apply_t(self.params(), obs_t)


def _block_diag2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[[a, 0], [0, b]] for 2-D blocks."""
    za = a.new_zeros((a.shape[0], b.shape[1]))
    zb = b.new_zeros((b.shape[0], a.shape[1]))
    return torch.cat([torch.cat([a, za], dim=1), torch.cat([zb, b], dim=1)], dim=0)


def fused_weights(params):
    """The pi and vf towers as single wide layers (``networks.fused_weights``):
    ``(layers, w_out, b_out)`` with ``layers`` a list of ``(w, b)``, ``w``
    (in, 2H) for layer 0 and block-diagonal (2H, 2H) after; ``w_out``
    (2H, A+1) maps the last hidden to ``[action_mean..., value]``."""
    pi, vf = params["pi"], params["vf"]
    layers = [(torch.cat([pi[0]["w"], vf[0]["w"]], dim=1), torch.cat([pi[0]["b"], vf[0]["b"]]))]
    for lp, lv in zip(pi[1:], vf[1:]):
        layers.append((_block_diag2(lp["w"], lv["w"]), torch.cat([lp["b"], lv["b"]])))
    w_out = _block_diag2(params["pi_out"]["w"], params["vf_out"]["w"])
    b_out = torch.cat([params["pi_out"]["b"], params["vf_out"]["b"]])
    return layers, w_out, b_out


def apply_t(params, obs_t: torch.Tensor, compute_dtype=None):
    """Transposed fused forward: ``obs_t`` is ``(obs_dim, *batch)``.
    Returns ``(mean_t (A, *batch), log_std (A,), value (*batch))``."""
    _require_f32_compute(compute_dtype)
    layers, w_out, b_out = fused_weights(params)
    x = obs_t
    tail = (1,) * (x.dim() - 1)
    for w, b in layers:
        x = torch.tanh(torch.tensordot(w, x, dims=([0], [0])) + b.reshape(b.shape + tail))
    out = torch.tensordot(w_out, x, dims=([0], [0])) + b_out.reshape(b_out.shape + tail)
    return out[:-1], params["log_std"], out[-1]


def gaussian_log_prob_t(mean_t, log_std, action_t):
    """Log-prob with the action axis LEADING (axis 0)."""
    shape = log_std.shape + (1,) * (mean_t.dim() - 1)
    var = torch.exp(2.0 * log_std).reshape(shape)
    return torch.sum(-0.5 * torch.square(action_t - mean_t) / var - log_std.reshape(shape)
                     - 0.5 * _LOG_2PI, dim=0)


def sample_action_t(params, obs_t, generator: torch.Generator, compute_dtype=None):
    """Transposed diagonal-Gaussian sample -> ``(action_t (A, *batch),
    log_prob (*batch), value (*batch))``; the noise is N(0, 1) from
    ``generator`` (on the device of ``obs_t``)."""
    mean, log_std, value = apply_t(params, obs_t, compute_dtype)
    std = torch.exp(log_std).reshape(log_std.shape + (1,) * (mean.dim() - 1))
    noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    action = mean + std * noise
    return action, gaussian_log_prob_t(mean, log_std, action), value


def entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e))
