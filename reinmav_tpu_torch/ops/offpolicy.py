"""Kernel K7: the fused off-policy collection step of SAC, TD3 and DDPG,
and its plain twin.

The counterpart of :mod:`reinmav_tpu.ops.pallas_offpolicy` (every kind of
:data:`reinmav_tpu_torch.ops.ppo_rollout.ENVS`: quadrotor3d-v0, the hover
task, quadrotor2d-v0 and the two slung-load envs).  :func:`collect_step` runs
one collection iteration in one CUDA kernel written by hand for Hopper
(``csrc/offpolicy_collect.cu``, a template on the env structs of
``csrc/env_kinds.cuh`` that K2/K6-hover share): the actor MLP (ReLU
hiddens, linear head), the action (SAC's tanh-Gaussian or TD3's tanh plus
clipped noise; the ``_det`` modes without noise), the warmup gate, the
per-dim affine into the env's physical action box, the env step with the
live params, the replay block in ring row order (obs, policy-space
action, raw reward, the TERMINAL next_obs, done), and the auto-reset of
the done envs after the block is written.
:func:`collect_step_reference` is its plain PyTorch twin: the same
float32 arithmetic and the same Philox4x32-10 draws (action noise on
stream 3, warmup uniforms on stream 4, the U(-1, 1)^D resets on stream 5
of :func:`reinmav_tpu_torch.ops.rollout.philox_words`; K2 uses streams 1
and 2), so the two agree on the card, and the CPU tests run the twin.

``compute_dtype="bfloat16"`` is the TPU kernel's bf16 mode: the operands
of the actor's three products (the weights, the states, both ReLU
layers) rounded to bf16 and the exact products summed in float32.  On the
card it runs a body of its own (``csrc/offpolicy_collect_bf16.cuh``): the
hidden layers on the tensor cores, W2 whole in shared memory.  The twin
sums each unit in a fixed order (:func:`_actor_bf16`), and the kernel
recomputes in that order every unit near a bf16 rounding midpoint or
near 0, so that the bf16 hidden layers, and the head summed in the
twin's order, are the twin's wherever the tensor cores' sum lies within
that margin of the twin's (a margin chosen by hand, not a bound: a sum
whose products cancel can leave it).  :func:`collect_step_bf16_probe`
counts the units recomputed and the misses.

Widths: each hidden layer from 1 to 1024 units (the TPU kernel takes any
two).  Two instances of each dtype run on the card, picked by
:func:`kernel_instance`: the narrow ones while both layers are at most 256
wide (``csrc/offpolicy_collect.cu``, ``csrc/offpolicy_collect_bf16.cuh``;
counted on :func:`collect_step`), the wide ones past that
(``csrc/offpolicy_collect_wide.cu``, the env tile shrinking with H1 so
that h1 fits a CTA's shared memory; ``csrc/offpolicy_collect_wide_bf16.cu``,
W2 streamed through a ring; counted on :func:`_launch_wide`).  The wide
bf16 instance is two launches: a pack kernel (:func:`_pack_wide`, its twin
:func:`pack_reference`) writes the weights into the layouts the body
reads, then the body; it widens its layer-2 recompute window with H1
(:func:`tie_scale`).

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel of the dtype asked for or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..rl.networks import bf16_round, is_bf16
from .closed_loop_rollout import TAUT_KINDS, check_counts, taut_twin
from .ppo_rollout import ENVS, PROBE_KEYS, _env_twin, normal_draws, probe_counts
from .rollout import mantissa_fill, philox_words

#: Sampling modes, by their id in the C entry point.  The ``_det`` modes
#: take eps = 0 (SAC) or noise = 0 (TD3).
MODES = {"sac": 0, "sac_det": 1, "td3": 2, "td3_det": 3}
#: The widest hidden layer the kernel takes (each of the two, from 1).
MAX_HIDDEN = 1024
#: The widest layer of the narrow instances (both layers at most this wide).
NARROW_HIDDEN = 256
_EPS_STREAM, _WARM_STREAM, _RESET_STREAM = 3, 4, 5


def supported(env) -> bool:
    """Whether K7 covers ``env``: its name is a kind of :data:`ENVS` and
    its flat state IS the observation (the block stores obs = state rows)."""
    return env.name in ENVS and env.state_dim == env.obs_dim


def width_refusal(hidden) -> str | None:
    """Why the kernel cannot take an actor of these hidden widths (None =
    it can): two layers, each from 1 to 1024 wide (the narrow instances
    while both are at most 256, the wide ones past that:
    :func:`kernel_instance`)."""
    hidden = tuple(hidden)
    if len(hidden) != 2:
        return f"hidden {hidden} is not two layers"
    if not all(1 <= h <= MAX_HIDDEN for h in hidden):
        return f"hidden widths {hidden}: K7 takes each layer from 1 to {MAX_HIDDEN} wide"
    return None


def kernel_instance(hidden) -> str | None:
    """The instance that runs an actor of these hidden widths on the card:
    "narrow" while both layers are at most 256 wide, "wide" up to 1024,
    None where :func:`width_refusal` refuses."""
    if width_refusal(hidden) is not None:
        return None
    return "narrow" if max(hidden) <= NARROW_HIDDEN else "wide"


def tie_scale(h1: int) -> float:
    """The wide bf16 instance's layer-2 recompute window over the narrow
    instance's (2^-19 + 2^-18 |v|), for a chain of ``h1`` products: 1 up
    to 256, then h1 / 256 (the window grows with the chain's length), as
    the kernel takes it (``csrc/offpolicy_collect_wide.cuh::l2_tie_scale``).
    The probe's largest |sum - twin's| / tie of layer 2 times this is the
    same ratio at the narrow instance's window."""
    return max(1.0, h1 / NARROW_HIDDEN)


def actor_kernel_args(layers):
    """A 2-hidden-layer actor's layer list (``[{"w": (din, dout), "b":
    (dout,)}, ...]``, e.g. :meth:`reinmav_tpu_torch.rl.sac.MlpLayout.layers`)
    -> the kernel's six weight arguments ``(w1, b1, w2, b2, w3, b3)``."""
    if len(layers) != 3:
        raise ValueError(f"K7 needs a 2-hidden-layer actor, got {len(layers) - 1} hidden layers")
    return tuple(t for layer in layers for t in (layer["w"], layer["b"]))


def _check_args(env_kind, mode, states_t, seed, consts, params_vec, weights) -> torch.Tensor:
    """Validate what the kernel takes; returns the kind's params vector."""
    if env_kind not in ENVS:
        raise ValueError(f"env_kind {env_kind!r}: K7 takes {sorted(ENVS)}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: K7 takes {sorted(MODES)}")
    kind = ENVS[env_kind]
    d, a = kind.state_dim, kind.action_dim
    names = ("states_t", "consts", "w1", "b1", "w2", "b2", "w3", "b3")
    for name, t in zip(names, (states_t, consts, *weights)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != states_t.device:
            raise ValueError(f"{name} is on {t.device}, states_t on {states_t.device}")
    if states_t.dim() != 2 or states_t.shape[0] != d or states_t.shape[1] == 0:
        raise ValueError(f"states_t must be ({d}, B) with B > 0, got {tuple(states_t.shape)}")
    w1, b1, w2, b2, w3, b3 = weights
    h1 = w1.shape[1] if w1.dim() == 2 else -1
    h2 = w2.shape[1] if w2.dim() == 2 else -1
    out = 2 * a if mode.startswith("sac") else a
    shapes = ((w1, (d, h1)), (b1, (h1,)), (w2, (h1, h2)), (b2, (h2,)), (w3, (h2, out)),
              (b3, (out,)))
    for name, (t, shape) in zip(names[2:], shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for mode {mode!r}, got {tuple(t.shape)}")
    if consts.shape != (2 + 2 * a,):
        raise ValueError(f"consts must be ({2 + 2 * a},), got {tuple(consts.shape)}")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed must fit in uint32, got {seed}")
    params = kind.pack(None) if params_vec is None else params_vec
    n_params = kind.pack(None).shape[0]
    if params.shape != (n_params,):
        raise ValueError(f"params_vec must be ({n_params},), got {tuple(params.shape)}")
    return params.detach().to("cpu", torch.float32)


def _normal(env_idx: torch.Tensor, seed: int, a: int) -> torch.Tensor:
    """K7's N(0, 1) draws, ``(a, n)``: K2's Box-Muller on stream 3."""
    return normal_draws(env_idx, 0, seed, a, _EPS_STREAM)


def _uniform_pm1(env_idx: torch.Tensor, seed: int, a: int) -> torch.Tensor:
    """K7's warmup U(-1, 1) draws, ``(a, n)``: one Philox block on stream 4."""
    f12 = mantissa_fill(philox_words(env_idx, 0, seed, 1, _WARM_STREAM)[:a])
    return 2.0 * (f12 - 1.0) - 1.0


def _check_counts(counts, env_kind, states_t) -> None:
    if counts is not None and env_kind not in TAUT_KINDS:
        raise ValueError(f"taut counts are kept for {TAUT_KINDS}, not {env_kind!r}")
    check_counts(counts, states_t)


#: Units of a chunk of the head's fold in the kernel (``kChunk``).
_CHUNK = 32


def _actor_bf16(x, w1, b1, w2, b2, w3, b3):
    """The actor's head outputs ``(OUT, B)`` with bf16 products, each sum
    in a fixed order: each first-layer unit from 0 over the state dims in
    order, then its bias; each second-layer unit from 0 over the first
    layer's units in order, then its bias; the head folded chunk by chunk
    of 32 units (in a chunk, lane g of 4 sums its units 4 g + k and 16 + 4
    g + k, k = 0..3, each run from 0; the lanes add as (0 + 2) + (1 + 3)),
    the chunks added in order from 0, then the head's bias.  Every product
    of two bf16 values is exact in float32, so each sum rounds as an FMA
    chain in that order does: the kernel's head, and its hidden units near
    a bf16 rounding midpoint or near 0."""
    r = bf16_round
    xr, w1r, w2r, w3r = r(x), r(w1), r(w2), r(w3)
    acc = torch.zeros((w1.shape[1], x.shape[1]), dtype=torch.float32, device=x.device)
    for d in range(x.shape[0]):
        acc = acc + w1r[d][:, None] * xr[d]
    h1 = r(torch.relu(acc + b1[:, None]))
    acc = torch.zeros((w2.shape[1], x.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(w2.shape[0]):
        acc = acc + w2r[j][:, None] * h1[j]
    h2 = r(torch.relu(acc + b2[:, None]))
    pad = -h2.shape[0] % _CHUNK  # zero units past the width add +0
    h2 = torch.cat([h2, h2.new_zeros((pad, h2.shape[1]))])
    w3r = torch.cat([w3r, w3r.new_zeros((pad, w3r.shape[1]))])
    # prod[o, c, half, g, k, e]: unit 32 c + 16 half + 4 g + k.
    prod = (w3r.T[:, :, None] * h2[None]).reshape(w3.shape[1], -1, 2, 4, 4, x.shape[1])
    halves = []
    for half in range(2):
        s = torch.zeros_like(prod[:, :, half, :, 0])
        for k in range(4):
            s = s + prod[:, :, half, :, k]
        halves.append(s)
    v = halves[0] + halves[1]  # (OUT, chunks, 4 lanes, B)
    chunk = (v[:, :, 0] + v[:, :, 2]) + (v[:, :, 1] + v[:, :, 3])
    head = torch.zeros((w3.shape[1], x.shape[1]), dtype=torch.float32, device=x.device)
    for c in range(chunk.shape[1]):
        head = head + chunk[:, c]
    return head + b3[:, None]


def collect_step_reference(env_kind: str, mode: str, states_t, seed: int, consts,
                           params_vec, w1, b1, w2, b2, w3, b3,
                           counts: torch.Tensor | None = None, compute_dtype=None):
    """Plain PyTorch twin of K7, on any device: the same float32
    arithmetic and the same Philox draws.  Its products are float32
    matmuls (on a CUDA device the caller keeps TF32 off), or with
    ``compute_dtype`` "bfloat16" the bf16 products of :func:`_actor_bf16`.
    Same arguments and returns as :func:`collect_step`."""
    params = _check_args(env_kind, mode, states_t, seed, consts, params_vec,
                         (w1, b1, w2, b2, w3, b3))
    _check_counts(counts, env_kind, states_t)
    kind = ENVS[env_kind]
    a = kind.action_dim
    seed = int(seed)
    env_step, env_reset = _env_twin(env_kind, params, reset_stream=_RESET_STREAM)
    env_idx = torch.arange(states_t.shape[1], device=states_t.device)

    x = states_t
    if is_bf16(compute_dtype):
        out = _actor_bf16(x, w1, b1, w2, b2, w3, b3)
    else:
        h = torch.relu(w1.T @ x + b1[:, None])
        h = torch.relu(w2.T @ h + b2[:, None])
        out = w3.T @ h + b3[:, None]
    if mode.startswith("sac"):
        u = out[:a]
        if mode == "sac":
            log_std = torch.clamp(out[a:2 * a], -20.0, 2.0)
            u = u + torch.exp(log_std) * _normal(env_idx, seed, a)
        a_pol = torch.tanh(u)
    else:
        a_pol = torch.tanh(out[:a])
        if mode == "td3":
            a_pol = torch.clamp(a_pol + consts[1] * _normal(env_idx, seed, a), -1.0, 1.0)
    a_t = torch.where(consts[0] > 0.5, _uniform_pm1(env_idx, seed, a), a_pol)
    lo, hi = consts[2:2 + a, None], consts[2 + a:2 + 2 * a, None]
    act = lo + (a_t + 1.0) * (0.5 * (hi - lo))

    if counts is not None:
        counts += taut_twin(env_kind, params)(x)
    new, raw, done = env_step(x, act)
    block = torch.cat([x, a_t, raw[None], new, done[None].to(torch.float32)])
    new = new.clone()
    env_reset(new, done, 0, seed)
    return new, block


def collect_step(env_kind: str, mode: str, states_t, seed: int, consts, params_vec,
                 w1, b1, w2, b2, w3, b3, counts: torch.Tensor | None = None,
                 compute_dtype=None):
    """K7: one off-policy collection iteration in one CUDA launch.

    ``env_kind`` an :data:`ENVS` name; ``mode`` one of :data:`MODES`;
    ``states_t`` ``(D, B)`` float32 (D its state dim), any ``B > 0``; ``seed`` the uint32 Philox key of the noise, warmup and reset
    draws; ``consts`` ``[warm_gate, explore_noise, lo (A), hi (A)]``
    float32 on the same device (warm_gate > 0.5 takes the uniform draws);
    ``params_vec`` the env's live Params packed by the kind's ``pack``
    (default Params when None); the actor's weights ``w1 (D, H1), b1 (H1,),
    w2 (H1, H2), b2 (H2,), w3 (H2, OUT), b3 (OUT,)`` with OUT = 2A for the
    SAC modes (mean, log_std) and A for the TD3 modes
    (:func:`actor_kernel_args`).  Returns ``(new states (D, B), block
    (2D + A + 2, B))``, float32.  ``counts``: None (every training path),
    or a ``(B,)`` int32 tensor on the states' device to which each env's
    taut tether at the start of the step (0 or 1) is added (the slung-load
    kinds: a counting kernel, bitwise the main path's otherwise).
    ``compute_dtype`` None or "float32", or "bfloat16" (the kernel's bf16
    instance, the twin's :func:`_actor_bf16`).
    Launches on the current stream and does not synchronise.  A CPU tensor
    runs the plain twin; a CUDA tensor runs the instance
    :func:`kernel_instance` names for the widths, or raises where
    :func:`width_refusal` refuses them.  The narrow instance is counted
    here, the wide one on :func:`_launch_wide` (bf16: after the pack,
    counted on :func:`_pack_wide`); the taut counts are the narrow
    instance's."""
    bf16 = is_bf16(compute_dtype)
    weights = (w1, b1, w2, b2, w3, b3)
    params = _check_args(env_kind, mode, states_t, seed, consts, params_vec, weights)
    _check_counts(counts, env_kind, states_t)
    if states_t.device.type == "cpu":
        return collect_step_reference(env_kind, mode, states_t, seed, consts, params, *weights,
                                      counts=counts, compute_dtype=compute_dtype)
    if states_t.device.type != "cuda":
        raise ValueError(f"unsupported device {states_t.device}")
    hidden = (w1.shape[1], w2.shape[1])
    reason = width_refusal(hidden)
    if reason is not None:
        raise ValueError(reason)
    if kernel_instance(hidden) == "wide":
        if counts is not None:
            raise ValueError("the taut counts are kept by K7's narrow instance (each layer at "
                             f"most {NARROW_HIDDEN} wide), not at hidden {hidden}")
        return _launch_wide(env_kind, mode, states_t, seed, consts, params, weights, bf16)
    from .._build import check, load_library

    lib = load_library()
    new, block, host_params = _outputs(env_kind, states_t, params)
    with torch.cuda.device(states_t.device):
        rc = lib.offpolicy_collect_launch(
            ENVS[env_kind].kind_id, MODES[mode], int(bf16), ctypes.addressof(host_params),
            params.shape[0], states_t.data_ptr(), states_t.shape[1], *hidden,
            *(t.data_ptr() for t in weights), consts.data_ptr(), int(seed), new.data_ptr(),
            block.data_ptr(), None if counts is None else counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "offpolicy_collect_launch")
    collect_step.launches += 1
    return new, block


def _launch_wide(env_kind: str, mode: str, states_t, seed: int, consts, params, weights,
                 bf16: bool, probe: torch.Tensor | None = None,
                 packed: torch.Tensor | None = None):
    """K7's wide instance (``csrc/offpolicy_collect_wide.cu``, float32, or
    ``csrc/offpolicy_collect_wide_bf16.cu``, bf16) on the CUDA inputs that
    :func:`_check_args` took, at any widths :func:`width_refusal` accepts
    (at most 256 a layer the float32 one gives the narrow instance's bits):
    ``(new states, block)``.  The bf16 body reads ``packed``, the weights
    as :func:`_pack_wide` leaves them (packed first when None); with
    ``probe`` (6 int32 on the device, zeroed) it runs its probe, which is
    not counted."""
    from .._build import check, load_library

    lib = load_library()
    w1, _, w2, _, _, _ = weights
    hidden = (w1.shape[1], w2.shape[1])
    new, block, host_params = _outputs(env_kind, states_t, params)
    if bf16 and packed is None:
        packed = _pack_wide(weights)
    common = (ENVS[env_kind].kind_id, MODES[mode])
    tail = (ctypes.addressof(host_params), params.shape[0], states_t.data_ptr(),
            states_t.shape[1], *hidden, *(t.data_ptr() for t in weights), consts.data_ptr(),
            int(seed), new.data_ptr(), block.data_ptr(),
            packed.data_ptr() if bf16 else None)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(states_t.device):
        if probe is None:
            rc = lib.offpolicy_collect_wide_launch(*common, int(bf16), *tail, stream)
        else:
            rc = lib.offpolicy_collect_wide_bf16_probe_launch(*common, *tail, probe.data_ptr(),
                                                              stream)
    check(rc, "offpolicy_collect_wide_launch" if probe is None else
          "offpolicy_collect_wide_bf16_probe_launch")
    if probe is None:
        if bf16:
            _launch_wide.launches_bf16 += 1
        else:
            _launch_wide.launches += 1
    return new, block


#: Launches of the wide instances so far, float32 and bf16 (a run can show
#: that its path went through K7 wide).
_launch_wide.launches = 0
_launch_wide.launches_bf16 = 0


def _pack_wide(weights) -> torch.Tensor:
    """K7 wide bf16's pack kernel (``offpolicy_wide_pack_kernel``) on the
    actor's CUDA weights ``(w1, b1, w2, b2, w3, b3)``: a new scratch buffer
    (uint8) holding W1ᵀ, W2 and W2ᵀ in bf16, W3 rounded to bf16 and the
    biases, in the layouts the body reads (:func:`pack_reference` is its
    twin).  Counted on its own."""
    from .._build import check, load_library

    lib = load_library()
    w1, b1, w2, b2, w3, _ = weights
    d, h1, h2, out = w1.shape[0], w1.shape[1], w2.shape[1], w3.shape[1]
    size = lib.offpolicy_collect_wide_scratch_bytes(h1, h2, out)
    if size <= 0:
        raise RuntimeError(f"offpolicy_collect_wide_scratch_bytes returned {size}")
    scratch = torch.empty(size, dtype=torch.uint8, device=w1.device)
    with torch.cuda.device(w1.device):
        rc = lib.offpolicy_collect_wide_bf16_pack_launch(
            d, h1, h2, out, *(t.data_ptr() for t in (w1, b1, w2, b2, w3)), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "offpolicy_collect_wide_bf16_pack_launch")
    _pack_wide.launches += 1
    return scratch


#: Launches of the wide bf16 instance's pack kernel so far (one before each
#: launch of the wide bf16 body on the training paths).
_pack_wide.launches = 0


def pack_reference(w1, b1, w2, b2, w3) -> torch.Tensor:
    """The plain twin of :func:`_pack_wide`: the bytes it writes, in
    ``csrc/offpolicy_collect_wide.cuh``'s ``Bf16Pack`` order, each array
    zero past the widths: W1ᵀ (H1 rounded up to 128, 16) bf16, W2 (H1
    rounded up to 64, H2 rounded up to 128) bf16, W2ᵀ bf16, W3ᵀ (OUT, H2
    rounded up to 128) float32 holding bf16 values, b1 and b2 float32 at
    the padded widths (every array a multiple of 16 bytes, so nothing lies
    between them)."""
    d, h1 = w1.shape
    h2, out = w3.shape
    k1p, k2, n2p = (-(-n // m) * m for n, m in ((h1, 128), (h1, 64), (h2, 128)))

    def padded(t, rows, cols=None):
        z = t.new_zeros((rows,) if cols is None else (rows, cols))
        z[tuple(slice(0, n) for n in t.shape)] = t
        return z

    w2p = padded(w2, k2, n2p)
    arrays = (padded(w1.T, k1p, 16).to(torch.bfloat16), w2p.to(torch.bfloat16),
              w2p.T.contiguous().to(torch.bfloat16),
              padded(w3.T.to(torch.bfloat16).to(torch.float32), out, n2p), padded(b1, k1p),
              padded(b2, n2p))
    return torch.cat([a.contiguous().view(torch.uint8).reshape(-1) for a in arrays])


def _outputs(env_kind: str, states_t, params: torch.Tensor):
    """A launch's new states and block, and its host params."""
    kind = ENVS[env_kind]
    block = torch.empty((2 * kind.state_dim + kind.action_dim + 2, states_t.shape[1]),
                        dtype=torch.float32, device=states_t.device)
    return (torch.empty_like(states_t), block,
            (ctypes.c_float * params.shape[0])(*params.tolist()))


def collect_step_bf16_probe(env_kind: str, mode: str, states_t, seed: int, consts, params_vec,
                            w1, b1, w2, b2, w3, b3):
    """K7's bf16 instance as its probe launches it (mode "sac" or "td3"; a
    CUDA tensor only; no training path calls it): every hidden unit also
    recomputed in the twin's order and compared.  Returns ``(new states,
    block, counts)``: the bf16 instance's outputs and
    ``ppo_rollout.probe_counts`` (``h1_worst``, ``h2_worst``: the largest
    |pre-activation - the twin's| of each layer over the kernel's tie,
    2^-19 + 2^-18 |v|, layer 2's times :func:`tie_scale` in the wide
    instance).  The instance is :func:`kernel_instance`'s for the widths."""
    weights = (w1, b1, w2, b2, w3, b3)
    params = _check_args(env_kind, mode, states_t, seed, consts, params_vec, weights)
    if states_t.device.type != "cuda" or mode not in ("sac", "td3"):
        raise ValueError("the probe runs K7's bf16 kernel in mode sac or td3, on a CUDA tensor")
    hidden = (w1.shape[1], w2.shape[1])
    reason = width_refusal(hidden)
    if reason is not None:
        raise ValueError(reason)
    words = torch.zeros(len(PROBE_KEYS), dtype=torch.int32, device=states_t.device)
    if kernel_instance(hidden) == "wide":
        new, block = _launch_wide(env_kind, mode, states_t, seed, consts, params, weights, True,
                                  probe=words)
        return new, block, probe_counts(words)
    from .._build import check, load_library

    lib = load_library()
    new, block, host_params = _outputs(env_kind, states_t, params)
    with torch.cuda.device(states_t.device):
        rc = lib.offpolicy_collect_bf16_probe_launch(
            ENVS[env_kind].kind_id, MODES[mode], ctypes.addressof(host_params), params.shape[0],
            states_t.data_ptr(), states_t.shape[1], w1.shape[1], w2.shape[1],
            *(t.data_ptr() for t in weights), consts.data_ptr(), int(seed), new.data_ptr(),
            block.data_ptr(), words.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(rc, "offpolicy_collect_bf16_probe_launch")
    return new, block, probe_counts(words)


#: Kernel launches so far (a run can show that its path went through K7).
collect_step.launches = 0
