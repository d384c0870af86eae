"""Profiling and timing helpers of the PyTorch port.

The counterpart of :mod:`reinmav_tpu.utils.profiling`: a trace capture
(``torch.profiler``, with the card's kernels when a CUDA device is
present), a steady-state timer that waits for the device, and a check
for non-finite values in a tree of tensors.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (a Chrome/TensorBoard trace file); yields the profiler, whose
    ``key_averages()`` summarise the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _leaves(tree):
    """The tensors and numbers of a tree of tuples, lists and dicts."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree] if isinstance(tree, (torch.Tensor, int, float)) else []


def time_fn(fn, *args, warmup: int = 2, iters: int = 10):
    """Median time of ``fn(*args)`` in seconds, and the last result.

    The ``warmup`` calls absorb first-use costs (a kernel's build, the
    allocator).  Once CUDA is in use, each timed call lies between two CUDA
    events on the current stream, read after ``torch.cuda.synchronize()``,
    so the time is the device's, not the launch's; without CUDA each call
    is timed with the host clock."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            result = fn(*args)
            times.append(time.perf_counter() - t0)
        return statistics.median(times), result
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        start.record()
        result = fn(*args)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / 1e3, result


class NanGuard:
    """Detect non-finite values in a tree of tensors (the batched
    counterpart of the reference's NaN-done checks, ``mujoco_quad.py:52-53``)."""

    @staticmethod
    def check(tree, name: str = "tree") -> None:
        for i, leaf in enumerate(_leaves(tree)):
            finite = (bool(torch.isfinite(leaf).all()) if isinstance(leaf, torch.Tensor)
                      else math.isfinite(leaf))
            if not finite:
                raise FloatingPointError(f"non-finite values in {name} leaf {i}")
