"""Profiling and numerical-debugging hooks (counterpart of
``tcsfm/utils/profiling.py``).

  * ``trace(logdir)``: ``torch.profiler`` over a region, CPU activity and,
    where a card is present, CUDA kernels, written under ``logdir`` as a
    Chrome trace (``trace.json``) that names every launched kernel.
  * ``enable_nan_debugging()``: ``torch.autograd.set_detect_anomaly(True)``.
  * ``time_region``: host-side timing of a region.
  * ``force_completion(tree)``: a scalar fetch of every tensor leaf.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the region; writes ``logdir/trace.json`` (Chrome trace
    format, readable by TensorBoard's and Perfetto's viewers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_debugging() -> None:
    """Autograd anomaly detection: the backward pass raises at the first
    operation whose gradient holds a NaN, naming the forward operation
    that made it. This checks backward passes only; the JAX package's
    ``jax_debug_nans`` checks the output of every operation."""
    import torch

    torch.autograd.set_detect_anomaly(True)


@contextlib.contextmanager
def time_region(name: str, result_holder: Optional[dict] = None
                ) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if result_holder is not None:
            result_holder[name] = dt
        print(f"[tcsfm.profiling] {name}: {dt * 1000:.2f} ms")


def force_completion(tree) -> float:
    """The sum of every tensor leaf of ``tree`` (nested dicts, lists,
    tuples) as a Python float: fetching it waits for the card."""
    import torch

    def leaves(x):
        if torch.is_tensor(x):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)

    total = 0.0
    for leaf in leaves(tree):
        total += float(leaf.sum())
    return total
