"""Profiling hooks (counterpart of ``endosr/utils/prof.py``).

``trace(logdir)`` records ``torch.profiler`` events (CPU, and CUDA kernels
on a card) over a block and writes them as a Chrome trace (open it in
Perfetto or ``chrome://tracing``); ``annotate(name)`` names a region in
that timeline (and, on a card, an NVTX range); ``timed`` is the median
wall time of a call, synchronised by reading its first output.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["trace", "timed", "annotate"]


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace", cuda: bool | None = None):
    """Profile the block into ``<logdir>/<name>.json`` (a Chrome trace);
    yields the ``torch.profiler.profile``. ``cuda``: record the card's
    kernels too (default: when a card is present)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() if cuda is None else cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the profiler's timeline (``record_function``);
    on a card also an NVTX range."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _wait(out) -> None:
    """Read the first element of ``out``'s first tensor to the host, which
    waits for the work that made it."""
    leaves = [t for t in torch.utils._pytree.tree_leaves(out)
              if torch.is_tensor(t)]
    if leaves and leaves[0].numel():
        leaves[0].reshape(-1)[:1].cpu()


def timed(fn, *args, iters: int = 10, **kwargs):
    """(median wall seconds of ``fn(*args, **kwargs)`` over ``iters`` calls
    after a warm-up call, the last output); each call ends by reading its
    first output tensor (:func:`_wait`)."""
    out = fn(*args, **kwargs)
    _wait(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _wait(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out
