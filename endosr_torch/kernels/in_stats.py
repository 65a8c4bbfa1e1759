"""One-pass InstanceNorm statistics: fp32 (Σx, Σx²) per (b, c) over H·W.

Port of ``endosr/kernels/in_stats.py::in_stats_pallas`` (TPU kernel
``pallas_call`` at ``:47``; the jnp sums at ``:45-46`` are its twin). The
CUDA kernels (``endosr_torch/csrc/in_stats.cu`` over ``in_stats.cuh``) read
x once, sum chunks of pixels in parallel and add the chunks' sums in a
fixed order, with no float atomics: a result is bit-stable from run to
run, and differs from the plain version's only by summation order. They
are bound by memory (x read once). :func:`in_stats_route` picks one:

- ``"vec16"``: x's channel vectors of 16 bytes are aligned (C·itemsize a
  multiple of 16, base and strides too) and C / (16 / itemsize) is a power
  of two ≤ 32. One launch: a block of 256 threads reads one chunk of one
  image with 16-byte loads, eight in flight a thread; the block that draws
  the last ticket of its image adds the chunks and writes the result.
- ``"v1"``: any other C or strides. Two launches (partial sums, then a
  finish kernel).

:func:`stats_plan` cuts H·W into chunks for both. The tickets are one
persistent zeroed int32 buffer per device (:func:`tickets`), which every
vec16 launch leaves at 0 and whose address stays the same until a larger B
needs more: calls on two streams at once would share it, and must not be
made. ``in_stats.launches`` counts launches, ``in_stats.routes`` counts
them per route.
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build
from endosr_torch.kernels._autograd import refuse_grad
from endosr_torch.utils.device import hold
from endosr_torch.utils.prof import annotate

__all__ = ["in_stats", "in_stats_plain", "in_stats_route", "stats_plan",
           "chunk_plan", "tickets", "launch"]

SMS = 132                 # streaming multiprocessors of an H100 SXM
PLAN_STEP = 64            # a chunk's pixels are a multiple of this
MAX_B = 65535             # B is the grid's y extent

_TICKETS: dict[torch.device, torch.Tensor] = {}


def stats_plan(b: int, hw: int, per_sm: int = 2) -> tuple[int, int]:
    """(chunks, pixels a chunk) of the statistics pass over ``hw`` pixels of
    each of ``b`` images: about ``per_sm`` blocks an SM of an H100 over the
    B · chunks blocks (two fit an SM on route vec16; v1 takes four, its
    chunking before this plan), a multiple of ``PLAN_STEP`` pixels a
    chunk, the last chunk cut where H·W ends; chunk k covers pixels
    [k·per, (k+1)·per)."""
    want = max(1, -(-per_sm * SMS // b))
    per = -(-hw // want)
    per = -(-per // PLAN_STEP) * PLAN_STEP
    return -(-hw // per), per


def chunk_plan(b: int, hw: int, route: str, per=None) -> tuple[int, int]:
    """(chunks, pixels a chunk) of a launch on ``route``: chunks of ``per``
    pixels if given, else :func:`stats_plan`'s for the route."""
    if per:
        return -(-hw // per), per
    return stats_plan(b, hw, 2 if route == "vec16" else 4)


def tickets(device: torch.device, b: int) -> torch.Tensor:
    """The int32 ticket counters of ``device`` (at least ``b`` of them, all
    0 between launches); made or grown outside a CUDA-graph capture only."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < b:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("in_stats: the ticket counters must be made "
                               "before a CUDA graph is captured (call once "
                               f"with B = {b} first)")
        t = torch.zeros(max(b, 8), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return hold(t)


def in_stats_route(dtype, c, strides, ptr):
    """Which kernel a CUDA call takes: ``"vec16"`` or ``"v1"``. ``strides``:
    x's (batch, row, column) strides in elements; ``ptr``: its base
    address."""
    v = 16 // dtype.itemsize
    g = c // v
    if (c % v == 0 and 1 <= g <= 32 and g & (g - 1) == 0 and ptr % 16 == 0
            and all(s % v == 0 for s in strides)):
        return "vec16"
    return "v1"


def in_stats_plain(x):
    """Plain PyTorch version: (Σx, Σx²) over H, W of NHWC ``x`` → two
    [B, C] fp32 tensors."""
    x32 = x.float()
    return x32.sum(dim=(1, 2)), (x32 * x32).sum(dim=(1, 2))


def launch(x, route=None, lib="in_stats", per=None):
    """(Σx, Σx²) of CUDA ``x`` through the kernel ``route`` names (default:
    the one :func:`in_stats_route` picks) of library ``lib``, in chunks of
    ``per`` pixels if given (else :func:`stats_plan`'s); counts nothing.
    Returns ((Σx, Σx²), route)."""
    _build.load(lib)
    b, h, w, c = x.shape
    if x.stride(-1) != 1:
        raise ValueError(f"x must have contiguous channels, got strides "
                         f"{x.stride()}")
    if b > MAX_B:
        raise ValueError(f"in_stats takes B ≤ {MAX_B}, got {b}")
    strides = (x.stride(0), x.stride(1), x.stride(2))
    route = route or in_stats_route(x.dtype, c, strides, x.data_ptr())
    chunks, per = chunk_plan(b, h * w, route, per)
    dev = x.device
    part = torch.empty((b, chunks, c, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, c, 2), dtype=torch.float32, device=dev)
    args = (_build.dtype_code(x.dtype), x.data_ptr(), *strides, b, h, w, c,
            chunks)
    if route == "vec16":
        fn = _build.load(lib, "in_stats_vec16")
        code = fn(*args, per, part.data_ptr(), tickets(dev, b).data_ptr(),
                  out.data_ptr(), _build.stream_ptr(dev))
        _build.check(lib, code, "in_stats_vec16")
    else:
        code = _build.load(lib)(*args, part.data_ptr(), out.data_ptr(),
                                _build.stream_ptr(dev))
        _build.check(lib, code)
    return (out[..., 0], out[..., 1]), route


def in_stats(x):
    """(Σx, Σx²) over the spatial dims of NHWC ``x`` → two [B, C] fp32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`in_stats_route` names (and raises if it cannot). Neither
    has a gradient: on CUDA under autograd it raises
    ``NotImplementedError`` (the JAX kernel has none on the TPU)."""
    with annotate("kernel.in_stats"):
        if x.device.type == "cpu":
            return in_stats_plain(x)
        refuse_grad("in_stats", "in_stats: kernel", (x,))
        sums, route = launch(x)
        in_stats.launches += 1
        in_stats.routes[route] += 1
        return sums


in_stats.launches = 0
in_stats.routes = {"vec16": 0, "v1": 0}
