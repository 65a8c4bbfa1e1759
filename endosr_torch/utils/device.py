"""Device selection for the port's entry points, and device constants."""

from __future__ import annotations

import contextlib
import functools
import os

import torch

__all__ = ["resolve_device", "local_device", "device_constant", "true_fp32",
           "held", "hold"]

# lists that collect the long-lived tensors handed out while they are open
_HOLDERS: list = []


@contextlib.contextmanager
def held():
    """Yields a list of every tensor :func:`hold` sees in the block: a CUDA
    graph captured there keeps them, so that a constant dropped from its
    cache (or a buffer replaced) is not freed while the graph reads it."""
    got = []
    _HOLDERS.append(got)
    try:
        yield got
    finally:
        _HOLDERS.remove(got)


def hold(t: torch.Tensor) -> torch.Tensor:
    """``t``, kept by every open :func:`held` block."""
    for h in _HOLDERS:
        h.append(t)
    return t


@functools.lru_cache(maxsize=512)
def _constant(build, args, dtype, device):
    with torch.inference_mode(False):
        return torch.as_tensor(build(*args), dtype=dtype, device=device)


def device_constant(build, args, dtype, device):
    """``torch.as_tensor(build(*args))`` on ``device``, made once per
    (build, args, dtype, device). A constant made inside a forward would
    otherwise be a synchronous host-to-device copy on every call, which
    stalls the host until the device's queue drains. Callers must not
    write to the returned tensor. It is made outside inference mode, so a
    constant first made by a serving call can still be saved for the
    backward of a training step."""
    return hold(_constant(build, args, dtype, device))


device_constant.cache_clear = _constant.cache_clear


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA, and raises when no CUDA device is present: the port
    never carries on silently on the CPU. Under ``torchrun`` (``LOCAL_RANK``
    set) it is ``cuda:LOCAL_RANK``. Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "endosr_torch runs on CUDA and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return local_device()
    return torch.device(device)


def local_device() -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (``torchrun``'s local
    rank, default 0, modulo the cards present, so that several ranks can
    share one card) with a card, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if "LOCAL_RANK" not in os.environ:
        return torch.device("cuda")
    rank = int(os.environ["LOCAL_RANK"])
    return torch.device("cuda", rank % torch.cuda.device_count())


def true_fp32(device: torch.device) -> None:
    """On CUDA, turn TF32 off for cuDNN's convolutions and for matmuls,
    process-wide, so that fp32 work is fp32 (the JAX package's fp32, to
    which the port is held): PyTorch's default runs fp32 convolutions on
    TF32 tensor cores (10-bit significands). The entry points call it
    before they build the model. ``nn/layers.py::centered_conv`` still
    allows TF32 inside its exact-product passes, whose operands TF32 holds
    exactly. Nothing changes on the CPU."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
