"""Device selection for the port's entry points, and device constants."""

from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "device_constant"]


@functools.lru_cache(maxsize=512)
def device_constant(build, args, dtype, device):
    """``torch.as_tensor(build(*args))`` on ``device``, made once per
    (build, args, dtype, device). A constant made inside a forward would
    otherwise be a synchronous host-to-device copy on every call, which
    stalls the host until the device's queue drains. Callers must not
    write to the returned tensor. It is made outside inference mode, so a
    constant first made by a serving call can still be saved for the
    backward of a training step."""
    with torch.inference_mode(False):
        return torch.as_tensor(build(*args), dtype=dtype, device=device)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA, and raises when no CUDA device is present: the port
    never carries on silently on the CPU. Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels on the CPU (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "endosr_torch runs on CUDA and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
