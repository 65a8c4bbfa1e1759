"""Process groups, the 1-D data mesh and data parallelism (counterpart of
``endosr/parallel/mesh.py``).

The JAX package trains one global-batch program over a ``Mesh(('data',))``
and lets XLA insert the cross-device sums. The port runs one process a
device, launched by ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node N -m endosr_torch.train ...``), and makes the same step
out of explicit collectives:

- every rank takes its own ``batch_size // world`` samples
  (``data/__init__.py``'s shards);
- each rank's loss is its part of the global loss, chosen so that the mean
  over the ranks is the global-batch loss: a mean of per-sample terms is
  the rank's own mean; a sum over samples is ``world`` × the rank's sum;
  a ratio of sums, or a statistic inside a nonlinearity, is computed from
  sums taken over every rank with :func:`global_sum` (an all-reduce
  through which the gradient flows), so every rank computes the global
  value;
- :func:`allreduce_grads` averages the gradients between ``backward()`` and
  ``step()``: with the rule above, the mean of the ranks' gradients is the
  gradient of the global-batch loss (the backward of :func:`global_sum`
  sums what every rank sends back through it);
- :func:`replicate` broadcasts rank 0's parameters, buffers and optimizer
  state, so every rank starts equal, also after a resume.

The backend is NCCL for CUDA devices and gloo on the CPU
(:func:`maybe_init_distributed`). The collectives here use only
``all_reduce`` and ``broadcast``, which gloo also carries for CUDA tensors
(several ranks on one card, as ``chip_smoke.py`` phase 14 runs them).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["Mesh", "maybe_init_distributed", "make_mesh", "get_mesh",
           "shard_batch", "replicate", "is_main_process", "world_size",
           "allreduce_grads", "global_sum", "global_mean", "mean_over_ranks"]


class Mesh:
    """A 1-D ``("data",)`` mesh: every rank of the default process group,
    and this rank's device. The method names are those of
    ``torch.distributed.device_mesh.DeviceMesh``."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        if self.device is not None and self.device.type == "cuda" \
                and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

    def size(self) -> int:
        return dist.get_world_size()

    def get_local_rank(self) -> int:
        return dist.get_rank()

    def get_group(self):
        return dist.group.WORLD


def maybe_init_distributed(backend: str | None = None, device=None,
                           timeout_s: float = 1800.0) -> bool:
    """Initialize the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``); a no-op
    without it, or when a group is already up. Returns whether a group is
    up. ``backend``: NCCL when ``device`` is CUDA (or None with a card
    present), gloo otherwise; an explicit ``backend`` wins (gloo for CUDA
    tensors lets several ranks share one card, which NCCL refuses)."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev = torch.device(device) if device is not None else None
    on_cuda = (dev.type == "cuda" if dev is not None
               else torch.cuda.is_available())
    if backend is None:
        backend = "nccl" if on_cuda else "gloo"
    if on_cuda and dev is not None and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_mesh(device=None) -> Mesh | None:
    """The 1-D mesh over every rank with this rank's ``device`` (default:
    ``cuda:LOCAL_RANK`` with a card, else the CPU); None when no process
    group is up (one process: no mesh)."""
    if not dist.is_initialized():
        return None
    if device is None:
        from endosr_torch.utils.device import local_device

        device = local_device()
    return Mesh(device)


def get_mesh() -> Mesh | None:
    """The default mesh: every rank of the default group, or None."""
    return make_mesh()


def world_size(mesh: Mesh | None = None) -> int:
    return 1 if mesh is None else mesh.size()


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def shard_batch(batch, mesh: Mesh | None = None):
    """This rank's part of a global host batch, on the mesh's device: a
    leaf whose leading dimension divides the world gives rank r its r-th
    block of rows; any other leaf is replicated (every rank takes it
    whole), as JAX's ``shard_batch`` does for leaves that do not divide
    the mesh. Strings, lists of them and None ride along on the host;
    numpy arrays become tensors. Without a mesh every leaf is whole, where
    it lies."""
    import numpy as np

    mesh = mesh or get_mesh()
    n = world_size(mesh)
    r = 0 if mesh is None else mesh.get_local_rank()
    device = None if mesh is None else mesh.device

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not torch.is_tensor(x):
            return x
        if x.ndim and x.shape[0] % n == 0:
            k = x.shape[0] // n
            x = x[r * k:(r + 1) * k]
        return x if device is None else x.to(device, non_blocking=True)

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return type(batch)(put(v) for v in batch)


def _tensors(tree):
    """Every tensor of ``tree`` (a module's parameters and buffers, an
    optimizer's state, tensors in lists, tuples and dicts), in a fixed
    order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.optim.Optimizer):
        for group in tree.param_groups:
            for p in group["params"]:
                for k in sorted(tree.state.get(p, {})):
                    v = tree.state[p][k]
                    if torch.is_tensor(v):
                        yield v
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif tree is not None:
        raise TypeError(f"replicate cannot walk a {type(tree).__name__}")


@torch.no_grad()
def replicate(tree, mesh: Mesh | None = None):
    """Broadcast every tensor of ``tree`` (modules, optimizers, tensors and
    containers of them) from rank 0 in place, so every rank holds rank 0's
    values; returns ``tree``. Tensors on another device than the mesh's
    (an Adam ``step`` on the CPU under NCCL) travel through a copy.
    Without a mesh it returns ``tree`` untouched."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return tree
    group = mesh.get_group()
    for t in _tensors(tree):
        if mesh.device is None or t.device == mesh.device:
            dist.broadcast(t.data, 0, group=group)
        else:
            moved = t.detach().to(mesh.device)
            dist.broadcast(moved, 0, group=group)
            t.data.copy_(moved)
    return tree


@torch.no_grad()
def allreduce_grads(params, mesh: Mesh | None = None) -> None:
    """Average the ``.grad`` of ``params`` over the ranks, in place: one
    all-reduce a (device, dtype), over the gradients flattened together.
    Parameters without a gradient are skipped (they lack one on every
    rank: the ranks run the same program). A no-op without a mesh."""
    if mesh is None:
        return
    n = mesh.size()
    buckets: dict = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault((p.grad.device, p.grad.dtype), []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.get_group())
        if n > 1:
            flat.div_(n)
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


def global_sum(x, mesh: Mesh | None = None):
    """The sum of ``x`` over the ranks, on every rank; the gradient flows
    back to each rank's ``x`` (``torch.distributed.nn.functional
    .all_reduce``). ``x`` itself without a mesh."""
    if mesh is None:
        return x
    if not x.requires_grad:
        x = x.clone()
        dist.all_reduce(x, group=mesh.get_group())
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=mesh.get_group())


def global_mean(x, mesh: Mesh | None = None):
    """The mean over the ranks of ``x``, a rank's mean over its own
    samples: the global-batch mean when every rank holds as many samples
    (the loader's shards do). ``x`` itself without a mesh."""
    if mesh is None:
        return x
    return global_sum(x, mesh) / mesh.size()


@torch.no_grad()
def mean_over_ranks(x, mesh: Mesh | None = None):
    """A detached tensor's mean over the ranks (the logs: JAX's logs are
    the global program's, replicated); ``x`` itself without a mesh."""
    if mesh is None:
        return x
    return global_sum(x.detach(), mesh) / mesh.size()
