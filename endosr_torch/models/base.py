"""BaseModel — the training-wrapper contract (counterpart of
``endosr/models/base.py``).

The reference's model API (``feed_data / optimize_parameters / test /
get_current_log / update_learning_rate / save / resume_training ...``)
over torch modules and a ``torch.optim`` optimizer. The LR schedule is a
closed-form function of the update count (``models/lr_schedule.py``), set
into the optimizer before every update, so ``update_learning_rate`` is a
query.

Checkpoints keep the JAX package's two-file scheme with torch files: the
weights as ``{iter}_{label}.pth`` (the ``state_dict`` under the reference
checkpoint's keys, which the JAX package's porter loads) in
``path.models``, and the trainer state as ``{iter}.state`` in
``path.training_state`` (epoch, iteration, updates made, the optimizer's
``state_dict``, the generator's ``state_dict``, the dynamic loss's weights
where the model has them, and what a model adds by
:meth:`BaseModel._extra_training_state`, such as a second network and its
optimizer). Both are written to a temporary file and renamed into place.

Under data parallelism (``mesh``: ``parallel/mesh.py``'s 1-D mesh; None
means the default one, which is None in a single process) a model averages
its gradients over the ranks before every update
(:meth:`BaseModel._sync_grads`), computes its global-batch losses with
the mesh, averages its logs over the ranks, and :meth:`sync_replicas`
broadcasts rank 0's weights and optimizer state (a resume calls it; every
rank reads rank 0's files).

Weights load as the JAX package's porter reads them
(``utils/port_params.py::fit_state_dict``): keys of modules the network
does not build are dropped and logged, and ``strict_load`` asks that every
key of the network be present.
"""

from __future__ import annotations

import os

import torch

from endosr_torch.models.lr_schedule import build_schedule
from endosr_torch.parallel.mesh import allreduce_grads, get_mesh, replicate
from endosr_torch.utils.port_params import fit_state_dict, load_params

__all__ = ["BaseModel"]


def _save_atomic(obj, path: str) -> str:
    """``torch.save(obj)`` to ``path`` through a temporary file, so that a
    crash while saving never leaves a torn file at ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def _host(sd):
    return {k: v.detach().cpu() for k, v in sd.items()}


class BaseModel:
    """The training-state checkpoints act on ``self.netG``,
    ``self.optimizer_G`` and ``self.dyn_weight`` (None without the dynamic
    loss), and on what :meth:`_extra_training_state` adds."""

    dyn_weight = None

    def __init__(self, opt, mesh=None):
        self.opt = opt
        self.mesh = mesh if mesh is not None else get_mesh()
        self.is_train = bool(opt.get("is_train"))
        self.log_dict: dict[str, float] = {}
        self.schedule = None
        self.step = 0                   # optimizer updates made
        if self.is_train and opt.get("train"):
            self.schedule = build_schedule(opt["train"])

    def feed_data(self, data):
        raise NotImplementedError

    def optimize_parameters(self, step=None):
        raise NotImplementedError

    def test(self):
        raise NotImplementedError

    def get_current_log(self):
        return self.log_dict

    def update_learning_rate(self, cur_iter=None):
        """The LR of update ``cur_iter`` (default: the next one); the
        schedule already holds the warmup (``train.warmup_iter``)."""
        return self.get_current_learning_rate(cur_iter)

    def get_current_learning_rate(self, cur_iter=None):
        if self.schedule is None:
            return 0.0
        return self.schedule(self.step if cur_iter is None else cur_iter)

    def save_network(self, network, network_label, iter_label) -> str:
        """``network``'s weights → ``path.models/{iter}_{label}.pth``."""
        return _save_atomic(_host(network.state_dict()), os.path.join(
            self.opt["path"]["models"], f"{iter_label}_{network_label}.pth"))

    def load_network(self, load_path, network, strict=True):
        """Load ``.npz`` (JAX parameters) or ``.pth`` (a ``state_dict``)
        weights into ``network``: keys of modules it does not build are
        dropped (and logged); with ``strict`` a key it has that the file
        lacks raises ``KeyError``; shapes must match."""
        if load_path.endswith(".ckpt"):
            raise NotImplementedError(
                f"{load_path}: a flax .ckpt is not read by the port; export "
                "the JAX parameters as a .npz (flax paths joined by '/') and "
                "load that")
        sd = fit_state_dict(load_params(load_path), network, strict,
                            load_path)
        network.load_state_dict(sd, strict=strict)

    def save_training_state(self, epoch, iter_step) -> str:
        """The trainer state → ``path.training_state/{iter}.state``."""
        state = {"epoch": int(epoch), "iter": int(iter_step),
                 "step": int(self.step),
                 "optimizer": self.optimizer_G.state_dict(),
                 "netG": _host(self.netG.state_dict()),
                 **self._extra_training_state()}
        if self.dyn_weight is not None:
            state["dyn_weight"] = self.dyn_weight.detach().cpu()
        return _save_atomic(state, os.path.join(
            self.opt["path"]["training_state"], f"{iter_step}.state"))

    def resume_training(self, resume_path):
        """Restore a ``.state`` file; returns (epoch, iter)."""
        state = torch.load(resume_path, map_location="cpu", weights_only=True)
        self.netG.load_state_dict(state["netG"])
        if (state.get("dyn_weight") is None) != (self.dyn_weight is None):
            raise ValueError(f"{resume_path}: the dynamic loss's weights do "
                             "not match this model's train options")
        if self.dyn_weight is not None:
            with torch.no_grad():
                self.dyn_weight.copy_(state["dyn_weight"])
        self.optimizer_G.load_state_dict(state["optimizer"])
        self._load_extra_training_state(state)
        self.step = state["step"]
        self.sync_replicas()
        return state["epoch"], state["iter"]

    def _replicas(self) -> list:
        """What :meth:`sync_replicas` broadcasts: the networks, their
        optimizers (their state) and the dynamic loss's weights."""
        return [getattr(self, k, None) for k in
                ("netG", "optimizer_G", "dyn_weight", "netD", "optimizer_D",
                 "segNet", "optimizer_seg")]

    def sync_replicas(self):
        """Broadcast rank 0's weights, buffers and optimizer state to every
        rank of the mesh (a no-op without one)."""
        if self.mesh is not None:
            replicate(self._replicas(), self.mesh)

    def _sync_grads(self, *optimizers):
        """Average the gradients of the ``optimizers``' parameters over the
        mesh's ranks (between ``backward()`` and ``step()``)."""
        if self.mesh is None:
            return
        allreduce_grads([p for o in optimizers for g in o.param_groups
                         for p in g["params"]], self.mesh)

    def _extra_training_state(self) -> dict:
        """What a model saves in ``{iter}.state`` besides the generator,
        its optimizer and the dynamic loss's weights."""
        return {}

    def _load_extra_training_state(self, state: dict) -> None:
        """Restore what :meth:`_extra_training_state` saved."""

    def get_network_description(self, network):
        """(description, number of parameters) of ``network``."""
        n = sum(p.numel() for p in network.parameters())
        return f"{network.__class__.__name__} with {n:,d} parameters", n
