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

JAX's files (``utils/checkpoint.py``): :meth:`load_network` reads a flax
``.ckpt`` (JAX's ``{iter}_{label}.ckpt``) through ``port_params``'s
``from_flax*``, and :meth:`resume_training` reads a ``{iter}.state`` by
its content (a torch zip starts with ``PK\x03\x04``; anything else is
JAX's msgpack tree ``{epoch, iter, opt_state, params}``, the optimizer
states through ``utils/optim_state.py``). With ``path.checkpoint_backend:
msgpack`` (or ``ENDOSR_CKPT_BACKEND=msgpack``) the model writes JAX's
files, which the JAX package's ``load_network`` and ``resume_training``
read; ``orbax`` writes the same trees as orbax directories of those
names (``utils/orbax_io.py``); unset, it writes ``.pth`` files as above.
A directory loads as an orbax checkpoint wherever a ``.ckpt`` or a JAX
``.state`` does. A model's JAX tree is
:meth:`BaseModel._flax_training_state` (its parameters and the optax
chain states JAX's model keeps), read back by
:meth:`BaseModel._load_flax_training_state`; the GAN and co-training
models add their networks and optimizers to both.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from endosr_torch.models.lr_schedule import build_schedule
from endosr_torch.parallel.mesh import allreduce_grads, get_mesh, replicate
from endosr_torch.utils import checkpoint as ckpt
from endosr_torch.utils import optim_state as ost
from endosr_torch.utils.port_params import (fit_state_dict, from_flax,
                                            from_flax_gan, from_flax_train,
                                            load_params, to_flax, to_flax_gan,
                                            to_flax_train)

__all__ = ["BaseModel", "load_weights", "params_tree_of", "params_tree_from",
           "state_dict_from_flax", "load_flax_params"]


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


# the networks whose flax names are the GAN rules of ``from_flax_gan``
_GAN_NETS = ("DiscriminatorVGG128", "SFTNet", "SFTNetTorch", "ACDVGGBN96")


def _f32(t):
    return t.detach().float() if t.is_floating_point() else t.detach()


def params_tree_from(network, named) -> dict:
    """{``network``'s parameter name: tensor} (its parameters, or their
    moments) → the JAX module's ``params`` tree."""
    name = type(network).__name__
    if name in _GAN_NETS:
        return to_flax_gan(named, name)["params"]
    return to_flax(named)


def params_tree_of(network) -> dict:
    """``network``'s parameters as the JAX module's ``params`` tree
    (float32, as flax keeps parameters)."""
    return params_tree_from(network, {k: _f32(p) for k, p in
                                  network.named_parameters()})


def state_dict_from_flax(network, tree) -> dict:
    """A JAX module's ``params`` tree → ``network``'s ``state_dict``
    keys (parameters only)."""
    name = type(network).__name__
    if name in _GAN_NETS:
        return from_flax_gan({"params": tree}, name)
    return from_flax(tree)


def load_flax_params(network, sd, strict=True, label="") -> None:
    """Load parameters ``sd`` (a ``from_flax*`` dict) into ``network``;
    its buffers keep their values, as a JAX ``params`` file holds none.
    Keys of modules it does not build are dropped and logged; with
    ``strict`` every parameter must be in ``sd``."""
    own = network.state_dict()
    own.update(fit_state_dict(sd, network, strict, label,
                              [k for k, _ in network.named_parameters()]))
    network.load_state_dict(own)


def load_weights(load_path, network, strict=True) -> None:
    """Load weights into ``network``: a JAX ``.ckpt`` (a flax ``params``
    tree; buffers keep their values), a ``.npz`` of JAX parameters or a
    ``.pth`` (a ``state_dict``). Keys of modules it does not build are
    dropped (and logged); with ``strict`` a key it has that the file lacks
    raises ``KeyError``; shapes must match."""
    if load_path.endswith(".ckpt") or os.path.isdir(load_path):
        load_flax_params(network, state_dict_from_flax(
            network, ckpt.load_network(load_path)), strict, load_path)
        return
    sd = fit_state_dict(load_params(load_path), network, strict, load_path)
    network.load_state_dict(sd, strict=strict)


def _adam_chain(optimizer, named, to_tree, step, clear_state=False):
    """JAX's ``models/common.py::make_adam`` chain state (with
    ``clear_state_at`` around Adam where the model wraps it) of a
    ``torch.optim.Adam``: ``add_decayed_weights`` where it decays,
    ``scale_by_adam``, the schedule's count ``step``."""
    adam = ost.adam_state(optimizer, named, to_tree)
    if clear_state:
        adam = ost.chain(ost.count(step), adam)
    decays = bool(optimizer.param_groups[0]["weight_decay"])
    return ost.chain(*([{}] if decays else []), adam,
                     {"count": ost.count(step)})


class BaseModel:
    """The training-state checkpoints act on ``self.netG``,
    ``self.optimizer_G`` and ``self.dyn_weight`` (None without the dynamic
    loss), and on what :meth:`_extra_training_state` adds."""

    dyn_weight = None

    def __init__(self, opt, mesh=None):
        self.opt = opt
        self.mesh = mesh if mesh is not None else get_mesh()
        # "msgpack" / "orbax": JAX's files; None: the port's .pth
        self.ckpt_backend = ckpt.backend_of(
            (opt.get("path") or {}).get("checkpoint_backend"))
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
        """``network``'s weights → ``path.models/{iter}_{label}.pth``, or
        with the ``msgpack`` or ``orbax`` backend JAX's
        ``{iter}_{label}.ckpt`` (an orbax directory with ``orbax``)."""
        if self.ckpt_backend is not None:
            return ckpt.save_network(params_tree_of(network),
                                     self.opt["path"]["models"],
                                     network_label, iter_label,
                                     self.ckpt_backend)
        return _save_atomic(_host(network.state_dict()), os.path.join(
            self.opt["path"]["models"], f"{iter_label}_{network_label}.pth"))

    def load_network(self, load_path, network, strict=True):
        """:func:`load_weights`."""
        load_weights(load_path, network, strict)

    def named_train_parameters(self):
        """(name, parameter) of what ``optimizer_G`` updates, under the
        names of ``port_params.from_flax_train``: ``netG.<key>`` and, with
        the dynamic loss, ``dyn.trainable_weight``."""
        for name, p in self.netG.named_parameters():
            yield f"netG.{name}", p
        if self.dyn_weight is not None:
            yield "dyn.trainable_weight", self.dyn_weight

    def _g_chain_state(self):
        """``optimizer_G``'s optax chain state, as JAX's model keeps it."""
        return _adam_chain(self.optimizer_G,
                           list(self.named_train_parameters()),
                           to_flax_train, self.step,
                           getattr(self, "_clear_state", None) is not None)

    def _flax_training_state(self) -> dict:
        """``{"opt_state", "params"}`` of JAX's ``{iter}.state``: the
        generator's (and the dynamic loss's) parameters and its chain."""
        return {"opt_state": self._g_chain_state(),
                "params": to_flax_train({k: _f32(p) for k, p in
                                         self.named_train_parameters()})}

    def _load_g_from_flax(self, params) -> None:
        """The generator (and the dynamic loss's weights) from a JAX
        ``params`` tree holding ``netG`` (and ``dyn``)."""
        named = from_flax_train(params)
        if ("dyn.trainable_weight" in named) != (self.dyn_weight is not None):
            raise ValueError("the file's dynamic loss weights do not match "
                             "this model's train options")
        load_flax_params(self.netG, {k[len("netG."):]: v for k, v in
                                     named.items() if k.startswith("netG.")})
        if self.dyn_weight is not None:
            with torch.no_grad():
                self.dyn_weight.copy_(named["dyn.trainable_weight"])

    def _load_flax_training_state(self, tree) -> None:
        """Restore what :meth:`_flax_training_state` wrote (or JAX's
        model did)."""
        self._load_g_from_flax(tree["params"])
        ost.load_adam(self.optimizer_G, list(self.named_train_parameters()),
                      ost.find_adam(tree["opt_state"]), from_flax_train)

    def save_training_state(self, epoch, iter_step) -> str:
        """The trainer state → ``path.training_state/{iter}.state`` (JAX's
        tree with the ``msgpack`` or ``orbax`` backend)."""
        if self.ckpt_backend is not None:
            state = {"epoch": np.asarray(int(epoch), np.int64),
                     "iter": np.asarray(int(iter_step), np.int64),
                     **self._flax_training_state()}
            return ckpt.save_training_state(
                state, self.opt["path"]["training_state"], iter_step,
                self.ckpt_backend)
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
        """Restore a ``.state``, the port's or JAX's (told apart by
        content; a directory is JAX's orbax one); returns (epoch, iter).
        The updates made come from JAX's ``iter``, as its
        ``resume_training`` rebuilds its step."""
        torch_file = False
        if not os.path.isdir(resume_path):
            with open(resume_path, "rb") as f:
                torch_file = ckpt.is_torch_file(f.read(4))
        if not torch_file:
            tree = ckpt.load_training_state(resume_path)
            self._load_flax_training_state(tree)
            epoch, it = int(np.asarray(tree["epoch"])), int(np.asarray(
                tree["iter"]))
            self.step = it
            self.sync_replicas()
            return epoch, it
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
