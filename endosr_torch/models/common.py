"""The one-network trainers' shared machinery (counterpart of
``endosr/models/common.py``).

:class:`SimpleModel` is the common shape of ``SRModel``, ``FModel``,
``PModel``, ``CModel`` and ``FModelDepth``: one generator built by
``define_G`` (fp32), one pixel criterion, :func:`make_adam` at the
schedule's LR of each update. A subclass says how the fed batch becomes
the network's inputs (:meth:`SimpleModel._net_inputs`) and its target
(:meth:`SimpleModel._target`). Weights come from ``path.pretrain_model_G``
(``models/base.py``'s loader) or from the port's seeded init
(``train.manual_seed``, default 0); checkpoints and the trainer state are
``models/base.py``'s. Data parallel over a ``mesh`` (``models/base.py``):
the gradients are averaged over the ranks before each update, a ``cb``
pixel loss is the global batch's sum, the logs are the ranks' mean.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from endosr_torch.losses.basic import pixel_loss
from endosr_torch.models.base import BaseModel
from endosr_torch.nn.networks import define_G
from endosr_torch.parallel.mesh import mean_over_ranks
from endosr_torch.utils.device import resolve_device
from endosr_torch.utils.port_params import seeded_init

__all__ = ["SimpleModel", "make_adam", "as_tensor"]

logger = logging.getLogger("base")


def make_adam(params, train_opt, schedule, weight_decay_key="weight_decay_G"):
    """torch ``Adam`` as the JAX chain ``add_decayed_weights → scale_by_adam
    → scale_by_learning_rate`` computes it: the decayed weights are added
    to the gradient before the moments (``Adam(weight_decay=…)``, not
    AdamW), β1 / β2 from the options (0.9 / 0.999), ε 1e-8, the LR
    ``schedule(0)`` until the caller sets each update's."""
    return torch.optim.Adam(
        params, lr=schedule(0), eps=1e-8,
        betas=(float(train_opt.get("beta1", 0.9)),
               float(train_opt.get("beta2", 0.999))),
        weight_decay=float(train_opt.get(weight_decay_key) or 0))


def as_tensor(x):
    """A batch array (numpy or tensor) → a float32 tensor, where it lies."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return t.float()


class SimpleModel(BaseModel):
    """One-network pixel-criterion trainer with the reference model API.
    ``device``: where it runs; None means CUDA and raises without one."""

    def __init__(self, opt, device=None, mesh=None):
        super().__init__(opt, mesh)
        self.device = resolve_device(device)
        self.netG = self._build_network(opt)
        seed = int((opt.get("train") or {}).get("manual_seed") or 0)
        if not self.load():
            seeded_init(self.netG, seed)
        self.batch = {}
        self.optimizer_G = None
        if self.is_train:
            t = opt["train"]
            self.cri_pix = pixel_loss(t["pixel_criterion"], self.mesh)
            self.l_pix_w = float(t["pixel_weight"])
            self.optimizer_G = make_adam(self.netG.parameters(), t,
                                         self.schedule)
            self.netG.train()
        else:
            self.netG.eval()

    # subclass hooks ----------------------------------------------------
    def _build_network(self, opt):
        return define_G(opt, device=self.device)

    def _net_inputs(self, batch):
        """The fed batch → the network's inputs (on the model's device)."""
        return (batch["LQ"],)

    def _target(self, batch):
        return batch["GT"]

    def _losses(self, out, batch):
        """(total loss, {name: loss}) of the network's output."""
        l_pix = self.l_pix_w * self.cri_pix(out, self._target(batch))
        return l_pix, {"l_pix": l_pix}

    # reference API -----------------------------------------------------
    def feed_data(self, data):
        """The batch's arrays as float32 tensors (where they lie; moved to
        the device when used); strings and lists are left out."""
        self.batch = {k: as_tensor(v) for k, v in data.items()
                      if isinstance(v, np.ndarray) or torch.is_tensor(v)}

    def _on_device(self):
        return {k: v.to(self.device) for k, v in self.batch.items()}

    def _update(self, total, optimizer):
        """Backward of ``total`` and one update of ``optimizer`` at the
        schedule's LR of update ``self.step``."""
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        self._sync_grads(optimizer)
        lr = self.schedule(self.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()

    def optimize_parameters(self, step=None):
        """One training step on the fed batch: forward, the losses, the
        gradient, one Adam update. ``self.log_dict`` gets the losses as
        floats."""
        if self.optimizer_G is None:
            raise RuntimeError("optimize_parameters needs is_train: true")
        batch = self._on_device()
        total, logs = self._losses(self.netG(*self._net_inputs(batch)), batch)
        self._update(total, self.optimizer_G)
        self.step += 1
        self.log_dict = _floats(logs, self.device, self.mesh)
        return self.log_dict

    @torch.inference_mode()
    def _serve(self, *inputs):
        return self.netG(*inputs)

    def test(self):
        """The network's output on the fed batch → ``self.fake_SR``."""
        self.fake_SR = self.fake_H = self._serve(
            *self._net_inputs(self._on_device()))
        return self.fake_SR

    def get_current_visuals(self):
        out = {"SR": self.fake_SR[0], "Batch_SR": self.fake_SR}
        for k in ("LQ", "GT"):
            if k in self.batch:
                out[k] = self.batch[k][0]
        return out

    def load(self) -> bool:
        """Load ``path.pretrain_model_G`` (with ``path.strict_load``) if it
        is set; returns whether it was."""
        path = self.opt.get("path") or {}
        if not path.get("pretrain_model_G"):
            return False
        logger.info("Loading model for G [%s] ...", path["pretrain_model_G"])
        self.load_network(path["pretrain_model_G"], self.netG,
                          path.get("strict_load", True))
        return True

    def save(self, iter_label):
        """The generator's weights → ``path.models/{iter_label}_G.pth``
        (``.ckpt``: :meth:`BaseModel.save_network`)."""
        return self.save_network(self.netG, "G", iter_label)


def _floats(logs, device, mesh=None):
    """{name: loss tensor or float} → {name: float}, one read-back; with a
    ``mesh``, each the mean over the ranks."""
    vals = [v.detach().float().reshape(()).to(device) if torch.is_tensor(v)
            else torch.tensor(float(v), device=device) for v in logs.values()]
    if not vals:
        return {}
    return dict(zip(logs, mean_over_ranks(torch.stack(vals), mesh)
                    .cpu().tolist()))
