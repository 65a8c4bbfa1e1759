"""SRGANModel, the adversarial SR trainer (counterpart of
``endosr/models/srgan_model.py``; SRGAN and ESRGAN).

G's loss is pixel + VGG feature (``losses/perceptual.py::PerceptualLoss``)
+ GAN (``gan`` / ``ragan`` / ``lsgan`` / ``wgan-gp``); D trains every step
on GT and the fake with the same criterion. G updates only where
``step % D_update_ratio == 0 and step > D_init_iters`` (decided on the
host); a D-only step still runs G forward for the fake.

The step copies the JAX model's order and statistics exactly:

- G's loss runs D on the fake with batch statistics, whose running
  averages are thrown away (:func:`~endosr_torch.nn.fcn.batch_stats_only`);
  ``ragan`` also runs D on GT so, without a gradient. D's parameters
  take no gradient from G's loss.
- D's loss runs D on GT, then on the fake (detached) that G made before
  its update in the same step, each updating the running statistics:
  two updates a step, from D's parameters before their update.
- ``wgan-gp`` is the signed mean with no gradient penalty, as in JAX
  (C16 in ``ROADMAP.md``; ``losses/basic.py::gradient_penalty`` exists).

Data parallel over a ``mesh`` (``models/base.py``), a step is JAX's
global-batch step: D's BatchNorm statistics are the global batch's
(``nn/fcn.py::sync_batch_norm``), ``ragan``'s means of D's outputs are
taken over every rank (they sit inside the BCE), both networks' gradients
are averaged over the ranks before their updates, and the logs are the
ranks' mean.

G's optimiser is ``models/common.py::make_adam``; D's takes ``beta1_D``,
``beta2_D`` and ``weight_decay_D`` on the schedule of ``lr_D``. Each
optimiser's LR is its schedule at the updates it has made (optax's count:
G's counts G steps only). Weights are seeded (G with
``train.manual_seed``, D with it + 1) unless ``pretrain_model_G`` /
``pretrain_model_D`` load. Checkpoints: ``{iter}_G.pth``,
``{iter}_D.pth``; ``{iter}.state`` also holds D (with its running
statistics), D's optimiser and G's update count. JAX's ``{iter}.state``
(``srgan_model.py:48-91``) holds ``params`` ``{netG, netD, netD_stats}``
and ``opt_state`` ``{"G", "D"}``, each a ``make_adam`` chain whose
schedule count is that network's updates.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from endosr_torch.losses.basic import gan_loss, pixel_loss
from endosr_torch.models.base import (BaseModel, _adam_chain, _f32, _host,
                                      params_tree_of, params_tree_from,
                                      load_flax_params, state_dict_from_flax)
from endosr_torch.models.common import _floats, as_tensor, make_adam
from endosr_torch.models.lr_schedule import build_schedule
from endosr_torch.nn.fcn import batch_stats_only, sync_batch_norm
from endosr_torch.nn.networks import define_D, define_G
from endosr_torch.parallel.mesh import global_mean
from endosr_torch.utils import optim_state as ost
from endosr_torch.utils.device import resolve_device
from endosr_torch.utils.port_params import (from_flax_gan, seeded_init,
                                            to_flax_gan)

__all__ = ["SRGANModel", "GANModelBase"]

logger = logging.getLogger("base")


def requires_grad(net, flag: bool) -> None:
    for p in net.parameters():
        p.requires_grad_(flag)


class GANModelBase(BaseModel):
    """What the two GAN models share: the device, the seeded or loaded
    networks, the G/D gate, the step's LR, the files."""

    # the fed batch's low-resolution key
    lq_key = "LQ"

    def __init__(self, opt, device=None, mesh=None):
        super().__init__(opt, mesh)
        self.device = resolve_device(device)
        self.seed = int((opt.get("train") or {}).get("manual_seed") or 0)
        self.netD = self.optimizer_G = self.optimizer_D = None
        self.step_G = 0                 # G updates made (G's schedule count)
        self.batch = {}
        self.log_dict = {}

    def _init_or_load(self, net, label, seed):
        """Load ``path.pretrain_model_{label}`` into ``net`` if it is set,
        else the port's seeded init."""
        path = (self.opt.get("path") or {}).get(f"pretrain_model_{label}")
        if path:
            logger.info("Loading model for %s [%s] ...", label, path)
            self.load_network(path, net,
                              self.opt["path"].get("strict_load", True))
        else:
            seeded_init(net, seed)
        return net

    def _gan_options(self, t):
        self.l_pix_w = float(t.get("pixel_weight") or 0)
        self.cri_pix = pixel_loss(t["pixel_criterion"], self.mesh) \
            if self.l_pix_w > 0 else None
        self.l_fea_w = float(t.get("feature_weight") or 0)
        self.cri_fea = None
        if self.l_fea_w > 0:
            from endosr_torch.losses.perceptual import PerceptualLoss

            self.cri_fea = PerceptualLoss(
                criterion=t.get("feature_criterion", "l1"), weight=1.0,
                vgg_weights_path=t.get("vgg_weights_path"),
                device=self.device, seed=self.seed, mesh=self.mesh)
        self.gan_type = t["gan_type"]
        self.l_gan_w = float(t["gan_weight"])
        self.D_update_ratio = int(t.get("D_update_ratio") or 1)
        self.D_init_iters = int(t.get("D_init_iters") or 0)
        self.schedule_D = build_schedule({**t, "lr_G": t.get("lr_D",
                                                             t["lr_G"])})

    def _do_g(self, step) -> bool:
        return step % self.D_update_ratio == 0 and step > self.D_init_iters

    def _g_content(self, fake, gt, logs):
        """The pixel and feature terms of G's loss (into ``logs``)."""
        total = 0.0
        if self.cri_pix is not None:
            logs["l_g_pix"] = self.l_pix_w * self.cri_pix(fake, gt)
            total = total + logs["l_g_pix"]
        if self.cri_fea is not None:
            logs["l_g_fea"] = self.l_fea_w * self.cri_fea(fake, gt)
            total = total + logs["l_g_fea"]
        return total

    def _d_update(self, total):
        self.optimizer_D.zero_grad(set_to_none=True)
        total.backward()
        self._sync_grads(self.optimizer_D)
        lr = self.schedule_D(self.step)
        for group in self.optimizer_D.param_groups:
            group["lr"] = lr
        self.optimizer_D.step()

    def _on_device(self):
        return {k: v.to(self.device) for k, v in self.batch.items()}

    def get_current_visuals(self):
        out = {"SR": self.fake_H[0], self.lq_key: self.batch[self.lq_key][0]}
        if "GT" in self.batch:
            out["GT"] = self.batch["GT"][0]
        return out

    def save(self, iter_label):
        """``{iter}_G.pth`` and, training, ``{iter}_D.pth``."""
        path = self.save_network(self.netG, "G", iter_label)
        if self.netD is not None:
            self.save_network(self.netD, "D", iter_label)
        return path

    def _extra_training_state(self):
        if self.netD is None:
            return {}
        return {"netD": _host(self.netD.state_dict()),
                "optimizer_D": self.optimizer_D.state_dict(),
                "step_G": int(self.step_G)}

    def _load_extra_training_state(self, state):
        if self.netD is not None:
            self.netD.load_state_dict(state["netD"])
            self.optimizer_D.load_state_dict(state["optimizer_D"])
            self.step_G = int(state["step_G"])

    # JAX's training-state tree ------------------------------------------
    def _d_from_tree(self, params, stats=None):
        """JAX's D variables → D's ``state_dict`` keys."""
        return from_flax_gan({"params": params, "batch_stats": stats or {}},
                             type(self.netD).__name__)

    def _g_opt_state(self):
        """JAX's ``opt_state`` entry of G: ``{"G": make_adam chain}`` over
        ``{"netG": params}``."""
        return {"G": _adam_chain(
            self.optimizer_G, list(self.netG.named_parameters()),
            lambda d: {"netG": params_tree_from(self.netG, d)}, self.step_G)}

    def _load_g_opt_state(self, opt_state):
        g = opt_state["G"]
        ost.load_adam(self.optimizer_G, list(self.netG.named_parameters()),
                      ost.find_adam(g), lambda t: state_dict_from_flax(
                          self.netG, t["netG"]))
        self.step_G = int(np.asarray(g[str(len(g) - 1)]["count"]))

    def _flax_training_state(self):
        var = to_flax_gan({k: _f32(v) for k, v in
                           self.netD.state_dict().items()},
                          type(self.netD).__name__)
        return {"opt_state": {**self._g_opt_state(), "D": _adam_chain(
                    self.optimizer_D, list(self.netD.named_parameters()),
                    lambda d: params_tree_from(self.netD, d), self.step)},
                "params": {"netD": var["params"],
                           "netD_stats": var.get("batch_stats", {}),
                           "netG": params_tree_of(self.netG)}}

    def _load_flax_training_state(self, tree):
        p = tree["params"]
        load_flax_params(self.netG, state_dict_from_flax(self.netG,
                                                         p["netG"]))
        load_flax_params(self.netD, self._d_from_tree(p["netD"],
                                                      p.get("netD_stats")))
        self._load_g_opt_state(tree["opt_state"])
        ost.load_adam(self.optimizer_D, list(self.netD.named_parameters()),
                      ost.find_adam(tree["opt_state"]["D"]),
                      self._d_from_tree)


class SRGANModel(GANModelBase):
    """``device``: where it runs; None means CUDA and raises without one."""

    def __init__(self, opt, device=None, mesh=None):
        super().__init__(opt, device, mesh)
        self.netG = self._init_or_load(define_G(opt, device=self.device), "G",
                                       self.seed)
        if not self.is_train:
            self.netG.eval()
            return
        t = opt["train"]
        self.netD = sync_batch_norm(self._init_or_load(
            define_D(opt, device=self.device), "D", self.seed + 1), self.mesh)
        self._gan_options(t)
        self.optimizer_G = make_adam(self.netG.parameters(), t, self.schedule)
        self.optimizer_D = make_adam(
            self.netD.parameters(),
            {**t, "beta1": t.get("beta1_D", t.get("beta1", 0.9)),
             "beta2": t.get("beta2_D", t.get("beta2", 0.999))},
            self.schedule_D, weight_decay_key="weight_decay_D")

    def feed_data(self, data, need_GT: bool = True):
        self.batch = {"LQ": as_tensor(data["LQ"])}
        if need_GT and "GT" in data:
            self.batch["GT"] = as_tensor(data["GT"])

    def _mean(self, pred):
        """The global batch's mean of D's outputs (``ragan``)."""
        return global_mean(pred.mean(), self.mesh)

    def _g_loss(self, fake, gt, logs):
        total = self._g_content(fake, gt, logs)
        with batch_stats_only(self.netD):
            pred_g_fake = self.netD(fake)
            if self.gan_type == "ragan":
                with torch.no_grad():
                    pred_d_real = self.netD(gt)
                l_g_gan = self.l_gan_w * (
                    gan_loss("gan", pred_d_real - self._mean(pred_g_fake),
                             False)
                    + gan_loss("gan", pred_g_fake - self._mean(pred_d_real),
                               True)) / 2
            else:
                l_g_gan = self.l_gan_w * gan_loss(self.gan_type, pred_g_fake,
                                                  True)
        logs["l_g_gan"] = l_g_gan
        return total + l_g_gan

    def _d_loss(self, fake, gt, logs):
        pred_d_real = self.netD(gt)
        pred_d_fake = self.netD(fake.detach())
        if self.gan_type == "ragan":
            l_d_real = gan_loss("gan", pred_d_real - self._mean(pred_d_fake),
                                True) * 0.5
            l_d_fake = gan_loss("gan", pred_d_fake - self._mean(pred_d_real),
                                False) * 0.5
        else:
            l_d_real = gan_loss(self.gan_type, pred_d_real, True)
            l_d_fake = gan_loss(self.gan_type, pred_d_fake, False)
        logs.update(l_d_real=l_d_real, l_d_fake=l_d_fake,
                    D_real=pred_d_real.detach().mean(),
                    D_fake=pred_d_fake.detach().mean())
        return l_d_real + l_d_fake

    def optimize_parameters(self, step):
        """One step at the trainer's iteration ``step`` (1-based): G's
        update where the gate lets it, then D's (the module's docstring).
        ``self.log_dict`` gets JAX's keys of the step."""
        if self.optimizer_D is None:
            raise RuntimeError("optimize_parameters needs is_train: true")
        b = self._on_device()
        logs = {}
        if self._do_g(step):
            requires_grad(self.netD, False)
            fake = self.netG(b["LQ"])
            total = self._g_loss(fake, b["GT"], logs)
            self.optimizer_G.zero_grad(set_to_none=True)
            total.backward()
            self._sync_grads(self.optimizer_G)
            lr = self.schedule(self.step_G)
            for group in self.optimizer_G.param_groups:
                group["lr"] = lr
            self.optimizer_G.step()
            self.step_G += 1
            requires_grad(self.netD, True)
        else:
            with torch.no_grad():
                fake = self.netG(b["LQ"])
        self._d_update(self._d_loss(fake, b["GT"], logs))
        self.step += 1
        self.log_dict = _floats(logs, self.device, self.mesh)
        return self.log_dict

    @torch.inference_mode()
    def test(self):
        """G's output on the fed LQ → ``self.fake_H``."""
        self.fake_H = self.fake_SR = self.netG(self.batch["LQ"].to(
            self.device))
        return self.fake_H
