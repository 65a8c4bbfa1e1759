"""SFTGANACDModel, SFT-GAN with the auxiliary-classifier discriminator
(counterpart of ``endosr/models/sftgan_model.py``).

G is :class:`~endosr_torch.nn.sft_arch.SFTNet` (×4, conditioned on the
8-channel segmentation at HR), D :class:`~endosr_torch.nn.sft_arch.ACDVGGBN96`
built for HR ``LR_size × 4`` (``LR_size`` default 24). A batch holds
``LR``, ``seg``, ``category`` (int; 0 background) and ``GT``. G's loss is
pixel + VGG feature + ``gan_weight`` × (GAN + the class cross-entropy
with background ignored); D's the GAN terms on GT and the fake plus the
class cross-entropy of both. The gate, D's batch statistics, the order
of the updates and data parallelism are ``models/srgan_model.py``'s; over
a mesh the class cross-entropy divides the global batch's sum by its
count of labelled samples.

Three Adams, as JAX's three optax chains (β2 0.999, ε 1e-8, no weight
decay): ``tx_sft`` (β1 ``beta1_G``, 5× the G schedule's LR), ``tx_other``
(1×) and D's (β1 ``beta1_D``, the ``lr_D`` schedule). Both G optimisers
take every G step's gradient of all of G's parameters into their moments
(:class:`AdamMoments`); the SFT update is applied where the SFT mask
holds, elsewhere the other update, or nothing while ``step <= 20000``. So
the frozen parameters' ``tx_other`` moments move while they are frozen,
as in JAX. The mask copies JAX's name rule: a parameter is SFT where a
segment of its name contains ``sft`` (any case) or ``Cond``, which takes
in the whole ``sft_branch``, residual convs too (C15 in ``ROADMAP.md``:
the reference's ``'SFT' in k`` would leave those convs "other").
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.losses.basic import gan_loss
from endosr_torch.models.base import params_tree_from, state_dict_from_flax
from endosr_torch.models.common import _floats, as_tensor
from endosr_torch.models.srgan_model import GANModelBase, requires_grad
from endosr_torch.nn.fcn import batch_stats_only, sync_batch_norm
from endosr_torch.nn.sft_arch import ACDVGGBN96, SFTNet
from endosr_torch.parallel.mesh import allreduce_grads, global_sum
from endosr_torch.utils import optim_state as ost

__all__ = ["SFTGANACDModel", "AdamMoments", "SFTAdams",
           "cross_entropy_ignore0", "sft_mask"]

FREEZE_STEPS = 20000    # the non-SFT parameters stay put until a step past it


def cross_entropy_ignore0(logits, labels, mesh=None):
    """Cross-entropy over the samples whose label is not 0, divided by
    max(their count, 1): a batch of background only gives 0 (torch's
    ``ignore_index`` would give NaN). A label indexes the classes as JAX's
    ``take_along_axis`` does (−1 is the last). With a ``mesh`` the sum and
    the count are the global batch's (a ratio, not a mean)."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = torch.remainder(labels.long(), logits.shape[-1])
    picked = logp.gather(-1, idx[:, None])[:, 0]
    keep = (labels != 0).float()
    return -global_sum((picked * keep).sum(), mesh) / torch.clamp(
        global_sum(keep.sum(), mesh), min=1.0)


def sft_mask(name: str) -> bool:
    """JAX's SFT split on a ``state_dict`` key (C15)."""
    return any("sft" in s.lower() or "Cond" in s for s in name.split("."))


class AdamMoments:
    """optax's ``scale_by_adam`` over a list of tensors: :meth:`update`
    takes a gradient into the moments and returns the update direction
    m̂ / (√v̂ + ε) of each tensor (the caller scales and applies it)."""

    def __init__(self, params, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, grads):
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        out = []
        for m, v, g in zip(self.m, self.v, grads):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * (g * g))
            out.append((m / c1) / (torch.sqrt(v / c2) + self.eps))
        return out

    def state_dict(self):
        return {"count": self.count, "m": [t.detach().cpu() for t in self.m],
                "v": [t.detach().cpu() for t in self.v]}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        with torch.no_grad():
            for dst, src in zip(self.m + self.v, state["m"] + state["v"]):
                dst.copy_(src)


class SFTAdams:
    """G's two Adams (``tx_sft``, ``tx_other``), saved and restored as one
    optimiser in ``{iter}.state``."""

    def __init__(self, params, b1):
        self.tx_sft = AdamMoments(params, b1)
        self.tx_other = AdamMoments(params, b1)

    def state_dict(self):
        return {"tx_sft": self.tx_sft.state_dict(),
                "tx_other": self.tx_other.state_dict()}

    def load_state_dict(self, state):
        self.tx_sft.load_state_dict(state["tx_sft"])
        self.tx_other.load_state_dict(state["tx_other"])


class SFTGANACDModel(GANModelBase):
    """``device``: where it runs; None means CUDA and raises without one."""

    lq_key = "LR"

    def __init__(self, opt, device=None, mesh=None):
        super().__init__(opt, device, mesh)
        self.netG = self._init_or_load(SFTNet().to(self.device), "G",
                                       self.seed)
        if not self.is_train:
            self.netG.eval()
            return
        t = opt["train"]
        ds = (opt.get("datasets") or {}).get("train") or {}
        hr = int(ds.get("LR_size") or 24) * 4
        self.netD = sync_batch_norm(self._init_or_load(
            ACDVGGBN96(hr_size=hr).to(self.device), "D", self.seed + 1),
            self.mesh)
        self._gan_options(t)
        self.g_names, self.g_params = zip(*self.netG.named_parameters())
        self.sft_mask = [sft_mask(k) for k in self.g_names]
        self.optimizer_G = SFTAdams(self.g_params,
                                    float(t.get("beta1_G", 0.9)))
        self.optimizer_D = torch.optim.Adam(
            self.netD.parameters(), lr=self.schedule_D(0), eps=1e-8,
            betas=(float(t.get("beta1_D", 0.9)), 0.999))

    def _g_opt_state(self):
        """JAX's ``opt_state`` entries of G: ``G_SFT`` and ``G_other``,
        each ``scale_by_adam`` then the schedule's count (G's updates)."""
        def tree(d):
            return params_tree_from(self.netG, d)

        return {key: ost.chain(ost.moments_state(tx, self.g_names, tree),
                               {"count": ost.count(self.step_G)})
                for key, tx in (("G_SFT", self.optimizer_G.tx_sft),
                                ("G_other", self.optimizer_G.tx_other))}

    def _load_g_opt_state(self, opt_state):
        for key, tx in (("G_SFT", self.optimizer_G.tx_sft),
                        ("G_other", self.optimizer_G.tx_other)):
            ost.load_moments(tx, self.g_names, ost.find_adam(opt_state[key]),
                             lambda t: state_dict_from_flax(self.netG, t))
        g = opt_state["G_SFT"]
        self.step_G = int(np.asarray(g[str(len(g) - 1)]["count"]))

    def _replicas(self):
        adams = self.optimizer_G
        moments = [] if adams is None else [
            adams.tx_sft.m, adams.tx_sft.v, adams.tx_other.m, adams.tx_other.v]
        return [self.netG, self.netD, self.optimizer_D, moments]

    def feed_data(self, data, need_GT: bool = True):
        self.batch = {"LR": as_tensor(data["LR"]), "seg": as_tensor(data["seg"]),
                      "category": torch.as_tensor(data["category"]).int()}
        if need_GT and "GT" in data:
            self.batch["GT"] = as_tensor(data["GT"])

    @torch.no_grad()
    def _g_update(self, update_other: bool):
        grads = [p.grad for p in self.g_params]
        lr = self.schedule(self.step_G)
        sft = self.optimizer_G.tx_sft.update(grads)
        other = self.optimizer_G.tx_other.update(grads)
        for p, m, s, o in zip(self.g_params, self.sft_mask, sft, other):
            if m:
                p.sub_(5.0 * lr * s)
            elif update_other:
                p.sub_(lr * o)

    def optimize_parameters(self, step):
        """One step at the trainer's iteration ``step`` (1-based); see the
        module's docstring."""
        if self.optimizer_D is None:
            raise RuntimeError("optimize_parameters needs is_train: true")
        b = self._on_device()
        cat = b["category"]
        logs = {}
        if self._do_g(step):
            requires_grad(self.netD, False)
            fake = self.netG(b["LR"], b["seg"])
            total = self._g_content(fake, b["GT"], logs)
            with batch_stats_only(self.netD):
                gan_logit, cls_logit = self.netD(fake)
            logs["l_g_gan"] = self.l_gan_w * gan_loss(self.gan_type,
                                                      gan_logit, True)
            logs["l_g_cls"] = self.l_gan_w * cross_entropy_ignore0(
                cls_logit, cat, self.mesh)
            for p in self.g_params:
                p.grad = None
            (total + logs["l_g_gan"] + logs["l_g_cls"]).backward()
            allreduce_grads(self.g_params, self.mesh)
            self._g_update(step > FREEZE_STEPS)
            self.step_G += 1
            requires_grad(self.netD, True)
        else:
            with torch.no_grad():
                fake = self.netG(b["LR"], b["seg"])
        pred_real, cls_real = self.netD(b["GT"])
        pred_fake, cls_fake = self.netD(fake.detach())
        logs.update(
            l_d_real=gan_loss(self.gan_type, pred_real, True),
            l_d_fake=gan_loss(self.gan_type, pred_fake, False),
            l_d_cls_real=cross_entropy_ignore0(cls_real, cat, self.mesh),
            l_d_cls_fake=cross_entropy_ignore0(cls_fake, cat, self.mesh))
        self._d_update(logs["l_d_real"] + logs["l_d_fake"]
                       + logs["l_d_cls_real"] + logs["l_d_cls_fake"])
        logs.update(D_real=pred_real.detach().mean(),
                    D_fake=pred_fake.detach().mean())
        self.step += 1
        self.log_dict = _floats(logs, self.device, self.mesh)
        return self.log_dict

    @torch.inference_mode()
    def test(self):
        """G's output on the fed LR and segmentation → ``self.fake_H``."""
        self.fake_H = self.fake_SR = self.netG(
            self.batch["LR"].to(self.device), self.batch["seg"].to(self.device))
        return self.fake_H
