"""FModelDepthSeg, DepthNet + FCN8s segmentation co-training (counterpart
of ``endosr/models/f_depthseg.py``).

The training step is the flagship model's SR losses (pixel, SSIM, the
static and the dynamic mask losses as the ``train:`` block turns them on;
the depth and VGG losses are not part of this step, as in JAX) plus the
segmentation network's BCE-with-logits on the SR output against the
one-hot labels (``SegLabel``): one backward of the sum, whose gradient
reaches ``netG`` through the FCN. Adam (``models/common.py::make_adam``)
updates ``netG`` and the dynamic loss's weights; :class:`RMSChain` (the
JAX chain ``add_decayed_weights → scale_by_rms(0.99, 1e-8) → trace
(momentum) → step_lr``, with ``train.segNet``'s ``lr``, ``momentum``,
``weight_decay`` and the reference's ``setp_size`` / ``gamma``) updates
the FCN, whose BatchNorm statistics move in train mode as flax's do
(``nn/fcn.py``; over a mesh, the global batch's). The FCN's weights are
the port's seeded init (seed 1, as the JAX model's ``PRNGKey(1)``);
:meth:`save` also writes ``{iter}_segNet.pth``, and the trainer state
holds the FCN and its optimizer.

A uint8 batch (``u8_pipeline``) goes into the networks and the losses as
it comes, 0–255, as the JAX step takes it (C14 in ``ROADMAP.md``: the
flagship step normalizes it, this one does not).
"""

from __future__ import annotations

import torch

from endosr_torch.losses.basic import bce_with_logits
from endosr_torch.losses.mask import dynamic_weight_mask_loss, mask_loss
from endosr_torch.losses.ssim import ssim_value
from endosr_torch.models.base import _host, load_flax_params
from endosr_torch.models.f_depthcond import FModelDepthCond, u8_cast
from endosr_torch.models.lr_schedule import step_lr
from endosr_torch.nn.fcn import sync_batch_norm
from endosr_torch.nn.networks import define_SegNet
from endosr_torch.utils import optim_state as ost
from endosr_torch.utils.port_params import (from_flax, from_flax_stats,
                                            seeded_init, to_flax,
                                            to_flax_stats)

__all__ = ["FModelDepthSeg", "RMSChain", "jaccard_loss", "bce_with_logits"]


def jaccard_loss(true_onehot, logits, eps: float = 1e-7):
    """1 − the soft IoU of the softmax predictions (NHWC, classes last)."""
    probs = torch.softmax(logits, dim=-1)
    intersection = (probs * true_onehot).sum(dim=(1, 2))
    union = (probs + true_onehot).sum(dim=(1, 2)) - intersection
    return 1.0 - (intersection / (union + eps)).mean()


class RMSChain(torch.optim.Optimizer):
    """The JAX segmentation optimiser: u = g + wd·p; ν ← (1−d)·u² + d·ν;
    u ← u / √(ν + ε) (ε inside the root, as optax's ``scale_by_rms``;
    torch's ``RMSprop`` adds it outside); with momentum m, t ← u + m·t and
    u ← t; p ← p − lr·u."""

    def __init__(self, params, lr, decay=0.99, eps=1e-8, momentum=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            d, m, wd = g["decay"], g["momentum"], g["weight_decay"]
            for p in g["params"]:
                if p.grad is None:
                    continue
                u = p.grad + wd * p if wd else p.grad
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    if m:
                        st["trace"] = torch.zeros_like(p)
                st["nu"].copy_((1 - d) * (u * u) + d * st["nu"])
                u = u * torch.rsqrt(st["nu"] + g["eps"])
                if m:
                    st["trace"].copy_(u + m * st["trace"])
                    u = st["trace"]
                p.sub_(g["lr"] * u)


class FModelDepthSeg(FModelDepthCond):
    def __init__(self, opt, device=None, mesh=None):
        super().__init__(opt, device=device, mesh=mesh)
        self.segNet = self.optimizer_seg = None
        if not self.is_train:
            return
        seg = opt["train"].get("segNet") or {}
        self.segNet = sync_batch_norm(
            seeded_init(define_SegNet(opt, device=self.device), 1), self.mesh)
        self.segNet.train()
        self.seg_schedule = step_lr(
            float(seg.get("lr") or 1e-4),
            int(seg.get("setp_size") or seg.get("step_size") or 10000),
            float(seg.get("gamma") or 0.1))
        self.optimizer_seg = RMSChain(
            self.segNet.parameters(), lr=self.seg_schedule(0),
            momentum=float(seg.get("momentum") or 0),
            weight_decay=float(seg.get("weight_decay") or 0))

    def named_seg_parameters(self):
        """(``segNet.<name>``, parameter) of the FCN."""
        for name, p in self.segNet.named_parameters():
            yield f"segNet.{name}", p

    def feed_data(self, data):
        super().feed_data(data)
        seg = data.get("SegLabel", data.get("Seg_onehot"))
        if seg is not None:
            self.batch["SegLabel"] = (seg if torch.is_tensor(seg)
                                      else torch.from_numpy(seg)).float()

    def optimize_parameters(self, step=None):
        """One joint step (see the module's docstring); ``self.log_dict``
        gets ``l_pix``, the turned-on SR losses, ``l_all`` (the SR losses'
        sum) and ``l_segBCE``."""
        if self.optimizer_seg is None:
            raise RuntimeError("optimize_parameters needs is_train: true")
        if "SegLabel" not in self.batch:
            raise RuntimeError("no segmentation labels: feed SegLabel")
        mask_bin = int(self._np_rng.integers(0, self.mask_num))
        b, dev = self.batch, self.device
        # uint8 batches as they come, as the JAX step takes them (C14)
        gt = u8_cast(b["GT"].to(dev))
        masks = u8_cast(b["DepthMaskList"].to(dev))
        fake_h = self.netG(u8_cast(b["LQ"].to(dev)), b["Depth"].to(dev),
                           masks)
        logs = {}
        total = logs["l_pix"] = self.l_pix_w * self.cri_pix(fake_h, gt)
        if self.use_ssim_loss:
            logs["l_ssim"] = self.l_ssim_w * ssim_value(fake_h, gt)
            total = total + logs["l_ssim"]
        if self.use_mask_loss:
            logs["l_mask"] = mask_loss(fake_h, gt, masks, mask_bin,
                                       self.mask_criterion, self.l_mask_w,
                                       self.mesh)
            total = total + logs["l_mask"]
        if self.use_dynamic_loss:
            raw, _, l_dyn, w = dynamic_weight_mask_loss(
                fake_h, gt, masks, self.dyn_weight, self.dyn_criterion,
                self.l_dyn_w, self.mesh)
            logs.update(l_dynamic=l_dyn, dyn_w=w, dyn_l=raw)
            total = total + l_dyn
        logs["l_all"] = total
        pred = self.segNet(fake_h)
        logs["l_segBCE"] = bce_with_logits(pred, b["SegLabel"].to(dev))

        self.optimizer_G.zero_grad(set_to_none=True)
        self.optimizer_seg.zero_grad(set_to_none=True)
        (total + logs["l_segBCE"]).backward()
        self._sync_grads(self.optimizer_G, self.optimizer_seg)
        if self._clear_state is not None:
            self._clear_state(self.optimizer_G, self.step)
        for opt_, lr in ((self.optimizer_G, self.schedule(self.step)),
                         (self.optimizer_seg, self.seg_schedule(self.step))):
            for group in opt_.param_groups:
                group["lr"] = lr
            opt_.step()
        self.step += 1
        return self._read_logs(logs)

    def save(self, iter_label):
        """``{iter}_G.pth`` and, training, ``{iter}_segNet.pth``."""
        path = super().save(iter_label)
        if self.segNet is not None:
            self.save_network(self.segNet, "segNet", iter_label)
        return path

    def _extra_training_state(self):
        if self.segNet is None:
            return {}
        return {"segNet": _host(self.segNet.state_dict()),
                "optimizer_seg": self.optimizer_seg.state_dict()}

    def _load_extra_training_state(self, state):
        if self.segNet is not None:
            self.segNet.load_state_dict(state["segNet"])
            self.optimizer_seg.load_state_dict(state["optimizer_seg"])

    def _flax_training_state(self):
        """JAX's tree: ``params`` adds ``segNet`` and ``segNet_stats``;
        ``opt_state`` is ``{"G": the generator's chain, "seg":
        add_decayed_weights (where it decays), scale_by_rms, trace (with
        momentum), the schedule's count}``."""
        g = super()._flax_training_state()
        group = self.optimizer_seg.param_groups[0]
        named = list(self.segNet.named_parameters())
        seg = ost.chain(*([{}] if group["weight_decay"] else []),
                        *ost.rms_state(self.optimizer_seg, named, to_flax,
                                       bool(group["momentum"])),
                        {"count": ost.count(self.step)})
        sd = {k: v.detach().float() for k, v in
              self.segNet.state_dict().items()}
        return {"opt_state": {"G": g["opt_state"], "seg": seg},
                "params": {**g["params"], "segNet": to_flax(
                    {k: sd[k] for k, _ in named}),
                    "segNet_stats": to_flax_stats(sd)}}

    def _load_flax_training_state(self, tree):
        p, o = tree["params"], tree["opt_state"]
        super()._load_flax_training_state({"params": p, "opt_state": o["G"]})
        load_flax_params(self.segNet, {**from_flax(p["segNet"]),
                                       **from_flax_stats(p["segNet_stats"])})
        seg = [o["seg"][k] for k in sorted(o["seg"], key=int)]
        rms = next(s for s in seg if "nu" in s)
        trace = next((s for s in seg if "trace" in s), None)
        ost.load_rms(self.optimizer_seg, list(self.segNet.named_parameters()),
                     rms, trace, from_flax)
