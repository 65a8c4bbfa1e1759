"""Plain PyTorch training steps of the DepthNet recipe: the yardstick for
the training cells.

One step, as the ×8 Kvasir YAML's ``train:`` block states it:

- uint8 LQ and GT divided by 255 in float32; masks 0/1;
- SR = the plain forward (``reference.depthnet``), clamped to [0, 1];
- loss = ``pixel_weight`` · mean |SR − GT| + ``dynamic_weight`` · Σ_k
  softmax(w)_k · L_k, where L_k = Σ SmoothL1(SR − GT)·m_k / (Σ m_k · C),
  m_k the bin's LR mask upsampled nearest to the SR size and w the
  trainable K-vector (ones at the start);
- Adam (β from the block, ε 1e-8, no weight decay) over every network
  parameter and w, at the cosine-restart learning rate of the update
  count n: η_min + (lr·w_seg − η_min)·(1 + cos(π·(n − r_seg)/T_seg))/2.

The batch loss is a mean over images plus ratios of sums over the batch,
so the gradient is summed image by image: image b's part is its L1 mean
÷ B plus Σ_k softmax(w)_k · (its masked sum) / (the batch's mask area),
which keeps the memory to one image's autograd graph.

Imports only ``torch`` and ``numpy``.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.depthnet import forward

__all__ = ["cosine_restart_lr", "TrainReference"]


def cosine_restart_lr(t: dict, n: int) -> float:
    """The learning rate of update ``n`` (0-based) of a
    ``CosineAnnealingLR_Restart`` block."""
    periods, restarts = t["T_period"], [0] + list(t.get("restarts") or [])
    weights = [1] + list(t.get("restart_weights") or [])
    seg = max(i for i, r in enumerate(restarts) if n >= r)
    base, eta = float(t["lr_G"]) * weights[seg], float(t.get("eta_min", 0))
    return eta + (base - eta) * (1 + math.cos(math.pi * (n - restarts[seg])
                                              / periods[seg])) / 2


class TrainReference:
    """The recipe's steps from given fp32 parameters (copied; not
    changed). ``state()`` gives the parameters and the K-vector as they
    are."""

    def __init__(self, params: dict, cfg: dict, train: dict):
        if train["lr_scheme"] != "CosineAnnealingLR_Restart":
            raise NotImplementedError(train["lr_scheme"])
        if train["pixel_criterion"] != "l1":
            raise NotImplementedError(train["pixel_criterion"])
        self.cfg, self.t = cfg, train
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.dyn = torch.ones(cfg["depth_masks"],
                              device=next(iter(params.values())).device,
                              requires_grad=True)
        self.opt = torch.optim.Adam(
            [*self.params.values(), self.dyn], lr=cosine_restart_lr(train, 0),
            betas=(float(train["beta1"]), float(train["beta2"])), eps=1e-8,
            weight_decay=float(train.get("weight_decay_G") or 0),
            foreach=False)
        self.n = 0

    def step(self, batch: dict) -> float:
        """One update on ``batch`` (the u8 loader's dict, on the device);
        returns the batch's loss before the update."""
        t = self.t
        lq = batch["LQ"].float() / 255.0
        gt = batch["GT"].float() / 255.0
        dep, masks = batch["Depth"].float(), batch["DepthMaskList"].float()
        b = lq.shape[0]
        s = gt.shape[1] // masks.shape[1]
        area = masks.sum(dim=(0, 1, 2)) * (s * s) * gt.shape[-1]   # [K]
        dyn_on = bool((t.get("dynamic_loss") or {}).get(
            "use_dynamic_criterion"))
        w_pix = float(t["pixel_weight"])
        w_dyn = float((t.get("dynamic_loss") or {}).get("dynamic_weight", 1))
        self.opt.zero_grad(set_to_none=True)
        total = 0.0
        for i in range(b):
            sr = forward(self.params, self.cfg, lq[i:i + 1], dep[i:i + 1],
                         masks[i:i + 1])
            diff = sr - gt[i:i + 1]
            loss = w_pix * diff.abs().mean() / b
            if dyn_on:
                ad = diff.abs()
                elem = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(-1)
                m_up = masks[i:i + 1].repeat_interleave(s, 1) \
                    .repeat_interleave(s, 2)
                per_bin = torch.einsum("bhw,bhwk->k", elem, m_up) / area
                wk = torch.softmax(self.dyn, dim=0)
                loss = loss + w_dyn * (wk * per_bin).sum()
            loss.backward()
            total += float(loss.detach())
        for g in self.opt.param_groups:
            g["lr"] = cosine_restart_lr(t, self.n)
        self.opt.step()
        self.n += 1
        return total

    def grads(self) -> dict:
        """{name: gradient} of the last step (the K-vector under
        ``dyn.trainable_weight``)."""
        out = {f"netG.{k}": v.grad for k, v in self.params.items()}
        out["dyn.trainable_weight"] = self.dyn.grad
        return out

    def state(self) -> dict:
        out = {f"netG.{k}": v.detach() for k, v in self.params.items()}
        out["dyn.trainable_weight"] = self.dyn.detach()
        return out
