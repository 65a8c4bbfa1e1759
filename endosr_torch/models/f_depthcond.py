"""FModelDepthCond (counterpart of ``endosr/models/f_depthcond.py``).

Builds the DepthNet generator from the same ``opt`` dict, takes batches
with :meth:`feed_data`, serves them with :meth:`test` or the 8-view
self-ensemble :meth:`test_x8`, at every scale, and with ``is_train``
trains it with :meth:`optimize_parameters`.

Serving runs under ``torch.inference_mode``. As in the JAX package an
unset ``eval_bucket_multiple`` means 32: inputs are zero-padded on the host
to the next multiple and the network runs its exact valid-masked forward as
one program for the whole batch, so the cropped output equals the unpadded
forward up to fp32 summation order. ``eval_bucket_multiple: 0`` (and the
``fused_epilogue`` network, which the masked forward does not support)
serves unpadded, splitting batches larger than ``serve_batch_chunk``
(default 8) into chunk-sized forwards.

A training step (the JAX train step, ``f_depthcond.py:257-330``) runs the
forward with ``pallas_output`` on, every loss ``opt["train"]`` turns on
(pixel L1/L2/Charbonnier, SSIM added as ``+w·SSIM``, the static mask loss
on a bin the host RNG draws every step, the dynamic depth-mask loss with
its trainable K-vector), the gradient through every kernel's backward, and
``torch.optim.Adam`` (weight decay added to the gradient first, β from the
options, ε 1e-8) at the schedule's LR of that update. uint8 batches (the
``u8_pipeline``) are normalized inside the step through the 256-entry
table; masks are cast without scaling. The depth and VGG losses (they need
monodepth2 and VGG19 weights), checkpoint save and resume, and
``spatial_shard`` are still to be ported and raise.

Weights come from ``path.pretrain_model_G`` (a ``.npz`` of JAX parameters
or a ``state_dict`` file) or from the port's seeded init.
"""

from __future__ import annotations

import copy
import logging

import numpy as np
import torch
import torch.nn.functional as F

from endosr_torch.losses.basic import pixel_loss
from endosr_torch.losses.mask import dynamic_weight_mask_loss, mask_loss
from endosr_torch.losses.ssim import ssim_value
from endosr_torch.models.base import BaseModel
from endosr_torch.models.lr_schedule import clear_state_at
from endosr_torch.nn.networks import define_G
from endosr_torch.ops.masks import pool_mask_np
from endosr_torch.utils.device import device_constant, resolve_device
from endosr_torch.utils.port_params import load_params, seeded_init

__all__ = ["FModelDepthCond", "chunked_serving_fn", "u8_image_norm",
           "u8_cast"]

logger = logging.getLogger("base")

_PRECISIONS = {None: torch.float32, "fp32": torch.float32,
               "bf16": torch.bfloat16}


def _u8_table() -> np.ndarray:
    """All 256 u8/255 values, divided on the host (correctly rounded, as
    the host decode's ``astype(f32)/255``)."""
    return np.arange(256, dtype=np.float32) / 255.0


def u8_image_norm(x):
    """uint8 image → fp32 [0, 1] through the 256-entry table (bit-equal to
    the host decode); any other dtype is returned as it is."""
    if x.dtype != torch.uint8:
        return x
    return device_constant(_u8_table, (), torch.float32, x.device)[x.long()]


def u8_cast(x):
    """0/1 uint8 masks → fp32, not scaled; any other dtype as it is."""
    return x.float() if x.dtype == torch.uint8 else x


def chunked_serving_fn(net, chunk):
    """Forward that runs batches larger than ``chunk`` as ``chunk``-sized
    sub-forwards plus one ragged remainder (exact: every op is per-sample),
    under ``torch.inference_mode``."""

    @torch.inference_mode()
    def fwd(lq, d, m):
        b = lq.shape[0]
        if chunk and b > chunk:
            return torch.cat([net(lq[i:i + chunk], d[i:i + chunk],
                                  m[i:i + chunk])
                              for i in range(0, b, chunk)], dim=0)
        return net(lq, d, m)

    return fwd


def _view(x, op):
    """One self-ensemble transform of an NHWC tensor or array: "v" flips the
    columns, "h" the rows, "t" transposes rows and columns."""
    if op == "t":
        return x.swapaxes(1, 2)
    axis = 2 if op == "v" else 1
    return x.flip(axis) if torch.is_tensor(x) else np.flip(x, axis)


class FModelDepthCond(BaseModel):
    """Serving and training model. ``device``: where it runs; None means
    CUDA and raises when there is none."""

    def __init__(self, opt, device=None):
        super().__init__(opt)
        self.device = resolve_device(device)
        precision = opt.get("precision")
        if precision not in _PRECISIONS:
            raise NotImplementedError(f"precision [{precision}] is not ported")
        if int(opt.get("spatial_shard") or 0) > 1:
            raise NotImplementedError("spatial_shard is not ported yet")
        self.netG = define_G(opt, dtype=_PRECISIONS[precision],
                             device=self.device)
        ds = opt.get("datasets") or {}
        self.mask_num = (ds.get("train") or ds.get("test") or {}).get(
            "depthMaskNum") or 10
        seed = int((opt.get("train") or {}).get("manual_seed") or 0)
        # the host RNG of the mask loss's bin, as the JAX model seeds it
        self._np_rng = np.random.default_rng(seed)
        path = (opt.get("path") or {}).get("pretrain_model_G")
        if path:
            strict = (opt.get("path") or {}).get("strict_load", True)
            self.netG.load_state_dict(load_params(path), strict=strict)
        else:
            seeded_init(self.netG, seed)
        self.netG.eval()
        chunk = opt.get("serve_batch_chunk")
        self._fwd = chunked_serving_fn(self.netG,
                                       8 if chunk is None else int(chunk))
        self._warned_bucket_fallback = False
        self.batch = {}
        self._masks_np = None
        self.dyn_weight = None
        self.optimizer_G = None
        if self.is_train:
            self._init_training(opt["train"])

    def _init_training(self, t):
        """Losses, the dynamic loss's K-vector and the optimizer from the
        ``train:`` block, as the JAX model reads it."""
        gate = {k: bool((t.get(f"{k}_loss") or {}).get(f"use_{k}_criterion"))
                for k in ("depth", "vgg", "ssim", "mask", "dynamic")}
        if gate["depth"]:
            raise NotImplementedError(
                "train.depth_loss (use_depth_criterion) is not ported: it "
                "needs the monodepth2 weights, which the repo does not hold")
        if gate["vgg"]:
            raise NotImplementedError(
                "train.vgg_loss (use_vgg_criterion) is not ported: it needs "
                "the VGG19 weights, which the repo does not hold")
        self.cri_pix = pixel_loss(t["pixel_criterion"])
        self.l_pix_w = float(t["pixel_weight"])
        self.use_ssim_loss = gate["ssim"]
        self.use_mask_loss = gate["mask"]
        self.use_dynamic_loss = gate["dynamic"]
        self.l_ssim_w = float((t.get("ssim_loss") or {}).get("ssim_weight")
                              or 1.0)
        mask = t.get("mask_loss") or {}
        self.mask_criterion = mask.get("mask_criterion", "smoothl1")
        self.l_mask_w = float(mask.get("mask_weight") or 1.0)
        dyn = t.get("dynamic_loss") or {}
        self.dyn_criterion = dyn.get("dynamic_criterion", "smoothl1")
        self.l_dyn_w = float(dyn.get("dynamic_weight") or 1.0)
        if self.use_dynamic_loss:
            self.dyn_weight = torch.nn.Parameter(
                torch.ones(self.mask_num, device=self.device))
        # the training forward forces the fused output stage, as the JAX
        # train step's module clone does; it shares every parameter
        self._train_net = copy.copy(self.netG)
        self._train_net.pallas_output = True
        self.netG.train()
        self.optimizer_G = torch.optim.Adam(
            [p for _, p in self.named_train_parameters()],
            lr=self.schedule(0), betas=(float(t.get("beta1", 0.9)),
                                        float(t.get("beta2", 0.999))),
            eps=1e-8, weight_decay=float(t.get("weight_decay_G") or 0))
        self._clear_state = None
        if (t.get("lr_scheme") == "MultiStepLR_Restart"
                and t.get("clear_state") and t.get("restarts")):
            self._clear_state = clear_state_at(t["restarts"])

    def named_train_parameters(self):
        """(name, parameter) of everything the optimizer updates:
        ``netG.<state_dict key>`` and, with the dynamic loss,
        ``dyn.trainable_weight`` (the names ``port_params.from_flax_train``
        gives a JAX parameter or gradient tree)."""
        for name, p in self.netG.named_parameters():
            yield f"netG.{name}", p
        if self.dyn_weight is not None:
            yield "dyn.trainable_weight", self.dyn_weight

    def feed_data(self, data):
        """Batch arrays (NHWC) → tensors: uint8 stays uint8 (the u8
        pipeline; a training step normalizes it, serving casts it to fp32
        unscaled as before), anything else becomes fp32. A numpy array stays
        on the host until it is used; a tensor stays where it is."""
        def cvt(x):
            t = x if torch.is_tensor(x) else torch.from_numpy(
                np.ascontiguousarray(x))
            return t if t.dtype == torch.uint8 else t.float()

        self.batch = {k: cvt(data[k])
                      for k in ("LQ", "GT", "Depth", "DepthMaskList")
                      if k in data}
        self._masks_np = None

    def _host_masks(self):
        """The fed masks as a numpy array for ``pool_mask_np``: the fed
        array itself for a batch fed as numpy; masks fed as device tensors
        are read back once per batch, which waits for the device."""
        if self._masks_np is None:
            self._masks_np = self.batch["DepthMaskList"].float().cpu().numpy()
        return self._masks_np

    def optimize_parameters(self, step=None):
        """One training step on the fed batch: forward, the losses, the
        gradient, one Adam update at ``schedule(n)`` (n: updates made so
        far). ``self.log_dict`` gets every loss as a float, the dynamic
        loss's weights and per-bin losses as ``dyn_w_i`` / ``dyn_l_i``.
        ``step`` is the caller's iteration (unused: the depth loss's debug
        dump is not ported)."""
        if self.optimizer_G is None:
            raise RuntimeError("optimize_parameters needs is_train: true")
        if "GT" not in self.batch:
            raise RuntimeError("no training batch: feed LQ, GT, Depth and "
                               "DepthMaskList first")
        # drawn every step, used or not, so the stream stays JAX's
        mask_bin = int(self._np_rng.integers(0, self.mask_num))
        b, dev = self.batch, self.device
        lq = u8_image_norm(b["LQ"].to(dev))
        masks = u8_cast(b["DepthMaskList"].to(dev))
        gt = u8_image_norm(b["GT"].to(dev))
        fake_h = self._train_net(lq, b["Depth"].to(dev), masks)
        logs = {}
        total = logs["l_pix"] = self.l_pix_w * self.cri_pix(fake_h, gt)
        if self.use_ssim_loss:
            logs["l_ssim"] = self.l_ssim_w * ssim_value(fake_h, gt)
            total = total + logs["l_ssim"]
        if self.use_mask_loss:
            logs["l_mask"] = mask_loss(fake_h, gt, masks, mask_bin,
                                       self.mask_criterion, self.l_mask_w)
            total = total + logs["l_mask"]
        if self.use_dynamic_loss:
            raw, _, l_dyn, w = dynamic_weight_mask_loss(
                fake_h, gt, masks, self.dyn_weight, self.dyn_criterion,
                self.l_dyn_w)
            logs.update(l_dynamic=l_dyn, dyn_w=w, dyn_l=raw)
            total = total + l_dyn
        logs["l_all"] = total

        self.optimizer_G.zero_grad(set_to_none=True)
        total.backward()
        if self._clear_state is not None:
            self._clear_state(self.optimizer_G, self.step)
        lr = self.schedule(self.step)
        for group in self.optimizer_G.param_groups:
            group["lr"] = lr
        self.optimizer_G.step()
        self.step += 1

        # one read-back for all the logs
        flat = torch.cat([v.detach().float().reshape(-1)
                          for v in logs.values()]).cpu().tolist()
        self.log_dict, i = {}, 0
        for k, v in logs.items():
            n = v.numel()
            if k in ("dyn_w", "dyn_l"):
                self.log_dict.update({f"{k}_{j}": flat[i + j]
                                      for j in range(n)})
            else:
                self.log_dict[k] = flat[i]
            i += n
        return self.log_dict

    def save(self, iter_label):
        raise NotImplementedError(
            "save: checkpoint saving is not ported yet (it comes with "
            "train.py)")

    def _bucket(self) -> int:
        """The bucket multiple of :meth:`test`: unset means 32; 0 for the
        network configurations the masked forward does not support."""
        bucket = self.opt.get("eval_bucket_multiple")
        bucket = 32 if bucket is None else int(bucket)
        if bucket and self.netG.fused_epilogue:
            bucket = 0
            if not self._warned_bucket_fallback:
                self._warned_bucket_fallback = True
                logger.warning("eval bucketing disabled for this network "
                               "config (fused epilogue): serving unpadded")
        return -(-bucket // 4) * 4       # the masked forward needs H, W % 4 == 0

    @torch.inference_mode()
    def test(self):
        """SR of the fed batch → ``self.fake_SR`` [B, H·s, W·s, 3] fp32 (on
        the model's device). Bucketed, the padding and the pooling mask
        are made where the batch lies: on the host for a batch fed as numpy
        (then copied over padded); the pooling mask comes from
        :meth:`_host_masks`."""
        if "LQ" not in self.batch:
            raise RuntimeError("no batch: call feed_data before test")
        b, dev = self.batch, self.device
        lq, dep, masks = (b[k].float()
                          for k in ("LQ", "Depth", "DepthMaskList"))
        h, w = lq.shape[1], lq.shape[2]
        bucket = self._bucket()
        if bucket:
            hb, wb = -(-h // bucket) * bucket, -(-w // bucket) * bucket
            pad = (0, 0, 0, wb - w, 0, hb - h)
            v3h, v3w = ((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2
            pm = pool_mask_np(self._host_masks(), (v3h, v3w),
                              (hb // 4, wb // 4))
            sr = self.netG(F.pad(lq, pad).to(dev), F.pad(dep, pad).to(dev),
                           F.pad(masks, pad).to(dev), valid_hw=(h, w),
                           pool_mask=torch.from_numpy(pm).to(dev))
        else:
            sr = self._fwd(lq.to(dev), dep.to(dev), masks.to(dev))
        s = int(self.opt["scale"])
        self.fake_SR = self.fake_H = sr[:, :h * s, :w * s, :]
        return self.fake_SR

    @torch.inference_mode()
    def test_x8(self):
        """8-way flip/transpose self-ensemble: the mean of :meth:`test` over
        the 8 views, each mapped back. Depth map and masks are transformed
        alongside the image; bucketed, so is the host copy of the masks, so
        a batch fed on the device is read back once, not once per view."""
        if "LQ" not in self.batch:
            raise RuntimeError("no batch: call feed_data before test_x8")
        b = self.batch
        if self._bucket():
            views = [(b["LQ"], b["Depth"], b["DepthMaskList"],
                      self._host_masks())]
        else:
            views = [tuple(b[k].to(self.device)
                           for k in ("LQ", "Depth", "DepthMaskList"))]
        for op in ("v", "h", "t"):
            views.extend([tuple(_view(x, op) for x in t) for t in views])
        outs = []
        saved = self.batch, self._masks_np
        try:
            for i, (l, d, m, *host) in enumerate(views):
                self.batch = {"LQ": l.contiguous(), "Depth": d.contiguous(),
                              "DepthMaskList": m.contiguous()}
                self._masks_np = host[0] if host else None
                sr = self.test()
                if i > 3:
                    sr = _view(sr, "t")
                if i % 4 > 1:
                    sr = _view(sr, "h")
                if (i % 4) % 2 == 1:
                    sr = _view(sr, "v")
                outs.append(sr)
        finally:
            self.batch, self._masks_np = saved
        self.fake_SR = self.fake_H = torch.stack(outs).mean(dim=0)
        return self.fake_SR
