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
ablations and the ``fused_epilogue`` network, which the masked forward does
not support, and the centered precisions ``bf16c`` / ``bf16c3``, as in
JAX) serves unpadded, splitting batches larger than ``serve_batch_chunk``
(default 8) into chunk-sized forwards. ``precision`` is read as in JAX:
``fp32`` (unset), ``bf16``, ``mixed`` (fp32 net, bf16 SEAN branches),
``bf16c`` and ``bf16c3`` (``mixed`` with 1- / 3-pass centered bf16 convs).

A training step (the JAX train step, ``f_depthcond.py:257-330``) runs the
forward with ``pallas_output`` on, every loss ``opt["train"]`` turns on,
in JAX's order (pixel L1/L2/Charbonnier; the frozen monodepth2 depth loss
and the VGG feature loss, ``losses/{depth,perceptual}.py``; SSIM added as
``+w·SSIM``; the static mask loss on a bin the host RNG draws every step;
the dynamic depth-mask loss with its trainable K-vector), the gradient
through every kernel's backward, and ``torch.optim.Adam`` (weight decay
added to the gradient first, β from the options, ε 1e-8) at the
schedule's LR of that update. The depth and VGG networks are frozen: they
are no part of ``netG``, of the optimizer or of a saved ``.pth``. With the
depth loss, every 1000th step first writes the SR and HR disparity
pyramids to ``./tmp/{sr,hr}_<i>.npy`` (:meth:`_dump_disparities`). uint8
batches (the ``u8_pipeline``) are normalized inside the step through the
256-entry table; masks are cast without scaling.

Data parallel over a ``mesh`` (``parallel/mesh.py``; ``models/base.py``),
a step is JAX's global-batch step over its mesh: every rank steps on its
own part of the batch, draws the mask loss's bin from the same host RNG
(seeded alike on every rank), computes the mask and dynamic losses from
sums over every rank (their ratios are not means of per-sample terms),
averages the gradients before the update and its logs after it.
``spatial_shard: N`` serves each image with its height split over the N
ranks of the mesh (``parallel/spatial.py``), on the bucketed path only.

Weights come from ``path.pretrain_model_G`` (a JAX ``.ckpt``, a ``.npz``
of JAX parameters or a ``state_dict`` file, :meth:`load`) or from the
port's seeded init; :meth:`save` writes them as ``{iter}_G.pth`` (JAX's
``{iter}_G.ckpt`` under ``checkpoint_backend: msgpack``), and the trainer
state (``models/base.py``) saves and resumes the optimizer with them.
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from endosr_torch.losses.basic import pixel_loss
from endosr_torch.losses.depth import DepthEstimatorLoss
from endosr_torch.losses.mask import dynamic_weight_mask_loss, mask_loss
from endosr_torch.losses.perceptual import VGGDepthLoss
from endosr_torch.losses.ssim import ssim_value
from endosr_torch.models.base import BaseModel
from endosr_torch.models.lr_schedule import clear_state_at
from endosr_torch.nn.networks import define_G
from endosr_torch.ops.masks import pool_mask_np
from endosr_torch.parallel.mesh import mean_over_ranks
from endosr_torch.parallel.spatial import sharded_masked_forward
from endosr_torch.utils.device import device_constant, resolve_device
from endosr_torch.utils.port_params import seeded_init

__all__ = ["FModelDepthCond", "chunked_serving_fn", "u8_image_norm",
           "u8_cast"]

logger = logging.getLogger("base")

# ``precision`` → (stream dtype, modulation dtype, centered-conv passes), as
# the JAX model reads it: ``mixed`` is an fp32 net with bf16 SEAN branches,
# ``bf16c`` / ``bf16c3`` add 1- / 3-pass centered bf16 convs
_PRECISIONS = {
    None: (torch.float32, None, 0), "fp32": (torch.float32, None, 0),
    "bf16": (torch.bfloat16, None, 0),
    "mixed": (torch.float32, torch.bfloat16, 0),
    "bf16c": (torch.float32, torch.bfloat16, 1),
    "bf16c3": (torch.float32, torch.bfloat16, 3),
}


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

    def __init__(self, opt, device=None, mesh=None):
        super().__init__(opt, mesh)
        self.device = resolve_device(device)
        precision = opt.get("precision")
        if precision not in _PRECISIONS:
            raise NotImplementedError(f"precision [{precision}] is not ported")
        which = opt["network_G"]["which_model_G"]
        if which != "DepthNet":
            raise NotImplementedError(
                f"{type(self).__name__} takes the DepthNet generator, not "
                f"[{which}] (the generator of another model)")
        dtype, mod_dtype, passes = _PRECISIONS[precision]
        self.netG = define_G(opt, dtype=dtype, modulation_dtype=mod_dtype,
                             centered_convs=passes, device=self.device)
        ds = opt.get("datasets") or {}
        self.mask_num = (ds.get("train") or ds.get("test") or {}).get(
            "depthMaskNum") or 10
        seed = int((opt.get("train") or {}).get("manual_seed") or 0)
        # the host RNG of the mask loss's bin, as the JAX model seeds it
        self._np_rng = np.random.default_rng(seed)
        if not self.load():
            seeded_init(self.netG, seed)
        self.netG.eval()
        chunk = opt.get("serve_batch_chunk")
        self._fwd = chunked_serving_fn(self.netG,
                                       8 if chunk is None else int(chunk))
        self._warned_bucket_fallback = False
        self._warned_spatial_fallback = False
        self.batch = {}
        self._masks_np = None
        self.dyn_weight = None
        self.optimizer_G = None
        self.depth_loss_fn = self.vgg_loss_fn = None
        if self.is_train:
            self._init_training(opt["train"])

    def _init_training(self, t):
        """Losses, the dynamic loss's K-vector and the optimizer from the
        ``train:`` block, as the JAX model reads it."""
        gate = {k: bool((t.get(f"{k}_loss") or {}).get(f"use_{k}_criterion"))
                for k in ("depth", "vgg", "ssim", "mask", "dynamic")}
        if gate["depth"]:
            self.depth_loss_fn = DepthEstimatorLoss(t["depth_loss"],
                                                    self.device, self.mesh)
        if gate["vgg"]:
            # without vgg_weights_path the port's own seeded VGG init
            self.vgg_loss_fn = VGGDepthLoss(
                t["vgg_loss"], self.device, int(t.get("manual_seed") or 0),
                self.mesh)
        self.cri_pix = pixel_loss(t["pixel_criterion"], self.mesh)
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
        loss's weights and per-bin losses as ``dyn_w_i`` / ``dyn_l_i``, the
        depth and VGG losses' scales as ``l_depth_i`` / ``l_vgg_i``.
        ``step`` is the caller's iteration: with the depth loss, a step
        that is a multiple of 1000 first dumps the disparities."""
        if self.optimizer_G is None:
            raise RuntimeError("optimize_parameters needs is_train: true")
        if "GT" not in self.batch:
            raise RuntimeError("no training batch: feed LQ, GT, Depth and "
                               "DepthMaskList first")
        # drawn every step, used or not, so the stream stays JAX's (and,
        # seeded alike, the same on every rank of a mesh)
        mask_bin = int(self._np_rng.integers(0, self.mask_num))
        if self.depth_loss_fn is not None and step is not None \
                and step % 1000 == 0:
            self._dump_disparities()
        b, dev = self.batch, self.device
        lq = u8_image_norm(b["LQ"].to(dev))
        masks = u8_cast(b["DepthMaskList"].to(dev))
        gt = u8_image_norm(b["GT"].to(dev))
        fake_h = self._train_net(lq, b["Depth"].to(dev), masks)
        logs = {}
        total = logs["l_pix"] = self.l_pix_w * self.cri_pix(fake_h, gt)
        for name, fn in (("depth", self.depth_loss_fn),
                         ("vgg", self.vgg_loss_fn)):
            if fn is not None:
                loss, parts, *_ = fn(fake_h, gt)
                logs[f"l_{name}"] = loss
                logs.update({f"l_{name}_{i}": p for i, p in enumerate(parts)})
                total = total + loss
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

        self.optimizer_G.zero_grad(set_to_none=True)
        total.backward()
        self._sync_grads(self.optimizer_G)
        if self._clear_state is not None:
            self._clear_state(self.optimizer_G, self.step)
        lr = self.schedule(self.step)
        for group in self.optimizer_G.param_groups:
            group["lr"] = lr
        self.optimizer_G.step()
        self.step += 1
        return self._read_logs(logs)

    def _read_logs(self, logs):
        """{name: loss tensor} → ``self.log_dict`` of floats (with a mesh,
        the mean over the ranks), in one read-back; the vectors ``dyn_w`` /
        ``dyn_l`` as ``dyn_w_i`` / ``dyn_l_i``."""
        flat = mean_over_ranks(torch.cat([v.detach().float().reshape(-1)
                                          for v in logs.values()]),
                               self.mesh).cpu().tolist()
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

    @torch.no_grad()
    def _dump_disparities(self):
        """The depth loss's debug dump
        (``endosr/models/f_depthcond.py:374-392``): the SR of the fed batch
        (``netG``, the serving forward) and the GT, as the JAX model passes
        them (a uint8 GT unnormalized), through the frozen depth networks;
        the four scales of each are written NHWC, as JAX's, to
        ``./tmp/sr_<i>.npy`` and ``./tmp/hr_<i>.npy``."""
        b, dev = self.batch, self.device
        sr = self.netG(u8_image_norm(b["LQ"].to(dev)), b["Depth"].to(dev),
                       u8_cast(b["DepthMaskList"].to(dev)))
        logger.info("Saving the depth map for SR and HR images......")
        os.makedirs("./tmp", exist_ok=True)
        for tag, img in (("sr", sr), ("hr", b["GT"].to(dev))):
            for i, d in enumerate(self.depth_loss_fn.get_depth_feature(img)):
                np.save(f"./tmp/{tag}_{i}.npy",
                        d.permute(0, 2, 3, 1).cpu().numpy())

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

    def get_current_visuals(self):
        """The first image of the last batch served: LQ, SR, Depth and GT
        (when fed) as tensors, and the whole SR batch as ``Batch_SR``."""
        out = {"LQ": self.batch["LQ"][0], "SR": self.fake_SR[0],
               "Batch_SR": self.fake_SR, "Depth": self.batch["Depth"][0]}
        if "GT" in self.batch:
            out["GT"] = self.batch["GT"][0]
        return out

    def _bucket(self) -> int:
        """The bucket multiple of :meth:`test`: unset means 32; 0 for the
        network configurations the masked forward does not support (the
        ablations, the fused epilogue) or that JAX serves unpadded
        (centered convs, whose mean compensation holds on the unpadded
        image)."""
        bucket = self.opt.get("eval_bucket_multiple")
        bucket = 32 if bucket is None else int(bucket)
        net = self.netG
        if bucket and (net.ablate_depth_matrix or net.ablate_depth_block
                       or net.fused_epilogue or net.centered_convs):
            bucket = 0
            if not self._warned_bucket_fallback:
                self._warned_bucket_fallback = True
                logger.warning("eval bucketing disabled for this network "
                               "config (ablation / fused epilogue / centered "
                               "bf16c): serving unpadded")
        return -(-bucket // 4) * 4       # the masked forward needs H, W % 4 == 0

    def _spatial_shards(self, bucket) -> int:
        """N of ``spatial_shard: N`` (0: off). It needs the exact bucketed
        path, so it is ignored with a warning where bucketing is off (the
        ablations, the fused epilogue, the centered precisions: their
        border corrections assume the whole image), as in JAX; otherwise
        the mesh must hold N ranks."""
        nsp = int(self.opt.get("spatial_shard") or 0)
        if nsp <= 1:
            return 0
        if not bucket:
            if not self._warned_spatial_fallback:
                self._warned_spatial_fallback = True
                logger.warning(
                    "spatial_shard ignored: it requires the exact bucketed "
                    "eval path, which is disabled for this network config "
                    "(ablation / fused epilogue / centered bf16c)")
            return 0
        have = 1 if self.mesh is None else self.mesh.size()
        if have != nsp:
            raise ValueError(
                f"spatial_shard: {nsp} needs {nsp} ranks (torchrun "
                f"--nproc_per_node {nsp}), have {have}")
        return nsp

    @torch.inference_mode()
    def test(self):
        """SR of the fed batch → ``self.fake_SR`` [B, H·s, W·s, 3] fp32 (on
        the model's device). Bucketed, the padding and the pooling mask
        are made where the batch lies: on the host for a batch fed as numpy
        (then copied over padded); the pooling mask comes from
        :meth:`_host_masks`. With ``spatial_shard: N`` (every rank of the
        mesh calls it on the same batch) the padded height is a multiple of
        lcm(bucket, 4·N), each rank computes its slab of rows and every rank
        gets the whole SR (``parallel/spatial.py``)."""
        if "LQ" not in self.batch:
            raise RuntimeError("no batch: call feed_data before test")
        b, dev = self.batch, self.device
        lq, dep, masks = (b[k].float()
                          for k in ("LQ", "Depth", "DepthMaskList"))
        h, w = lq.shape[1], lq.shape[2]
        bucket = self._bucket()
        nsp = self._spatial_shards(bucket)
        if bucket:
            hmult = int(np.lcm(bucket, 4 * nsp)) if nsp else bucket
            hb, wb = -(-h // hmult) * hmult, -(-w // bucket) * bucket
            pad = (0, 0, 0, wb - w, 0, hb - h)
            v3h, v3w = ((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2
            pm = pool_mask_np(self._host_masks(), (v3h, v3w),
                              (hb // 4, wb // 4))
            if nsp:
                sr = sharded_masked_forward(
                    self.netG, F.pad(lq, pad), F.pad(dep, pad),
                    F.pad(masks, pad), (h, w), pm, self.mesh)
            else:
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
