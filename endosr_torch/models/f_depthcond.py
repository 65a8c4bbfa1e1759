"""FModelDepthCond, serving subset (counterpart of
``endosr/models/f_depthcond.py``).

Builds the DepthNet generator from the same ``opt`` dict, takes batches
with :meth:`feed_data` and serves them with :meth:`test` or the 8-view
self-ensemble :meth:`test_x8`, at every scale. As in the JAX package an
unset ``eval_bucket_multiple`` means 32: inputs are zero-padded on the host
to the next multiple and the network runs its exact valid-masked forward as
one program for the whole batch, so the cropped output equals the unpadded
forward up to fp32 summation order. ``eval_bucket_multiple: 0`` (and the
``fused_epilogue`` network, which the masked forward does not support)
serves unpadded, splitting batches larger than ``serve_batch_chunk``
(default 8) into chunk-sized forwards. Weights come from
``path.pretrain_model_G`` (a ``.npz`` of JAX parameters or a ``state_dict``
file) or from the port's seeded init. Training and ``spatial_shard`` are
still to be ported.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from endosr_torch.nn.networks import define_G
from endosr_torch.ops.masks import pool_mask_np
from endosr_torch.utils.device import resolve_device
from endosr_torch.utils.port_params import load_params, seeded_init

__all__ = ["FModelDepthCond", "chunked_serving_fn"]

logger = logging.getLogger("base")

_PRECISIONS = {None: torch.float32, "fp32": torch.float32,
               "bf16": torch.bfloat16}


def chunked_serving_fn(net, chunk):
    """Forward that runs batches larger than ``chunk`` as ``chunk``-sized
    sub-forwards plus one ragged remainder (exact: every op is per-sample)."""

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


class FModelDepthCond:
    """Serving model. ``device``: where it runs; None means CUDA and raises
    when there is none."""

    def __init__(self, opt, device=None):
        self.opt = opt
        self.device = resolve_device(device)
        if opt.get("is_train"):
            raise NotImplementedError("training is not ported yet")
        precision = opt.get("precision")
        if precision not in _PRECISIONS:
            raise NotImplementedError(f"precision [{precision}] is not ported")
        if int(opt.get("spatial_shard") or 0) > 1:
            raise NotImplementedError("spatial_shard is not ported yet")
        self.netG = define_G(opt, dtype=_PRECISIONS[precision],
                             device=self.device)
        seed = int((opt.get("train") or {}).get("manual_seed") or 0)
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

    def feed_data(self, data):
        """Batch arrays (NHWC) → fp32 tensors. A numpy array stays on the
        host until :meth:`test` has padded it; a tensor stays where it is."""
        self.batch = {
            k: (data[k] if torch.is_tensor(data[k])
                else torch.from_numpy(np.ascontiguousarray(data[k]))).float()
            for k in ("LQ", "GT", "Depth", "DepthMaskList") if k in data}
        self._masks_np = None

    def _host_masks(self):
        """The fed masks as a numpy array for ``pool_mask_np``: the fed
        array itself for a batch fed as numpy; masks fed as device tensors
        are read back once per batch, which waits for the device."""
        if self._masks_np is None:
            self._masks_np = self.batch["DepthMaskList"].cpu().numpy()
        return self._masks_np

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

    def test(self):
        """SR of the fed batch → ``self.fake_SR`` [B, H·s, W·s, 3] fp32 (on
        the model's device). Bucketed, the padding and the pooling mask
        are made where the batch lies: on the host for a batch fed as numpy
        (then copied over padded); the pooling mask comes from
        :meth:`_host_masks`."""
        if "LQ" not in self.batch:
            raise RuntimeError("no batch: call feed_data before test")
        b, dev = self.batch, self.device
        lq, dep, masks = b["LQ"], b["Depth"], b["DepthMaskList"]
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
