"""FModelDepth, the depth-as-input trainer (counterpart of
``endosr/models/f_depth.py``): the network takes the LR image and its
depth map (``Depth_x8``, or ``Depth``); when it predicts upsampled depth
maps (``predict_depth_map``) the step adds the multi-scale depth losses —
L1 (``depth_l1_weight``) and the mean monodepth2 SSIM dissimilarity
(``depth_ssim_weight``, ``depth/layers.py``'s 3×3 SSIM) against
``Depth_x4`` where ``n_depthResBlk`` ≥ 2 and against ``Depth_x2`` where
it is 3. Logs: ``l_pix``, ``l_total`` and, with the depth outputs,
``l_depth_l1``, ``l_depth_ssim``, ``l_depth``."""

from __future__ import annotations

import torch

from endosr_torch.depth.layers import ssim_monodepth
from endosr_torch.losses.basic import l1_loss
from endosr_torch.models.common import SimpleModel, as_tensor

__all__ = ["FModelDepth"]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class FModelDepth(SimpleModel):
    def __init__(self, opt, device=None, mesh=None):
        net_opt = opt["network_G"]
        self.pred_depth = bool(net_opt.get("predict_depth_map", False))
        self.n_depth_resblk = int(net_opt.get("n_depthResBlk") or 0)
        t = opt.get("train") or {}
        self.l_depth_l1_w = float(t.get("depth_l1_weight") or 1.0)
        self.l_depth_ssim_w = float(t.get("depth_ssim_weight") or 1.0)
        super().__init__(opt, device=device, mesh=mesh)

    def _net_inputs(self, batch):
        return (batch["LQ"], batch["Depth_x8"])

    def _losses(self, out, batch):
        logs = {}
        total = 0.0
        if self.pred_depth:
            fake_h, depth_x4, depth_x2 = out
            l1 = ssim = 0.0
            pairs = []
            if self.n_depth_resblk >= 2:
                pairs.append((depth_x4, batch["Depth_x4"]))
            if self.n_depth_resblk == 3:
                pairs.append((depth_x2, batch["Depth_x2"]))
            for pred, ref in pairs:
                l1 = l1 + l1_loss(pred, ref) * self.l_depth_l1_w
                ssim = ssim + torch.mean(ssim_monodepth(
                    _nchw(pred), _nchw(ref))) * self.l_depth_ssim_w
            logs.update(l_depth_l1=l1, l_depth_ssim=ssim, l_depth=l1 + ssim)
            total = total + logs["l_depth"]
        else:
            fake_h = out
        logs["l_pix"] = self.l_pix_w * self.cri_pix(fake_h, batch["GT"])
        logs["l_total"] = total + logs["l_pix"]
        return logs["l_total"], logs

    def feed_data(self, data):
        self.batch = {"LQ": as_tensor(data["LQ"]),
                      "Depth_x8": as_tensor(data["Depth_x8"] if "Depth_x8"
                                            in data else data["Depth"])}
        for k in ("GT", "Depth_x4", "Depth_x2"):
            if k in data:
                self.batch[k] = as_tensor(data[k])

    def test(self):
        """SR (and, with ``predict_depth_map``, ``self.depth_x4`` /
        ``self.depth_x2``) of the fed batch."""
        out = self._serve(*self._net_inputs(self._on_device()))
        if self.pred_depth:
            out, self.depth_x4, self.depth_x2 = out
        self.fake_SR = self.fake_H = out
        return out
