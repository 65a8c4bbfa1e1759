"""The frozen-monodepth2 depth-consistency loss (counterpart of
``endosr/losses/depth.py``).

SR and HR images (NHWC) are resized bilinearly (``align_corners=False``)
to the checkpoint's feed size, run through the frozen ResNet-18 encoder and
depth decoder (``eval()``: BatchNorm from its running statistics), and the
four disparity scales are compared with per-scale weighted L1 / L2 /
Charbonnier (``endosr/losses/depth.py:36-86``). The HR branch runs under
``no_grad``. The weights are monodepth2's ``encoder.pth`` / ``depth.pth``
under ``pretrained_model_path``; missing files raise
``FileNotFoundError``.
"""

from __future__ import annotations

import os

import torch

from endosr_torch.losses.basic import pixel_loss
from endosr_torch.losses.perceptual import frozen
from endosr_torch.ops.resize import interpolate_bilinear
from endosr_torch.utils.port_params import load_monodepth

__all__ = ["DepthEstimatorLoss"]


class DepthEstimatorLoss:
    """``opt``: the ``train.depth_loss`` block (``depth_criterion``,
    ``depth_weight``, ``pretrained_model_path``). Called on (SR, HR): (the
    weighted sum, the four per-scale terms, the SR and the HR disparity
    pyramids, NCHW)."""

    def __init__(self, opt, device=None, mesh=None):
        self.cri = pixel_loss(opt["depth_criterion"], mesh)
        self.weights = [float(w) for w in opt["depth_weight"]]
        model_path = opt["pretrained_model_path"]
        if not all(os.path.exists(os.path.join(model_path, f))
                   for f in ("encoder.pth", "depth.pth")):
            raise FileNotFoundError(
                "depth loss enabled but monodepth2 checkpoints not found at "
                f"{model_path} (encoder.pth/depth.pth are external downloads, "
                "see reference .MISSING_LARGE_BLOBS)")
        encoder, decoder, self.feed_height, self.feed_width = load_monodepth(
            model_path, 18)
        self.encoder = frozen(encoder, device)
        self.decoder = frozen(decoder, device)

    def get_depth_feature(self, image):
        """NHWC image → its disparities at scales 0–3 (NCHW, fp32)."""
        resized = interpolate_bilinear(image, (self.feed_height,
                                               self.feed_width))
        outputs = self.decoder(self.encoder(resized.permute(0, 3, 1, 2)))
        return [outputs[("disp", i)] for i in range(4)]

    def __call__(self, sr_img, hr_img):
        sr_disp = self.get_depth_feature(sr_img)
        with torch.no_grad():
            hr_disp = self.get_depth_feature(hr_img)
        losses = [w * self.cri(s, h)
                  for w, s, h in zip(self.weights, sr_disp, hr_disp)]
        return sum(losses), losses, sr_disp, hr_disp
