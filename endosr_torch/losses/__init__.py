"""Training losses of the port (counterpart of ``endosr.losses``)."""

from endosr_torch.losses.depth import DepthEstimatorLoss
from endosr_torch.losses.perceptual import PerceptualLoss, VGGDepthLoss

__all__ = ["DepthEstimatorLoss", "PerceptualLoss", "VGGDepthLoss"]
