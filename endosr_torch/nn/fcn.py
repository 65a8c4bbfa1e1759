"""FCN segmentation networks on a VGG16 backbone (counterpart of
``endosr/nn/fcn.py``): FCN8s / FCN16s / FCN32s / FCNs, the segmentation
half of the depth + segmentation co-training model
(``models/f_depthseg.py``).

The backbone emits VGG16's five max-pool outputs; five ×2 transposed
convs (3×3, stride 2, padding 1, output_padding 1: H → 2H) with ReLU and
BatchNorm decode them, with the skips each variant adds, to a 1×1
classifier. NHWC in and out, fp32. Parameter names are the JAX package's
porter keys (``pretrained_net.features.0.weight``, ``deconv1.weight``,
``bn1.running_var``, ``classifier.weight``); a transposed conv's weight is
torch's (I, O, kh, kw), which the JAX package stores as (kh, kw, I, O) and
flips spatially when it is called.

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9)`` (:class:`FlaxBatchNorm`):
in training mode it normalizes with the batch statistics, the variance
E[x²] − E[x]² clamped at 0 and biased, and updates the running statistics
with that biased variance (torch's ``BatchNorm2d`` would update with the
unbiased one); in eval mode it uses the running statistics. Inside
:func:`batch_stats_only` a training-mode forward normalizes with the batch
statistics and leaves the running ones as they are, as a flax apply whose
new ``batch_stats`` are thrown away (the GAN models' generator step).
Under data parallelism (:func:`sync_batch_norm` gives the layers a mesh)
the batch statistics are the global batch's, as in JAX's one program over
the mesh: Σx, Σx² and the count are summed over the ranks (the gradient
flows through the sums), and the running statistics move by those global
moments, alike on every rank.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from endosr_torch.nn.layers import Conv, init_leaves_, torch_conv_init_
from endosr_torch.nn.vgg import VGG_CFGS
from endosr_torch.parallel.mesh import global_sum, world_size

__all__ = ["VGGBackbone", "FCN8s", "FCN16s", "FCN32s", "FCNs",
           "FlaxBatchNorm", "Deconv2x", "batch_stats_only",
           "sync_batch_norm"]

F32 = torch.float32


class FlaxBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NHWC, with flax's statistics (see the module's
    docstring); torch's ``BatchNorm2d`` parameters and buffers, so a
    reference ``state_dict`` loads as it is. ``momentum`` is torch's
    (flax's 0.9 is torch's 0.1)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.update_stats = True
        self.mesh = None

    def init_(self, gen):
        """flax's init: scale 1, bias 0, mean 0, var 1 (``gen`` unused)."""
        self.reset_parameters()

    def forward(self, x):
        if self.training:
            x32 = x.to(torch.promote_types(x.dtype, torch.float32))
            if self.mesh is None:
                mean = x32.mean(dim=(0, 1, 2))
                mean2 = (x32 * x32).mean(dim=(0, 1, 2))
            else:
                sums = global_sum(torch.stack([
                    x32.sum(dim=(0, 1, 2)), (x32 * x32).sum(dim=(0, 1, 2))]),
                    self.mesh)
                mean, mean2 = sums / (x32[..., 0].numel()
                                      * world_size(self.mesh))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if self.update_stats:
                self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias

    @torch.no_grad()
    def _update(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean.detach())
        self.running_var.mul_(1 - m).add_(m * var.detach())
        self.num_batches_tracked.add_(1)


def sync_batch_norm(module: nn.Module, mesh) -> nn.Module:
    """Give every :class:`FlaxBatchNorm` of ``module`` the ``mesh`` (None:
    the local batch's statistics); returns ``module``."""
    for m in module.modules():
        if isinstance(m, FlaxBatchNorm):
            m.mesh = mesh
    return module


@contextlib.contextmanager
def batch_stats_only(module: nn.Module):
    """Inside: every :class:`FlaxBatchNorm` of ``module`` leaves its running
    statistics as they are (in training mode it still normalizes with the
    batch statistics)."""
    bns = [m for m in module.modules() if isinstance(m, FlaxBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class Deconv2x(nn.Module):
    """ConvTranspose2d(3, stride 2, padding 1, output_padding 1), NHWC."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_ch))

    def init_(self, gen):
        # torch's fan-in convention for a transposed conv: out·kh·kw
        fan_in = self.weight[0].numel()
        torch_conv_init_(self.weight, fan_in, gen)
        torch_conv_init_(self.bias, fan_in, gen)

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                               stride=2, padding=1, output_padding=1)
        return y.permute(0, 2, 3, 1)


class VGGBackbone(nn.Module):
    """VGG16's convs (``features.N``, ReLU after each) returning the five
    max-pool outputs."""

    def __init__(self, cfg="vgg16", in_nc=3):
        super().__init__()
        self.cfg = VGG_CFGS[cfg]
        convs, idx, cin = {}, 0, in_nc
        for v in self.cfg:
            if v == "M":
                idx += 1
            else:
                convs[str(idx)] = Conv(cin, v, 3, 1, 1)
                cin, idx = v, idx + 2
        self.features = nn.ModuleDict(convs)

    def forward(self, x):
        outputs, idx = [], 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
                outputs.append(x)
                idx += 1
            else:
                x = torch.relu(self.features[str(idx)](x, F32))
                idx += 2
        return outputs


_DECODER = (("deconv1", 512, 512), ("deconv2", 512, 256),
            ("deconv3", 256, 128), ("deconv4", 128, 64), ("deconv5", 64, 32))


class _FCNBase(nn.Module):
    def __init__(self, n_class=2):
        super().__init__()
        self.pretrained_net = VGGBackbone()
        for i, (name, cin, cout) in enumerate(_DECODER, start=1):
            setattr(self, name, Deconv2x(cin, cout))
            setattr(self, f"bn{i}", FlaxBatchNorm(cout))
        self.classifier = Conv(32, n_class, 1, 1, 0)

    def init_(self, gen):
        return init_leaves_(self, gen)

    def _up(self, i, score):
        """ReLU of decoder stage ``i`` (1-based)."""
        return torch.relu(getattr(self, f"deconv{i}")(score))

    def _bn(self, i, score):
        return getattr(self, f"bn{i}")(score)

    def _classify(self, score):
        return self.classifier(score, F32)


class FCN8s(_FCNBase):
    def forward(self, x):
        x1, x2, x3, x4, x5 = self.pretrained_net(x)
        score = self._bn(1, self._up(1, x5) + x4)
        score = self._bn(2, self._up(2, score) + x3)
        for i in (3, 4, 5):
            score = self._bn(i, self._up(i, score))
        return self._classify(score)


class FCN16s(_FCNBase):
    def forward(self, x):
        x1, x2, x3, x4, x5 = self.pretrained_net(x)
        score = self._bn(1, self._up(1, x5) + x4)
        for i in (2, 3, 4, 5):
            score = self._bn(i, self._up(i, score))
        return self._classify(score)


class FCN32s(_FCNBase):
    def forward(self, x):
        score = self.pretrained_net(x)[-1]
        for i in (1, 2, 3, 4, 5):
            score = self._bn(i, self._up(i, score))
        return self._classify(score)


class FCNs(_FCNBase):
    def forward(self, x):
        x1, x2, x3, x4, x5 = self.pretrained_net(x)
        score = x5
        for i, skip in zip((1, 2, 3, 4, 5), (x4, x3, x2, x1, None)):
            score = self._bn(i, self._up(i, score))
            if skip is not None:
                score = score + skip
        return self._classify(score)
