"""SRModel, the generic PSNR-oriented SR trainer (counterpart of
``endosr/models/sr_model.py``): :class:`SimpleModel` and the 8-view
flip/transpose self-ensemble :meth:`SRModel.test_x8`."""

from __future__ import annotations

import torch

from endosr_torch.models.common import SimpleModel
from endosr_torch.models.f_depthcond import _view

__all__ = ["SRModel"]


class SRModel(SimpleModel):
    @torch.inference_mode()
    def test_x8(self):
        """The mean of the network's outputs on the 8 views of the fed LQ,
        each mapped back, summed in the JAX model's order (its ``np.mean``
        over the stacked views adds them one after another in float32,
        then divides by 8)."""
        batch = self._on_device()
        views = [batch["LQ"]]
        for op in ("v", "h", "t"):
            views.extend([_view(t, op) for t in views])
        total = None
        for i, lq in enumerate(views):
            sr = self.netG(*self._net_inputs(dict(batch, LQ=lq.contiguous())))
            if i > 3:
                sr = _view(sr, "t")
            if i % 4 > 1:
                sr = _view(sr, "h")
            if (i % 4) % 2 == 1:
                sr = _view(sr, "v")
            total = sr if total is None else total + sr
        self.fake_H = self.fake_SR = total / len(views)
        return self.fake_SR
