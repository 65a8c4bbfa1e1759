"""FModel, the SFTMD-stage SR trainer (counterpart of
``endosr/models/f_model.py``): :class:`SRModel` under its own name.

With a kernel-code conditioned generator (``SFTMD_kernel``,
``SFTMD_DEMO``) the network also takes the batch's kernel code
``ker_map`` [B, code_length], as the reference ``F_model`` feeds it
(``feed_data(LR_img, GT_img, ker_map)``, positional, or a batch dict).
The JAX package's ``FModel`` feeds the LR image alone, so it cannot build
either (C13 in ``ROADMAP.md``)."""

from __future__ import annotations

from endosr_torch.models.common import as_tensor
from endosr_torch.models.sr_model import SRModel
from endosr_torch.nn.sftmd import SFTMD, SFTMDDemo

__all__ = ["FModel"]


class FModel(SRModel):
    def _net_inputs(self, batch):
        if isinstance(self.netG, (SFTMD, SFTMDDemo)):
            return (batch["LQ"], batch["ker_map"])
        return (batch["LQ"],)

    def feed_data(self, data, GT_img=None, ker_map=None):
        if isinstance(data, dict):
            return super().feed_data(data)
        self.batch = {"LQ": as_tensor(data)}
        for k, v in (("GT", GT_img), ("ker_map", ker_map)):
            if v is not None:
                self.batch[k] = as_tensor(v)
