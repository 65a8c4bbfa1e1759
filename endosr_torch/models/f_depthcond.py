"""FModelDepthCond, serving subset (counterpart of
``endosr/models/f_depthcond.py``).

Builds the DepthNet generator from the same ``opt`` dict, takes batches
with :meth:`feed_data` and serves them with :meth:`test` on the unbucketed
path (``eval_bucket_multiple: 0``), splitting batches larger than
``serve_batch_chunk`` (default 8) into chunk-sized forwards. Weights come
from ``path.pretrain_model_G`` (a ``.npz`` of JAX parameters or a
``state_dict`` file) or from the port's seeded init. Training, bucketed
eval and ``test_x8`` are still to be ported.
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.nn.networks import define_G
from endosr_torch.utils.device import resolve_device
from endosr_torch.utils.port_params import load_params, seeded_init

__all__ = ["FModelDepthCond", "chunked_serving_fn"]

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
        bucket = opt.get("eval_bucket_multiple")
        if bucket is None or int(bucket) != 0:
            raise NotImplementedError(
                "bucketed eval is not ported: set eval_bucket_multiple: 0")
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
        self.batch = {}

    def feed_data(self, data):
        """Batch arrays (numpy or tensors, NHWC) → fp32 tensors on the
        model's device."""
        self.batch = {
            k: torch.as_tensor(np.asarray(data[k]) if not torch.is_tensor(data[k])
                               else data[k]).to(self.device, torch.float32)
            for k in ("LQ", "GT", "Depth", "DepthMaskList") if k in data}

    def test(self):
        """SR of the fed batch → ``self.fake_SR`` [B, H·s, W·s, 3] fp32 (on
        the model's device)."""
        b = self.batch
        self.fake_SR = self._fwd(b["LQ"], b["Depth"], b["DepthMaskList"])
        return self.fake_SR

    def test_x8(self):
        raise NotImplementedError("the 8-way self-ensemble is not ported yet")
