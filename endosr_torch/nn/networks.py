"""Network factory (counterpart of ``endosr/nn/networks.py``): the
``DepthNet`` branch only, read from the same ``opt`` dict."""

from __future__ import annotations

import torch

from endosr_torch.nn.depthnet import DepthNet

__all__ = ["define_G"]

# Presets whose graph is the ported fast path; each only sets style_chunk
# here (the other knobs of ``DEPTHNET_PRESETS`` are that path's defaults).
_PORTED_PRESETS = {None: {}, "serve": {"style_chunk": 5}}


def _dataset_block(opt):
    ds = opt.get("datasets") or {}
    if opt.get("is_train") and "train" in ds:
        return ds["train"]
    for k in ("test_1", "test", "val"):
        if k in ds:
            return ds[k]
    return next(iter(ds.values())) if ds else {}


def define_G(opt, dtype=torch.float32, device=None) -> DepthNet:
    opt_net = opt["network_G"]
    which_model = opt_net["which_model_G"]
    if which_model != "DepthNet":
        raise NotImplementedError(f"Generator [{which_model}] is not ported")
    preset = opt_net.get("preset")
    if preset not in _PORTED_PRESETS:
        raise NotImplementedError(f"DepthNet preset [{preset}] is not ported")
    for knob in ("ablate_depth_matrix", "ablate_depth_block", "remat_blocks"):
        if opt_net.get(knob):
            raise NotImplementedError(f"DepthNet {knob} is not ported")
    if opt_net.get("net_kw"):
        raise NotImplementedError("DepthNet net_kw overrides are not ported")
    scale = opt.get("scale") or opt_net.get("scale") or opt_net.get("upscale", 4)
    ds = _dataset_block(opt)
    return DepthNet(
        which_resblk_depth=tuple(opt_net.get("which_ResBlk_depth") or ()),
        in_nc=opt_net.get("in_nc", 3), out_nc=opt_net.get("out_nc", 3),
        nf=opt_net.get("nf", 64), nb=opt_net.get("nb", 16), scale=int(scale),
        depth_latent_ch=opt_net.get("depth_latent_ch") or 256,
        depth_range_num=ds.get("depthMaskNum") or 10,
        use_trainable_params=bool(opt_net.get("use_trainable_params", True)),
        norm_gamma=float(opt_net.get("norm_gamma") or 0.0),
        norm_beta=float(opt_net.get("norm_beta") or 0.0),
        dtype=dtype, device=device, **_PORTED_PRESETS[preset])
