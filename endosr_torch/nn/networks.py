"""Network factory (counterpart of ``endosr/nn/networks.py``): the
``DepthNet`` branch only, read from the same ``opt`` dict."""

from __future__ import annotations

import os

import torch

from endosr_torch.nn.depthnet import DepthNet
from endosr_torch.utils.device import resolve_device

__all__ = ["define_G", "DEPTHNET_PRESETS"]

# ``network_G.preset``: the JAX package's named knob combinations
# (``endosr/nn/depthnet.py::DEPTHNET_PRESETS``), field for field. A field
# the port serves at one value only is checked by ``DepthNet`` itself.
_SERVE = dict(packed_tail=True, packed_up1=True, pallas_tail=False,
              pallas_head="auto", pallas_output="auto", pallas_style="auto",
              lazy_branches=True, style_chunk=5, blend_fold=False,
              remat_blocks=False)
DEPTHNET_PRESETS = {
    "serve": _SERVE,
    "serve_bf16c3": _SERVE,   # its centered convs come from ``precision``
    "train": _SERVE,
    # every fast path off: hoisted branches, dense real-resolution tail
    "plain": dict(packed_tail=False, packed_up1=False, pallas_tail=False,
                  pallas_head=False, pallas_output=False, pallas_style=False,
                  lazy_branches=False, style_chunk=1, blend_fold=False,
                  remat_blocks=False, fold_tail=False, fold_output_conv=False),
}


def _dataset_block(opt):
    ds = opt.get("datasets") or {}
    if opt.get("is_train") and "train" in ds:
        return ds["train"]
    for k in ("test_1", "test", "val"):
        if k in ds:
            return ds[k]
    return next(iter(ds.values())) if ds else {}


def define_G(opt, dtype=torch.float32, device=None) -> DepthNet:
    """The generator of ``opt["network_G"]``, read as the JAX package reads
    it. ``preset`` sets a named knob combination and ``net_kw`` (raw
    DepthNet fields, ``fused_epilogue`` among them) is applied last, over
    it. A field or value the port does not serve raises
    ``NotImplementedError`` by name; an unknown field ``TypeError``.

    ``in_stats`` follows the JAX package's ``ENDOSR_IN_STATS`` switch:
    ``pallas`` gives ``"kernel"`` (the block norms' sums from the
    ``in_stats`` kernel), anything else ``"default"``. JAX's ``variadic``
    is another reduction order of the same sums, served as ``"default"``.
    ``net_kw: {in_stats: kernel}`` is a port-only field that sets it too.

    ``device``: None means CUDA, and raises where there is none."""
    opt_net = opt["network_G"]
    which_model = opt_net["which_model_G"]
    if which_model != "DepthNet":
        raise NotImplementedError(f"Generator [{which_model}] is not ported")
    scale = opt.get("scale") or opt_net.get("scale") or opt_net.get("upscale", 4)
    ds = _dataset_block(opt)
    kwargs = dict(
        which_resblk_depth=tuple(opt_net.get("which_ResBlk_depth") or ()),
        in_nc=opt_net.get("in_nc", 3), out_nc=opt_net.get("out_nc", 3),
        nf=opt_net.get("nf", 64), nb=opt_net.get("nb", 16), scale=int(scale),
        depth_latent_ch=opt_net.get("depth_latent_ch") or 256,
        depth_range_num=ds.get("depthMaskNum") or 10,
        use_trainable_params=bool(opt_net.get("use_trainable_params", True)),
        norm_gamma=float(opt_net.get("norm_gamma") or 0.0),
        norm_beta=float(opt_net.get("norm_beta") or 0.0),
        ablate_depth_matrix=bool(opt_net.get("ablate_depth_matrix", False)),
        ablate_depth_block=bool(opt_net.get("ablate_depth_block", False)),
        remat_blocks=bool(opt_net.get("remat_blocks", False)),
        in_stats=("kernel" if os.environ.get("ENDOSR_IN_STATS") == "pallas"
                  else "default"))
    preset = opt_net.get("preset")
    if preset:
        if preset not in DEPTHNET_PRESETS:
            raise ValueError(f"Unknown DepthNet preset [{preset}]; available: "
                             f"{sorted(DEPTHNET_PRESETS)}")
        kwargs.update(DEPTHNET_PRESETS[preset])
    kwargs.update(opt_net.get("net_kw") or {})
    return DepthNet(dtype=dtype, device=resolve_device(device), **kwargs)
