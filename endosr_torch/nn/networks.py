"""Network factory (counterpart of ``endosr/nn/networks.py``):
:func:`define_G` builds every generator the JAX package's does, from the
same ``opt`` dict, :func:`define_SegNet` the segmentation network of
the co-training model, and :func:`define_D` / :func:`define_F` the
discriminator and the perceptual feature network of the GAN models."""

from __future__ import annotations

import os

import torch

from endosr_torch.nn.depthnet import DepthNet
from endosr_torch.utils.device import resolve_device

__all__ = ["define_G", "define_D", "define_F", "define_SegNet",
           "DEPTHNET_PRESETS"]

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


def define_G(opt, dtype=torch.float32, modulation_dtype=None,
             centered_convs=0, device=None) -> torch.nn.Module:
    """The generator of ``opt["network_G"]``, read as the JAX package reads
    it. Any generator but DepthNet is built fp32 (the JAX package's
    ``SimpleModel`` builds them so); the rest of this concerns DepthNet.
    ``preset`` sets a named knob combination and ``net_kw`` (raw
    DepthNet fields, ``fused_epilogue`` among them) is applied last, over
    it. A field or value the port does not serve raises
    ``NotImplementedError`` by name; an unknown field ``TypeError``.

    ``in_stats`` follows the JAX package's ``ENDOSR_IN_STATS`` switch:
    ``pallas`` gives ``"kernel"`` (the block norms' sums from the
    ``in_stats`` kernel), anything else ``"default"``. JAX's ``variadic``
    is another reduction order of the same sums, served as ``"default"``.
    ``net_kw: {in_stats: kernel}`` is a port-only field that sets it too.

    ``dtype``, ``modulation_dtype`` and ``centered_convs`` are the
    precision's (``models/f_depthcond.py``). ``device``: None means CUDA,
    and raises where there is none."""
    opt_net = opt["network_G"]
    which_model = opt_net["which_model_G"]
    scale = opt.get("scale") or opt_net.get("scale") or opt_net.get("upscale", 4)
    if which_model != "DepthNet":
        return _other_generator(opt_net, which_model, int(scale)).to(
            resolve_device(device))
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
        modulation_dtype=modulation_dtype, centered_convs=int(centered_convs),
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


def _io(opt_net):
    return dict(in_nc=opt_net.get("in_nc", 3), out_nc=opt_net.get("out_nc", 3),
                nf=opt_net.get("nf", 64))


def _other_generator(opt_net, which_model, scale):
    """The generators besides DepthNet, fp32, as ``endosr/nn/networks.py``
    reads their fields (``SFTMD`` is the kernel-free variant, as in the
    reference; the kernel-conditioned one is ``SFTMD_kernel``)."""
    from endosr_torch.nn import rrdb, sftmd, sftmd_variants, srresnet

    nb16 = dict(_io(opt_net), nb=opt_net.get("nb", 16))
    code = opt_net.get("code_length", 10)
    if which_model == "SFTMD":
        return sftmd_variants.SFTMDNoKernel(scale=scale, **nb16)
    if which_model == "SFTMD_kernel":
        return sftmd.SFTMD(scale=scale, input_para=code, **nb16)
    if which_model == "SFTMD_DEMO":
        return sftmd.SFTMDDemo(scale=scale, input_para=code, **nb16)
    if which_model == "SFTMD_upsacle_after_ResBlk":
        return sftmd_variants.SFTMDUpscaleAfterResBlk(**nb16)
    if which_model == "SFTMD_upsacle_after_ResBlk_depth":
        return sftmd_variants.SFTMDUpscaleAfterResBlkDepth(
            pred_depth=bool(opt_net.get("predict_depth_map", False)),
            n_depth_resblk=opt_net.get("n_depthResBlk", 3),
            use_attention=bool(opt_net.get("use_attention", False)), **nb16)
    if which_model == "SFTMD_upsacle_after_ResBlk_depth_condition":
        return sftmd_variants.SFTMDUpscaleAfterResBlkDepthCondition(
            which_resblk_depth=tuple(opt_net.get("which_ResBlk_depth") or ()),
            **nb16)
    if which_model == "Predictor":
        return sftmd.Predictor(code_len=code)
    if which_model == "Corrector":
        return sftmd.Corrector(code_len=code)
    if which_model in ("MSRResNet", "SRResNet"):
        return srresnet.MSRResNet(upscale=scale, **nb16)
    if which_model == "RRDBNet":
        return rrdb.RRDBNet(nb=opt_net.get("nb", 23), **_io(opt_net))
    raise NotImplementedError(f"Generator model [{which_model}] not recognized")


def define_D(opt, dtype=torch.float32, device=None):
    """The GAN discriminator of ``opt["network_D"]``:
    ``discriminator_vgg_128`` (``nf``, ``in_nc``) built for the HR size
    the JAX model initialises it at, ``datasets.train.LR_size`` (default
    32) × ``scale`` (default 4); fp32, on ``device`` (None: CUDA, which
    raises without one). Another name raises by name."""
    from endosr_torch.nn.discriminator import DiscriminatorVGG128

    opt_net = opt["network_D"]
    which_model = opt_net["which_model_D"]
    if which_model != "discriminator_vgg_128":
        raise NotImplementedError(
            f"Discriminator model [{which_model}] not recognized")
    ds = (opt.get("datasets") or {}).get("train") or {}
    hr = int(ds.get("LR_size") or 32) * int(opt.get("scale") or 4)
    return DiscriminatorVGG128(in_nc=opt_net.get("in_nc", 3),
                               nf=opt_net.get("nf", 64), hr_size=hr).to(
        resolve_device(device))


def define_F(opt, use_bn: bool = False, dtype=torch.float32, device=None):
    """The GAN models' perceptual feature network: VGG19 up to layer 34
    with the ImageNet normalization (``nn/vgg.py::VGGFeatureExtractor``),
    frozen (``eval()``, no gradient), on ``device`` (None: CUDA, which
    raises without one). ``train.vgg_weights_path`` loads a torchvision
    file; without one, the port's seeded init (``train.manual_seed``,
    default 0). ``use_bn`` is the reference's and, as in JAX, unused."""
    from endosr_torch.losses.perceptual import frozen
    from endosr_torch.nn.vgg import VGGFeatureExtractor, load_vgg_state

    net = VGGFeatureExtractor(feature_layer=34, use_input_norm=True)
    t = opt.get("train") or {}
    if t.get("vgg_weights_path"):
        load_vgg_state(net.vgg, t["vgg_weights_path"])
    else:
        net.vgg.init_(torch.Generator().manual_seed(
            int(t.get("manual_seed") or 0)))
    return frozen(net, resolve_device(device))


def define_SegNet(opt, device=None):
    """FCN8s with ``network_SegNet.num_classes`` classes (default 2), fp32,
    on ``device`` (None: CUDA, which raises without one)."""
    from endosr_torch.nn.fcn import FCN8s

    opt_net = opt.get("network_SegNet") or {}
    return FCN8s(n_class=opt_net.get("num_classes", 2)).to(
        resolve_device(device))
