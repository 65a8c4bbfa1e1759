"""Parameters of the port: from the JAX package's trees, from files, or a
seeded init.

:func:`from_flax` is the inverse of ``endosr/utils/port_torch.py``'s
porter (name and layout rules at ``port_torch.py:7-17``): flax paths
become reference checkpoint keys (``depth_residual3`` → ``depth-residual3``,
``head_0`` → ``head.0``, ``v``/``g`` → ``weight_v``/``weight_g``,
``A_i_j_kernel`` → ``A_i_j.weight``) and HWIO kernels become OIHW
(a transposed conv's (kh,kw,I,O) becomes (I,O,kh,kw); ``g`` becomes
(D,1,1,1)). The result loads into the port's modules, whose names are the
reference checkpoint's. :func:`from_flax_train` carries a training
model's tree (the generator and the dynamic loss's K-vector) across the
same way, and so a gradient tree too; :func:`from_flax_seg_train` that of
the co-training model, with the FCN and its BatchNorm statistics.
:func:`fit_state_dict` reads a checkpoint as the JAX porter does: keys of
modules the network does not build are dropped, and with ``strict`` every
key of the network must be present.

The ``to_flax*`` functions are the inverses (the counterpart of
``endosr/utils/port_torch.py``'s porter, with no template): a port
``state_dict`` becomes the flax tree ``net.init`` gives in JAX, with the
same paths, shapes and layouts (HWIO, a transposed conv's (kh,kw,I,O),
``g`` (D,), a Dense kernel (I,O)), and ``to_flax(from_flax(t))`` is ``t``.
Those trees are what ``utils/checkpoint.py`` writes as JAX's ``.ckpt``.
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["from_flax", "from_flax_train", "from_flax_seg_train",
           "from_flax_variables", "from_flax_gan", "flax_path_to_torch_key",
           "load_params",
           "fit_state_dict", "seeded_init", "load_monodepth",
           "load_monodepth_file", "from_flax_monodepth", "from_flax_pose",
           "from_flax_depth_trainer", "from_flax_vgg",
           "write_seeded_monodepth", "write_seeded_vgg",
           "to_flax", "to_flax_stats", "to_flax_variables", "to_flax_gan",
           "to_flax_train", "to_flax_seg_train", "to_flax_monodepth",
           "to_flax_pose", "to_flax_depth_trainer", "to_flax_vgg",
           "torch_key_to_flax_path"]

_SEQ_IDX = re.compile(r"^(.*)_(\d+)$")
# flax module names of transposed convs: their (kh, kw, I, O) kernel becomes
# torch's (I, O, kh, kw) with no flip (the JAX modules flip it when called)
_TRANSPOSE_CONV_SEGMENTS = {"layer4", "mlp_depthMatrix", "deconv1", "deconv2",
                            "deconv3", "deconv4", "deconv5"}
_LEAF_MAP = {"kernel": "weight", "v": "weight_v", "g": "weight_g",
             "bias": "bias", "scale": "weight",
             "A_i_j_kernel": "A_i_j.weight", "A_i_j_bias": "A_i_j.bias"}


def _segment_to_torch(seg: str) -> str:
    if seg.startswith("depth_residual"):
        return "depth-residual" + seg[len("depth_residual"):]
    if seg.startswith("classic_residual"):
        return "classic-residual" + seg[len("classic_residual"):]
    m = _SEQ_IDX.match(seg)
    if m and not m.group(1).startswith(("upscale", "layer")):
        return f"{m.group(1)}.{m.group(2)}"
    if m and m.group(1) in {"head", "upscale1", "upscale2", "upscale3",
                            "conv1", "conv2", "block", "mlp_mask"}:
        return f"{m.group(1)}.{m.group(2)}"
    return seg


def flax_path_to_torch_key(path: tuple[str, ...],
                           segment=_segment_to_torch) -> str:
    *mods, leaf = path
    return ".".join([segment(s) for s in mods] + [_LEAF_MAP.get(leaf, leaf)])


def _segments_to_flax(segs) -> list[str]:
    """The inverse of :func:`_segment_to_torch` over a key's module part:
    ``depth-residual3`` → ``depth_residual3``, a Sequential index joins the
    name before it (``head``, ``0`` → ``head_0``)."""
    out = []
    for seg in segs:
        if seg.isdigit() and out:
            out[-1] = f"{out[-1]}_{seg}"
        elif seg.startswith(("depth-residual", "classic-residual")):
            out.append(seg.replace("-", "_", 1))
        else:
            out.append(seg)
    return out


_LEAF_FROM_TORCH = {"weight_v": "v", "weight_g": "g", "bias": "bias"}


def torch_key_to_flax_path(key: str, ndim: int,
                           segments=_segments_to_flax) -> tuple[str, ...]:
    """The inverse of :func:`flax_path_to_torch_key` for a tensor of
    ``ndim`` dimensions: ``weight`` is a conv or Dense ``kernel`` (2-D,
    4-D) or a norm's ``scale`` (1-D); ``A_i_j.weight`` / ``.bias`` are
    SEAN's fused ``A_i_j_kernel`` / ``A_i_j_bias``."""
    *mods, leaf = key.split(".")
    if mods and mods[-1] == "A_i_j":
        mods, leaf = mods[:-1], "A_i_j_" + ("kernel" if leaf == "weight"
                                            else leaf)
    elif leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    else:
        leaf = _LEAF_FROM_TORCH.get(leaf, leaf)
    return tuple(segments(mods)) + (leaf,)


def _leaf(t):
    """A tensor → a numpy array of its type, or the tensor itself (on
    the CPU) where numpy has no such type (bfloat16), which
    ``msgpack_io`` writes as flax's ``bfloat16``."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else np.array(t.numpy())


def _unflatten(flat) -> dict:
    tree: dict = {}
    for path, v in flat:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def to_flax(sd: Mapping, segments=_segments_to_flax) -> dict:
    """The inverse of :func:`from_flax`: a port ``state_dict`` (parameters
    only; BatchNorm buffers go to :func:`to_flax_stats`) → the JAX
    module's ``params`` tree: HWIO kernels (a transposed conv's
    (kh,kw,I,O)), ``g`` as (D,), a Dense kernel as (I,O); each leaf a
    numpy array of the tensor's type (a bfloat16 tensor stays one).
    ``segments`` maps a key's module part to flax names."""
    flat = []
    for key, t in sd.items():
        if key.rsplit(".", 1)[-1] in ("running_mean", "running_var",
                                      "num_batches_tracked"):
            continue
        path = torch_key_to_flax_path(key, t.dim(), segments)
        name = path[-1]
        if name in ("v", "kernel", "A_i_j_kernel") and t.dim() == 4:
            tc = any(seg in _TRANSPOSE_CONV_SEGMENTS for seg in path)
            t = t.permute(2, 3, 0, 1) if tc else t.permute(2, 3, 1, 0)
        elif name == "kernel" and t.dim() == 2:
            t = t.t()
        elif name == "g":
            t = t.reshape(-1)
        flat.append((path, _leaf(t.contiguous())))
    return _unflatten(flat)


def to_flax_stats(sd: Mapping, segments=_segments_to_flax) -> dict:
    """The inverse of :func:`from_flax_stats`: the BatchNorm buffers of a
    ``state_dict`` → a flax ``batch_stats`` tree (``mean``, ``var``;
    ``num_batches_tracked`` has no counterpart)."""
    flat = []
    for key, t in sd.items():
        prefix, name = key.rsplit(".", 1)
        if name in ("running_mean", "running_var"):
            flat.append((tuple(segments(prefix.split(".")))
                         + (name[len("running_"):],), _leaf(t)))
    return _unflatten(flat)


def to_flax_variables(sd: Mapping, segments=_segments_to_flax) -> dict:
    """The inverse of :func:`from_flax_variables`: ``{"params": ...}``,
    with ``"batch_stats"`` where the ``state_dict`` has BatchNorm
    statistics."""
    out = {"params": to_flax(sd, segments)}
    stats = to_flax_stats(sd, segments)
    if stats:
        out["batch_stats"] = stats
    return out


def _gan_segments(segs):
    """SFT-GAN's names: ``CondNet.0`` → ``CondNet/CondNet_0``, else the
    default rule."""
    if len(segs) >= 2 and segs[0] == "CondNet" and segs[1].isdigit():
        return ["CondNet", f"CondNet_{segs[1]}"] + _segments_to_flax(segs[2:])
    return _segments_to_flax(segs)


def to_flax_gan(sd: Mapping, network: str) -> dict:
    """The inverse of :func:`from_flax_gan`: a port GAN network's
    ``state_dict`` → the JAX module's variables (``{"params": ...}``, with
    ``"batch_stats"`` where it has BatchNorms)."""
    if network == "DiscriminatorVGG128":
        return to_flax_variables(sd, list)
    if network not in ("SFTNet", "SFTNetTorch", "ACDVGGBN96"):
        raise ValueError(f"no GAN network [{network}]")
    return to_flax_variables(sd, _gan_segments)


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(params_np: Mapping, segment=_segment_to_torch,
              dtype=np.float32) -> dict[str, torch.Tensor]:
    """A JAX generator's (or FCN's) parameters (nested dicts of numpy
    arrays) → the port's ``state_dict`` (reference keys, OIHW layouts, a
    Dense kernel (I, O) as torch's (O, I), CPU tensors of ``dtype``, fp32
    unless asked). ``segment`` maps a flax module name to its part of the
    key."""
    sd = {}
    for path, leaf in _flatten(params_np):
        a = np.asarray(leaf, dtype)
        name = path[-1]
        if name in ("v", "kernel", "A_i_j_kernel") and a.ndim == 4:
            tc = any(seg in _TRANSPOSE_CONV_SEGMENTS for seg in path)
            a = a.transpose(2, 3, 0, 1) if tc else a.transpose(3, 2, 0, 1)
        elif name == "kernel" and a.ndim == 2:
            a = a.T
        elif name == "g":
            a = a.reshape(-1, 1, 1, 1)
        sd[flax_path_to_torch_key(path, segment)] = torch.from_numpy(
            np.array(a))
    return sd


def from_flax_stats(stats_np: Mapping,
                    segment=_segment_to_torch) -> dict[str, torch.Tensor]:
    """A flax ``batch_stats`` tree (``bn1/mean``, ``bn1/var``, ...) → the
    BatchNorm buffers of the port's ``state_dict`` (``bn1.running_mean``,
    ``bn1.running_var``, ``bn1.num_batches_tracked`` = 0)."""
    sd = {}
    for path, leaf in _flatten(stats_np):
        *mods, name = path
        prefix = ".".join(segment(m) for m in mods)
        sd[f"{prefix}.running_{name}"] = torch.from_numpy(
            np.array(leaf, np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd


def from_flax_variables(variables: Mapping, segment=_segment_to_torch,
                        dtype=np.float32) -> dict[str, torch.Tensor]:
    """A JAX network's variables (``{"params": ..., "batch_stats": ...}``)
    → the port's ``state_dict``: :func:`from_flax` of the parameters (as
    ``dtype``) and :func:`from_flax_stats` of the statistics."""
    return {**from_flax(variables["params"], segment, dtype),
            **from_flax_stats(variables.get("batch_stats") or {}, segment)}


def from_flax_gan(variables: Mapping, network: str,
                  dtype=np.float32) -> dict[str, torch.Tensor]:
    """The variables of a JAX GAN network → the port's ``state_dict``
    under the reference checkpoint's keys. ``network``:
    ``DiscriminatorVGG128`` (names as they are: ``conv0_0``, ``bn0_1``,
    ``linear1``), ``SFTNet`` / ``SFTNetTorch`` (``sft_branch_3/sft0/…`` →
    ``sft_branch.3.sft0.…``, ``CondNet/CondNet_0`` → ``CondNet.0``,
    ``HR_branch_0`` → ``HR_branch.0``) or ``ACDVGGBN96`` (``feature_3``,
    ``gan_0``, ``cls_2`` → ``feature.3``, …). A bare parameter tree is
    taken as ``{"params": tree}``; its tensors are ``dtype``'s."""
    if "params" not in variables:
        variables = {"params": variables}
    if network == "DiscriminatorVGG128":
        return from_flax_variables(variables, str, dtype)
    if network not in ("SFTNet", "SFTNetTorch", "ACDVGGBN96"):
        raise ValueError(f"no GAN network [{network}]")
    return {k.replace("CondNet.CondNet.", "CondNet."): v for k, v in
            from_flax_variables(variables, dtype=dtype).items()}


def fit_state_dict(sd: Mapping, network: torch.nn.Module, strict: bool = True,
                   label: str = "", required=None) -> dict:
    """``sd`` cut to the keys ``network``'s ``state_dict`` has, as the JAX
    package's porter reads a checkpoint (``endosr/utils/port_torch.py``):
    keys of modules the network does not build (a reference
    ``latest_G.pth``'s dead ``depth-residual14``) are dropped and their
    names logged; with ``strict``, every key of the network must be in
    ``sd`` (``required``: only those keys), or it raises ``KeyError``
    naming the missing ones. Shapes are checked by ``load_state_dict``."""
    import logging

    own = network.state_dict()
    dead = sorted(k for k in sd if k not in own)
    if dead:
        logging.getLogger("base").info(
            "%s: dropping %d keys of modules the network does not build: %s",
            label or type(network).__name__, len(dead), ", ".join(dead))
    if strict:
        missing = [k for k in (own if required is None else required)
                   if k not in sd]
        if missing:
            raise KeyError(f"{label or type(network).__name__}: missing "
                           f"{len(missing)} keys, e.g. {missing[:5]}")
    return {k: v for k, v in sd.items() if k in own}


def from_flax_train(tree: Mapping) -> dict[str, torch.Tensor]:
    """A JAX training model's parameter tree ``{"netG": ..., "dyn":
    {"trainable_weight": [K]}}`` (or a gradient tree of the same shape) →
    {name: tensor} under the names of ``FModelDepthCond.
    named_train_parameters``: ``netG.<key>`` by :func:`from_flax`'s
    mapping, and ``dyn.trainable_weight``."""
    out = {f"netG.{k}": v for k, v in from_flax(tree["netG"]).items()}
    if "dyn" in tree:
        out["dyn.trainable_weight"] = torch.from_numpy(np.array(
            tree["dyn"]["trainable_weight"], np.float32))
    return out


def to_flax_train(named: Mapping) -> dict:
    """The inverse of :func:`from_flax_train`: {``netG.<key>`` and
    ``dyn.trainable_weight``: tensor} → ``{"netG": ..., "dyn":
    {"trainable_weight": [K]}}`` (``dyn`` only where given)."""
    out = {"netG": to_flax({k[len("netG."):]: v for k, v in named.items()
                            if k.startswith("netG.")})}
    if "dyn.trainable_weight" in named:
        out["dyn"] = {"trainable_weight": _leaf(
            named["dyn.trainable_weight"])}
    return out


def to_flax_seg_train(named: Mapping) -> dict:
    """The inverse of :func:`from_flax_seg_train`: adds ``segNet`` (the
    FCN's parameters) and, where its statistics are given,
    ``segNet_stats``."""
    out = to_flax_train(named)
    seg = {k[len("segNet."):]: v for k, v in named.items()
           if k.startswith("segNet.")}
    out["segNet"] = to_flax(seg)
    stats = to_flax_stats(seg)
    if stats:
        out["segNet_stats"] = stats
    return out


def from_flax_seg_train(tree: Mapping) -> dict[str, torch.Tensor]:
    """A JAX ``FModelDepthSeg`` parameter tree (``netG``, ``dyn``,
    ``segNet`` and ``segNet_stats``; or a gradient tree without the
    statistics) → {name: tensor}: :func:`from_flax_train`'s names,
    ``segNet.<key>`` for the FCN's parameters and its BatchNorm
    statistics."""
    out = from_flax_train(tree)
    out.update({f"segNet.{k}": v for k, v in from_flax(tree["segNet"]).items()})
    out.update({f"segNet.{k}": v for k, v in
                from_flax_stats(tree.get("segNet_stats") or {}).items()})
    return out


def load_params(path: str) -> dict[str, torch.Tensor]:
    """A state_dict from ``path``: a ``.npz`` of JAX parameters (keys are
    flax paths joined with "/") or a port / reference ``state_dict`` file
    (``torch.save``; a ``module.`` prefix is stripped)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            tree: dict = {}
            for k in z.files:
                node = tree
                *mods, leaf = k.split("/")
                for m in mods:
                    node = node.setdefault(m, {})
                node[leaf] = z[k]
        return from_flax(tree)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def seeded_init(model, seed: int):
    """The port's own init of ``model`` from a ``torch.Generator`` seeded
    with ``seed`` (same shapes and distributions as the JAX init; other
    numbers, since the generators differ)."""
    gen = torch.Generator().manual_seed(int(seed))
    model.init_(gen)
    return model


# ------------------------------------------------------- monodepth2 and VGG

# what monodepth2's encoder.pth holds besides the trunk: the feed size, the
# stereo flag and torchvision's classifier, which the encoder does not use
_ENCODER_EXTRA = ("height", "width", "use_stereo", "encoder.fc.weight",
                  "encoder.fc.bias")


def load_monodepth(model_path: str, num_layers: int = 18, device=None):
    """monodepth2's ``encoder.pth`` and ``depth.pth`` under ``model_path``
    → (ResnetEncoder, DepthDecoder, feed height, feed width), in ``eval()``
    on ``device`` (None: the CPU), as ``endosr/depth/infer.py:35-50``
    reads them. Every key of the files but :data:`_ENCODER_EXTRA` must
    load, and every parameter must be loaded."""
    import os

    from endosr_torch.nn.monodepth import DepthDecoder, ResnetEncoder

    encoder = ResnetEncoder(num_layers)
    extra = load_monodepth_file(encoder,
                                os.path.join(model_path, "encoder.pth"))
    decoder = DepthDecoder(num_ch_enc=encoder.num_ch_enc)
    load_monodepth_file(decoder, os.path.join(model_path, "depth.pth"))
    return (encoder.to(device).eval(), decoder.to(device).eval(),
            int(extra["height"]), int(extra["width"]))


def load_monodepth_file(module, path: str) -> dict:
    """Load one of monodepth2's ``.pth`` files (``encoder.pth``,
    ``depth.pth``, ``pose_encoder.pth``, ``pose.pth``) into ``module``
    through ``load_state_dict`` (strict) and return what the file holds
    besides: the keys of :data:`_ENCODER_EXTRA` it has (an encoder's feed
    size and stereo flag, torchvision's classifier)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict({k: v for k, v in raw.items()
                            if k not in _ENCODER_EXTRA})
    return {k: raw[k] for k in _ENCODER_EXTRA if k in raw}


def _decoder_names():
    """The JAX DepthDecoder's conv names in ``decoder.N`` order."""
    names = [f"upconv_{i}_{j}" for i in range(4, -1, -1) for j in (0, 1)]
    return names + [f"dispconv_{s}" for s in range(4)]


def _monodepth_key(path: tuple[str, ...], names) -> str:
    """A JAX ResnetEncoder / DepthDecoder variable path → the port's
    ``state_dict`` key (the inverse of ``port_resnet_encoder`` /
    ``port_depth_decoder``'s key functions); ``names``: the decoder's conv
    names in ``decoder.N`` order."""
    *mods, leaf = path
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}[leaf]
    if mods[0].startswith(("upconv", "dispconv")):
        idx = names.index(mods[0])
        inner = "conv.conv" if mods[0].startswith("upconv") else "conv"
        return f"decoder.{idx}.{inner}.{leaf}"
    segs = []
    for m in mods:
        segs += m.split("_") if m.startswith(("layer", "downsample")) else [m]
    return "encoder." + ".".join(segs + [leaf])


def from_flax_monodepth(variables: Mapping) -> dict[str, torch.Tensor]:
    """A JAX ``ResnetEncoder`` or ``DepthDecoder``'s variables
    (``{"params": ..., "batch_stats": ...}`` of numpy arrays) → the port
    module's ``state_dict`` (OIHW convs; each BatchNorm's
    ``num_batches_tracked`` 0). A decoder's disparity heads are numbered
    after the upconvs in ascending scale, as a port ``DepthDecoder`` built
    with those scales in ascending order numbers them."""
    heads = sorted(k for k in variables.get("params", {})
                   if k.startswith("dispconv_"))
    names = _decoder_names()[:10] + heads
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            a = np.asarray(leaf, np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            key = _monodepth_key(path, names)
            sd[key] = torch.from_numpy(np.array(a))
            if key.endswith("running_mean"):
                sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                    torch.tensor(0)
    return sd


_POSE_DECODER_INDEX = {"squeeze": 0, "pose_0": 1, "pose_1": 2, "pose_2": 3}


def from_flax_pose(variables: Mapping) -> dict[str, torch.Tensor]:
    """A JAX ``PoseDecoder`` or ``PoseCNN``'s variables (``{"params":
    ...}`` of numpy arrays) → the port module's ``state_dict``, under
    monodepth2's ``pose.pth`` names: ``squeeze``, ``pose_0..2`` →
    ``net.0..3``; ``net_i`` → ``net.i``; ``pose_conv`` as it is (the
    inverse of ``port_pose_decoder``'s key function)."""
    sd = {}
    for (mod, leaf), a in _flatten(variables["params"]):
        a = np.asarray(a, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        if mod in _POSE_DECODER_INDEX:
            mod = f"net.{_POSE_DECODER_INDEX[mod]}"
        elif mod.startswith("net_"):
            mod = "net." + mod[len("net_"):]
        sd[f"{mod}.{_LEAF_MAP[leaf]}"] = torch.from_numpy(np.array(a))
    return sd


def to_flax_monodepth(sd: Mapping) -> dict:
    """The inverse of :func:`from_flax_monodepth`: a port
    ``ResnetEncoder`` / ``DepthDecoder`` ``state_dict`` → the JAX module's
    ``{"params": ..., "batch_stats": ...}`` (an encoder's BatchNorms; a
    decoder has none, and its ``batch_stats`` is left out)."""
    heads = sorted({int(k.split(".")[1]) for k in sd
                    if k.startswith("decoder.")})
    names = _decoder_names()[:10] + [
        f"dispconv_{s}" for s in range(len(heads) - 10)]
    coll = {"params": [], "batch_stats": []}
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        if mods[0] == "decoder":
            path = (names[int(mods[1])],)
        else:
            path, segs = (), mods[1:]
            for seg in segs:
                if seg.isdigit() and path:
                    path = path[:-1] + (f"{path[-1]}_{seg}",)
                else:
                    path += (seg,)
        name = {"running_mean": "mean", "running_var": "var",
                "bias": "bias"}.get(leaf) or (
                    "kernel" if t.dim() == 4 else "scale")
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        which = "batch_stats" if name in ("mean", "var") else "params"
        coll[which].append((path + (name,), _leaf(t.contiguous())))
    out = {"params": _unflatten(coll["params"])}
    if coll["batch_stats"]:
        out["batch_stats"] = _unflatten(coll["batch_stats"])
    return out


def to_flax_pose(sd: Mapping) -> dict:
    """The inverse of :func:`from_flax_pose`: a port ``PoseDecoder`` or
    ``PoseCNN`` ``state_dict`` → ``{"params": ...}``."""
    by_index = {f"net.{i}": n for n, i in _POSE_DECODER_INDEX.items()}
    decoder = not any(k.startswith("pose_conv.") for k in sd)   # PoseCNN's
    flat = []
    for key, t in sd.items():
        mod, leaf = key.rsplit(".", 1)
        if decoder and mod in by_index:
            mod = by_index[mod]
        elif mod.startswith("net."):
            mod = "net_" + mod[len("net."):]
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        flat.append(((mod, "kernel" if leaf == "weight" else leaf),
                     _leaf(t.contiguous())))
    return {"params": _unflatten(flat)}


def to_flax_depth_trainer(sds: Mapping) -> dict:
    """The inverse of :func:`from_flax_depth_trainer`: {name: the port
    trainer's module ``state_dict``} → a JAX depth ``Trainer.variables``."""
    return {name: (to_flax_pose(sd) if name == "pose"
                   else to_flax_monodepth(sd)) for name, sd in sds.items()}


def from_flax_depth_trainer(variables: Mapping) -> dict[str, dict]:
    """A JAX depth ``Trainer.variables`` (``endosr/depth/trainer.py``:
    ``encoder``, ``depth`` and, with pose networks, ``pose_encoder`` and
    ``pose``; numpy leaves) → {name: the port trainer's module
    ``state_dict``} under the same names, each BatchNorm's statistics
    carried across."""
    out = {}
    for name, v in variables.items():
        if name == "pose":
            out[name] = from_flax_pose(v)
        else:
            out[name] = from_flax_monodepth(v)
    return out


def from_flax_vgg(params: Mapping) -> dict[str, torch.Tensor]:
    """A JAX ``VGGFeatures``' params (``features_N/kernel``, ``/bias``) →
    the port's ``VGGFeatures`` ``state_dict`` (``features.N.weight``,
    OIHW)."""
    sd = {}
    for path, leaf in _flatten(params):
        *mods, name = path
        a = np.asarray(leaf, np.float32)
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1)
        seg = [m for m in mods if m != "vgg"][0].replace("features_",
                                                          "features.")
        sd[f"{seg}.{'weight' if name == 'kernel' else 'bias'}"] = \
            torch.from_numpy(np.array(a))
    return sd


def to_flax_vgg(sd: Mapping) -> dict:
    """The inverse of :func:`from_flax_vgg`: ``features.N.weight`` /
    ``.bias`` → ``features_N/kernel`` (HWIO) / ``bias``."""
    flat = []
    for key, t in sd.items():
        mod, idx, leaf = key.split(".")
        if leaf == "weight":
            t = t.permute(2, 3, 1, 0)
        flat.append(((f"{mod}_{idx}", "kernel" if leaf == "weight" else leaf),
                     _leaf(t.contiguous())))
    return _unflatten(flat)


def _seeded_bn_(bn, gen):
    """Seeded BatchNorm statistics and affine parameters (the released
    files' running statistics are far from 0 / 1; a test must see them)."""
    with torch.no_grad():
        for t, lo, hi in ((bn.weight, 0.8, 1.2), (bn.bias, -0.1, 0.1),
                          (bn.running_mean, -0.1, 0.1),
                          (bn.running_var, 0.5, 1.5)):
            t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)


def _seeded_(modules, gen):
    """Convs: torch's default init from ``gen``; BatchNorms:
    :func:`_seeded_bn_`."""
    from endosr_torch.nn.layers import torch_conv_init_

    for m in modules:
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            torch_conv_init_(m.weight, fan_in, gen)
            if m.bias is not None:
                torch_conv_init_(m.bias, fan_in, gen)
        elif isinstance(m, torch.nn.BatchNorm2d):
            _seeded_bn_(m, gen)


def _with_classifier(encoder, num_layers, gen) -> dict:
    """``encoder``'s ``state_dict`` with torchvision's classifier
    ``encoder.fc`` (seeded from ``gen``), as monodepth2's files hold it."""
    from endosr_torch.nn.layers import torch_conv_init_

    sd = dict(encoder.state_dict())
    cin = sd["encoder.layer4.0.conv1.weight"].shape[0] * (
        4 if num_layers > 34 else 1)
    fc_w, fc_b = torch.empty(1000, cin), torch.empty(1000)
    torch_conv_init_(fc_w, cin, gen)
    torch_conv_init_(fc_b, cin, gen)
    sd.update({"encoder.fc.weight": fc_w, "encoder.fc.bias": fc_b})
    return sd


def write_seeded_monodepth(model_path: str, seed: int = 0,
                           num_layers: int = 18, height: int = 192,
                           width: int = 640, pose: bool = False) -> str:
    """Write seeded ``encoder.pth`` and ``depth.pth`` under ``model_path``
    in monodepth2's layouts: the torchvision ResNet keys under
    ``encoder.`` with its classifier ``encoder.fc``, plus ``height``,
    ``width`` and ``use_stereo``; ``decoder.N.conv(.conv).{weight,bias}``.
    With ``pose``, also ``pose_encoder.pth`` (a two-image ResNet, with its
    classifier) and ``pose.pth`` (the pose decoder, ``net.0..3``). Convs
    take torch's default init from a generator seeded with ``seed``, the
    BatchNorms :func:`_seeded_bn_`. Returns ``model_path``."""
    import os

    from endosr_torch.nn.monodepth import (DepthDecoder, PoseDecoder,
                                           ResnetEncoder)

    gen = torch.Generator().manual_seed(int(seed))
    encoder = ResnetEncoder(num_layers)
    decoder = DepthDecoder(num_ch_enc=encoder.num_ch_enc)
    _seeded_((*encoder.modules(), *decoder.modules()), gen)
    enc = _with_classifier(encoder, num_layers, gen)
    enc.update({"height": int(height), "width": int(width),
                "use_stereo": False})
    os.makedirs(model_path, exist_ok=True)
    torch.save(enc, os.path.join(model_path, "encoder.pth"))
    torch.save(decoder.state_dict(), os.path.join(model_path, "depth.pth"))
    if pose:
        pose_enc = ResnetEncoder(num_layers, num_input_images=2)
        pose_dec = PoseDecoder(pose_enc.num_ch_enc, num_input_features=1,
                               num_frames_to_predict_for=2)
        _seeded_((*pose_enc.modules(), *pose_dec.modules()), gen)
        torch.save(_with_classifier(pose_enc, num_layers, gen),
                   os.path.join(model_path, "pose_encoder.pth"))
        torch.save(pose_dec.state_dict(), os.path.join(model_path, "pose.pth"))
    return model_path


def write_seeded_vgg(path: str, seed: int = 0, cfg: str = "vgg19") -> str:
    """Write a seeded torchvision-layout VGG state dict (``features.N.
    {weight,bias}`` of the whole trunk) to ``path``. The weights are
    He-uniform, U(±√(6/fan_in)), and the biases U(±0.01), drawn from a
    generator seeded with ``seed``: activations then keep their scale
    through the trunk, as a trained VGG's do (torch's default init shrinks
    them by ≈ 2.4× a conv). Returns ``path``."""
    import os

    from endosr_torch.nn.vgg import VGGFeatures

    gen = torch.Generator().manual_seed(int(seed))
    model = VGGFeatures(cfg)
    with torch.no_grad():
        for m in model.features.values():
            bound = math.sqrt(6.0 / m.weight[0].numel())
            m.weight.copy_(torch.rand(m.weight.shape, generator=gen)
                           * (2 * bound) - bound)
            m.bias.copy_(torch.rand(m.bias.shape, generator=gen) * 0.02
                         - 0.01)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(model.state_dict(), path)
    return path
