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
same way, and so a gradient tree too.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["from_flax", "from_flax_train", "flax_path_to_torch_key",
           "load_params", "seeded_init"]

_SEQ_IDX = re.compile(r"^(.*)_(\d+)$")
_TRANSPOSE_CONV_SEGMENTS = {"layer4", "mlp_depthMatrix"}
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


def flax_path_to_torch_key(path: tuple[str, ...]) -> str:
    *mods, leaf = path
    return ".".join([_segment_to_torch(s) for s in mods]
                    + [_LEAF_MAP.get(leaf, leaf)])


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(params_np: Mapping) -> dict[str, torch.Tensor]:
    """JAX DepthNet parameters (nested dicts of numpy arrays) → the port's
    ``state_dict`` (reference keys, OIHW layouts, CPU fp32 tensors)."""
    sd = {}
    for path, leaf in _flatten(params_np):
        a = np.asarray(leaf, np.float32)
        name = path[-1]
        if name in ("v", "kernel", "A_i_j_kernel") and a.ndim == 4:
            tc = any(seg in _TRANSPOSE_CONV_SEGMENTS for seg in path)
            a = a.transpose(2, 3, 0, 1) if tc else a.transpose(3, 2, 0, 1)
        elif name == "g":
            a = a.reshape(-1, 1, 1, 1)
        sd[flax_path_to_torch_key(path)] = torch.from_numpy(np.array(a))
    return sd


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
