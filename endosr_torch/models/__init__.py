"""Training and serving models of the port (counterpart of
``endosr.models``); :func:`create_model` maps the YAML ``model:`` name to
its class."""

from __future__ import annotations

import importlib
import logging

__all__ = ["create_model"]

# ``model:`` → (module under endosr_torch.models, class)
MODELS = {
    "sr": ("sr_model", "SRModel"),
    "sftmd": ("f_model", "FModel"),
    "predictor": ("p_model", "PModel"),
    "corrector": ("c_model", "CModel"),
    "sftmd_depthCond": ("f_depthcond", "FModelDepthCond"),
    "sftmd_depth": ("f_depth", "FModelDepth"),
    "sftmd_depthSegNet": ("f_depthseg", "FModelDepthSeg"),
    "srgan": ("srgan_model", "SRGANModel"),
    "sftgan": ("sftgan_model", "SFTGANACDModel"),
}


def create_model(opt, device=None, mesh=None):
    """The model the YAML's ``model:`` names, on ``device`` (None: CUDA,
    which raises without one), data-parallel over ``mesh``
    (``parallel/mesh.py``; None: the default, none in one process)."""
    model = opt["model"]
    if model not in MODELS:
        raise NotImplementedError(f"Model [{model}] not recognized.")
    module, cls = MODELS[model]
    M = getattr(importlib.import_module(f"endosr_torch.models.{module}"), cls)
    m = M(opt, device=device, mesh=mesh)
    logging.getLogger("base").info("Model [%s] is created.", m.__class__.__name__)
    return m
