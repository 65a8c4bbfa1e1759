"""Training and serving models of the port (counterpart of
``endosr.models``); :func:`create_model` maps the YAML ``model:`` name to
its class."""

from __future__ import annotations

import logging

__all__ = ["create_model"]


def create_model(opt, device=None):
    """The model the YAML's ``model:`` names, on ``device`` (None: CUDA,
    which raises without one)."""
    model = opt["model"]
    if model == "sftmd_depthCond":
        from endosr_torch.models.f_depthcond import FModelDepthCond as M
    else:
        raise NotImplementedError(
            f"Model [{model}] is not ported (the port has sftmd_depthCond "
            "only)")
    m = M(opt, device=device)
    logging.getLogger("base").info("Model [%s] is created.", m.__class__.__name__)
    return m
