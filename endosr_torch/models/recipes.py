"""The flagship ×8 training recipe as the port's entry points take it.

:func:`x8_train_opt` reads ``options/train/train_depthNet_SEAN_depthMask_x8.yml``
(its ``network_G`` and ``train:`` blocks, the depth and VGG losses off as
there) and gives the options of FModelDepthCond training on it, for tools
that build the model without the rest of the YAML (data paths, logger).
"""

from __future__ import annotations

from pathlib import Path

import yaml

__all__ = ["X8_YAML", "x8_train_opt"]

X8_YAML = (Path(__file__).resolve().parents[2] / "options" / "train"
           / "train_depthNet_SEAN_depthMask_x8.yml")


def x8_train_opt(precision="bf16", **net):
    """Options of the flagship DepthNet (the YAML's ``network_G``; ``net``
    adds keys) training on the YAML's ``train:`` block at ``precision``."""
    y = yaml.safe_load(X8_YAML.read_text())
    return {
        "is_train": True, "model": y["model"], "scale": y["scale"],
        "precision": precision,
        "datasets": {"train": {
            "depthMaskNum": y["datasets"]["train"]["depthMaskNum"]}},
        "network_G": {**y["network_G"], **net},
        "path": {"pretrain_model_G": None, "strict_load": True},
        "train": y["train"],
    }
