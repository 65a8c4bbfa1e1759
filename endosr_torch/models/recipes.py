"""The training recipes of the repo's YAMLs as the port's tools take them.

:func:`train_opt` reads one of ``options/train/*.yml`` (its ``network_G``
and ``train:`` blocks, the depth and VGG losses off as there) and gives the
options of FModelDepthCond training on it, for tools that build the model
without the rest of the YAML (data paths, logger). :func:`x8_train_opt` is
the flagship ×8 recipe.
"""

from __future__ import annotations

from pathlib import Path

import yaml

__all__ = ["TRAIN_YAMLS", "X8_YAML", "train_opt", "x8_train_opt"]

_TRAIN = Path(__file__).resolve().parents[2] / "options" / "train"
# every training YAML the repo ships, by (dataset, scale)
TRAIN_YAMLS = {
    (ds, scale): _TRAIN / "train_depthNet_SEAN_depthMask_{}x{}.yml".format(
        "endoscene_" if ds == "endoscene" else "", scale)
    for ds, scale in (("kvasir", 2), ("kvasir", 4), ("kvasir", 8),
                      ("endoscene", 2), ("endoscene", 3), ("endoscene", 4))}
X8_YAML = TRAIN_YAMLS[("kvasir", 8)]


def train_opt(yaml_path, precision=None, **net):
    """Options of the YAML's DepthNet (its ``network_G``; ``net`` adds
    keys) training on its ``train:`` block at ``precision`` (None: fp32,
    as the YAMLs leave it)."""
    y = yaml.safe_load(Path(yaml_path).read_text())
    return {
        "is_train": True, "model": y["model"], "scale": y["scale"],
        "precision": precision,
        "datasets": {"train": {
            "depthMaskNum": y["datasets"]["train"]["depthMaskNum"]}},
        "network_G": {**y["network_G"], **net},
        "path": {"pretrain_model_G": None, "strict_load": True},
        "train": y["train"],
    }


def x8_train_opt(precision="bf16", **net):
    """The flagship recipe: :func:`train_opt` of the ×8 Kvasir YAML."""
    return train_opt(X8_YAML, precision, **net)
