"""The training recipes of the repo's YAMLs as the port's tools take them.

:func:`train_opt` reads one of ``options/train/*.yml`` (its ``network_G``
and ``train:`` blocks, the depth and VGG losses off as there) and gives the
options of FModelDepthCond training on it, for tools that build the model
without the rest of the YAML (data paths, logger). :func:`x8_train_opt` is
the flagship ×8 recipe. :func:`msrresnet_x4_yaml` and
:func:`depthseg_yaml` write out the options of the other models' runs:
BasicSR's ``train_MSRResNet_x4`` recipe, and the depth + segmentation
co-training on the EndoScene ×2 YAML.
"""

from __future__ import annotations

from pathlib import Path

import yaml

__all__ = ["TRAIN_YAMLS", "X8_YAML", "train_opt", "x8_train_opt",
           "msrresnet_x4_yaml", "depthseg_yaml"]

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


def msrresnet_x4_yaml(root, train_gt, train_lq, val_gt, val_lq, name="sr_x4"):
    """Options of MSRResNet ×4 training (``model: sr``) in BasicSR's
    ``train_MSRResNet_x4`` recipe, in this repo's schema: nf 64, nb 16;
    ``LQGTker`` data (128² GT patches on disk: the dataset crops none),
    flips and rotations, batch 16, enlarge ratio 100; L1; Adam 2e-4,
    β (0.9, 0.99); cosine restarts every 250k of 1M iterations down to
    1e-7. ``root`` is the experiment root; the four data roots are
    folders of images."""
    block = {"mode": "LQGTker", "data_type": "img", "color": "RGB"}
    return {
        "name": name, "use_tb_logger": False, "model": "sr", "scale": 4,
        "datasets": {
            "train": {**block, "name": "train", "dataroot_GT": train_gt,
                      "dataroot_LQ": train_lq, "use_shuffle": True,
                      "n_workers": 6, "batch_size": 16, "GT_size": 128,
                      "LR_size": 32, "use_flip": True, "use_rot": True,
                      "dataset_enlarge_ratio": 100},
            "val": {**block, "name": "val", "dataroot_GT": val_gt,
                    "dataroot_LQ": val_lq}},
        "network_G": {"which_model_G": "MSRResNet", "in_nc": 3, "out_nc": 3,
                      "nf": 64, "nb": 16},
        "path": {"root": root, "pretrain_model_G": None, "strict_load": True,
                 "resume_state": None},
        "train": {"lr_G": 2e-4, "lr_scheme": "CosineAnnealingLR_Restart",
                  "beta1": 0.9, "beta2": 0.99, "niter": 1000000,
                  "warmup_iter": -1, "T_period": [250000] * 4,
                  "restarts": [250000, 500000, 750000],
                  "restart_weights": [1, 1, 1], "eta_min": 1e-7,
                  "pixel_criterion": "l1", "pixel_weight": 1.0,
                  "manual_seed": 0, "val_freq": 5000},
        "logger": {"print_freq": 100, "save_checkpoint_freq": 5000},
    }


def depthseg_yaml(root, gt, lq, depth, seglabel, split_list,
                  name="depthseg_x2"):
    """Options of DepthNet + FCN8s co-training (``model:
    sftmd_depthSegNet``): the EndoScene ×2 YAML (its ``network_G``,
    ``train:`` block and train dataset settings) with the segmentation
    labels under ``seglabel``, ``network_SegNet`` FCN8s of 2 classes and
    the ``train.segNet`` block of the JAX package's model test (lr 1e-4,
    momentum 0.9, no weight decay, the reference's ``setp_size`` 100,
    γ 0.5). ``u8_pipeline`` off: the co-training step feeds uint8 batches
    to the networks unnormalized, as JAX's does (C14). No val block;
    ``root`` is the experiment root."""
    y = yaml.safe_load(TRAIN_YAMLS[("endoscene", 2)].read_text())
    y.update(name=name, model="sftmd_depthSegNet", use_tb_logger=False,
             network_SegNet={"num_classes": 2})
    y["datasets"] = {"train": {
        **y["datasets"]["train"], "name": "train", "dataroot_GT": gt,
        "dataroot_LQ": lq, "dataroot_depthMap": depth,
        "dataroot_seglabel": seglabel, "dataset_split_list": split_list,
        "u8_pipeline": False}}
    y["path"].update(root=root)
    y["train"]["segNet"] = {"lr": 1e-4, "momentum": 0.9, "weight_decay": 0,
                            "setp_size": 100, "gamma": 0.5}
    return y
