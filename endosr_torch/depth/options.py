"""The depth trainer's options (counterpart of ``endosr/depth/options.py``).

The same argparse surface (paths, training, optimisation, ablation,
system, loading, logging, evaluation) and defaults: the endovis settings
(feed 256×320, batch 12, ResNet-18, ``separate_resnet`` pose, frames
[0, -1, 1], scales 0–3, Adam at 1e-4). ``--no_cuda`` runs the trainer on
the CPU; without it the trainer takes CUDA and raises when there is none.
``--num_workers`` is the loader's worker processes. ``--weights_init
pretrained`` is accepted and, as in the JAX package, loads nothing.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["MonodepthOptions"]

file_dir = os.path.dirname(__file__)


class MonodepthOptions:
    def __init__(self):
        self.parser = argparse.ArgumentParser(description="Monodepth options")

        # PATHS
        self.parser.add_argument("--data_path", type=str,
                                 default=os.path.join(file_dir, "endovis_data"))
        self.parser.add_argument("--log_dir", type=str,
                                 default=os.path.join(file_dir, "tmp"))

        # TRAINING
        self.parser.add_argument("--model_name", type=str, default="mdp")
        self.parser.add_argument("--split", type=str, default="endovis",
                                 choices=["eigen_zhou", "eigen_full", "odom",
                                          "benchmark", "endovis", "colondepth"])
        self.parser.add_argument("--num_layers", type=int, default=18,
                                 choices=[18, 34, 50, 101, 152])
        self.parser.add_argument("--dataset", type=str, default="endovis",
                                 choices=["kitti", "kitti_odom", "kitti_depth",
                                          "kitti_test", "endovis", "colondepth"])
        self.parser.add_argument("--png", action="store_true")
        self.parser.add_argument("--height", type=int, default=256)
        self.parser.add_argument("--width", type=int, default=320)
        self.parser.add_argument("--disparity_smoothness", type=float, default=1e-3)
        self.parser.add_argument("--scales", nargs="+", type=int,
                                 default=[0, 1, 2, 3])
        self.parser.add_argument("--min_depth", type=float, default=0.1)
        self.parser.add_argument("--max_depth", type=float, default=100.0)
        self.parser.add_argument("--use_stereo", action="store_true")
        self.parser.add_argument("--frame_ids", nargs="+", type=int,
                                 default=[0, -1, 1])

        # OPTIMIZATION
        self.parser.add_argument("--batch_size", type=int, default=12)
        self.parser.add_argument("--learning_rate", type=float, default=1e-4)
        self.parser.add_argument("--num_epochs", type=int, default=20)
        self.parser.add_argument("--scheduler_step_size", type=int, default=15)

        # ABLATION
        self.parser.add_argument("--v1_multiscale", action="store_true")
        self.parser.add_argument("--avg_reprojection", action="store_true")
        self.parser.add_argument("--disable_automasking", action="store_true")
        self.parser.add_argument("--predictive_mask", action="store_true")
        self.parser.add_argument("--no_ssim", action="store_true")
        self.parser.add_argument("--weights_init", type=str, default="scratch",
                                 choices=["pretrained", "scratch"])
        self.parser.add_argument("--pose_model_input", type=str, default="pairs",
                                 choices=["pairs", "all"])
        self.parser.add_argument("--pose_model_type", type=str,
                                 default="separate_resnet",
                                 choices=["posecnn", "separate_resnet", "shared"])

        # SYSTEM
        self.parser.add_argument("--no_cuda", action="store_true",
                                 help="run on the CPU (default: CUDA, which "
                                 "must be present)")
        self.parser.add_argument("--num_workers", type=int, default=4)

        # LOADING
        self.parser.add_argument("--load_weights_folder", type=str)
        self.parser.add_argument("--models_to_load", nargs="+", type=str,
                                 default=["encoder", "depth", "pose_encoder",
                                          "pose"])

        # LOGGING
        self.parser.add_argument("--log_frequency", type=int, default=250)
        self.parser.add_argument("--save_frequency", type=int, default=1)

        # EVALUATION
        self.parser.add_argument("--eval_stereo", action="store_true")
        self.parser.add_argument("--eval_mono", action="store_true")
        self.parser.add_argument("--disable_median_scaling", action="store_true")
        self.parser.add_argument("--pred_depth_scale_factor", type=float, default=1)
        self.parser.add_argument("--ext_disp_to_eval", type=str)
        self.parser.add_argument("--eval_split", type=str, default="endovis")
        self.parser.add_argument("--save_pred_disps", action="store_true")
        self.parser.add_argument("--no_eval", action="store_true")
        self.parser.add_argument("--eval_eigen_to_benchmark", action="store_true")
        self.parser.add_argument("--eval_out_dir", type=str)
        self.parser.add_argument("--post_process", action="store_true")

    def parse(self, args=None):
        return self.parser.parse_args(args)
