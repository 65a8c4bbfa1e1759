"""Helpers of the entry points (counterpart of ``endosr/utils/misc.py``):
directories, seeding, timestamps, the loggers, and image conversion and
saving."""

from __future__ import annotations

import logging
import os
import random
import sys
from datetime import datetime

import numpy as np
import torch

__all__ = ["get_timestamp", "mkdir", "mkdirs", "mkdir_and_rename",
           "set_random_seed", "setup_logger", "close_logger", "tensor2img",
           "save_img"]


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def mkdirs(paths) -> None:
    if isinstance(paths, str):
        mkdir(paths)
    else:
        for path in paths:
            mkdir(path)


def mkdir_and_rename(path: str) -> None:
    """Archive an existing directory as ``<path>_archived_<timestamp>``, then
    create ``path`` afresh."""
    if os.path.exists(path):
        new_name = path + "_archived_" + get_timestamp()
        logging.getLogger("base").info("Path already exists. Rename it to %s",
                                       new_name)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_logger(logger_name: str, root: str, phase: str, level=logging.INFO,
                 screen: bool = False, tofile: bool = False) -> list:
    """Add a file handler (``<root>/<phase>_<timestamp>.log``) and/or a
    stdout handler to the logger ``logger_name``; returns the handlers
    added, for :func:`close_logger`."""
    lg = logging.getLogger(logger_name)
    formatter = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S")
    lg.setLevel(level)
    added = []
    if tofile:
        # appended: a resumed run started within the same second as the
        # run it resumes gets the same file name
        fh = logging.FileHandler(
            os.path.join(root, phase + f"_{get_timestamp()}.log"), mode="a")
        added.append(fh)
    if screen:
        added.append(logging.StreamHandler(sys.stdout))
    for h in added:
        h.setFormatter(formatter)
        lg.addHandler(h)
    return added


def close_logger(logger_name: str, handlers) -> None:
    """Remove and close ``handlers`` (from :func:`setup_logger`)."""
    lg = logging.getLogger(logger_name)
    for h in handlers:
        lg.removeHandler(h)
        h.close()


def tensor2img(arr, out_type=np.uint8, min_max=(0, 1)) -> np.ndarray:
    """NHWC (or HWC, HW) RGB array or tensor in ``min_max`` → HWC BGR image
    (uint8 by default): a leading batch axis of 1 is dropped, the values
    clamped and scaled, RGB turned to BGR. A tensor may lie on any
    device."""
    if torch.is_tensor(arr):
        arr = arr.detach().float().cpu().numpy()
    img = np.asarray(arr, dtype=np.float32)
    if img.ndim == 4:
        img = img[0]
    img = np.clip(img, min_max[0], min_max[1])
    img = (img - min_max[0]) / (min_max[1] - min_max[0])
    if img.ndim == 3 and img.shape[2] == 3:
        img = img[:, :, ::-1]
    elif img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if out_type == np.uint8:
        img = (img * 255.0).round()
    return img.astype(out_type)


def save_img(img: np.ndarray, img_path: str) -> None:
    """Write a BGR image with ``cv2``."""
    import cv2

    if not cv2.imwrite(img_path, img):
        raise OSError(f"cv2 could not write {img_path}")
