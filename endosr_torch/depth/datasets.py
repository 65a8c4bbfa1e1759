"""Monocular video datasets of the depth trainer (counterpart of
``endosr/depth/datasets.py``; host numpy, no torch).

* :class:`MonoDataset` — frame triplets with a per-scale colour pyramid
  (``cv2.INTER_AREA``), one colour jitter shared by the frames of an item,
  per-scale K / inv_K and, with an ``'s'`` frame, the rig's ``stereo_T``.
  Items are dicts of NHWC float32 arrays keyed like monodepth2's:
  ('color', f, s), ('color_aug', f, 0), ('K', s), ('inv_K', s),
  "depth_gt", "stereo_T".
* :class:`EndovisDataset` — Hamlyn endoscopy: normalised intrinsics
  [[0.82, 0, 0.5], [0, 1.02, 0.5]], a 320×256-proportioned centre crop,
  10-digit frame names, the ``image0{1,2}`` stereo layout, GT depth PNGs.
* :class:`SequenceFolderDataset` — a folder of numbered frames.

Flips and jitter are drawn from the dataset's ``rng``, a
``random.Random(seed)``: the JAX datasets draw from an unseeded one, so
equal items need ``ds.rng = random.Random(s)`` on both.
"""

from __future__ import annotations

import os
import random

import numpy as np

__all__ = ["MonoDataset", "EndovisDataset", "SequenceFolderDataset", "readlines"]


def readlines(path: str) -> list[str]:
    with open(path) as f:
        return [line.rstrip() for line in f if line.strip()]


def _color_jitter_params(rng: random.Random):
    return {
        "brightness": rng.uniform(0.8, 1.2),
        "contrast": rng.uniform(0.8, 1.2),
        "saturation": rng.uniform(0.8, 1.2),
        "hue": rng.uniform(-0.1, 0.1),
    }


def _apply_color_jitter(img: np.ndarray, p: dict) -> np.ndarray:
    """Approximate torchvision ColorJitter on HWC RGB [0,1]."""
    import cv2

    img = np.clip(img * p["brightness"], 0, 1)
    mean = img.mean()
    img = np.clip((img - mean) * p["contrast"] + mean, 0, 1)
    gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
    img = np.clip((img - gray[..., None]) * p["saturation"] + gray[..., None], 0, 1)
    hsv = cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(p["hue"] * 180)) % 180
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32) / 255.0


class MonoDataset:
    K = np.array([[1.0, 0, 0.5, 0], [0, 1.0, 0.5, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)

    def __init__(self, data_path, filenames, height, width, frame_idxs,
                 num_scales=4, is_train=False, img_ext=".jpg", seed=None):
        self.data_path = data_path
        self.filenames = filenames
        self.height = height
        self.width = width
        self.frame_idxs = list(frame_idxs)
        self.num_scales = num_scales
        self.is_train = is_train
        self.img_ext = img_ext
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.filenames)

    # subclass hooks ----------------------------------------------------
    def get_color(self, line: str, frame_offset: int,
                  other_side: bool = False) -> np.ndarray:
        """Load a frame; ``other_side=True`` loads the opposite stereo
        camera's frame (``mono_dataset.py:156-160``)."""
        raise NotImplementedError

    def check_depth(self) -> bool:
        return False

    def get_depth(self, line: str):
        return None

    # -------------------------------------------------------------------
    def __getitem__(self, index):
        import cv2

        line = self.filenames[index]
        do_flip = self.is_train and self.rng.random() < 0.5
        do_aug = self.is_train and self.rng.random() < 0.5
        jitter = _color_jitter_params(self.rng) if do_aug else None

        inputs: dict = {}
        for f_i in self.frame_idxs:
            if f_i == "s":
                color = self.get_color(line, 0, other_side=True)
            else:
                color = self.get_color(line, f_i)
            if do_flip:
                color = color[:, ::-1].copy()
            for s in range(self.num_scales):
                h, w = self.height // (2 ** s), self.width // (2 ** s)
                resized = cv2.resize(color, (w, h),
                                     interpolation=cv2.INTER_AREA)
                inputs[("color", f_i, s)] = np.ascontiguousarray(
                    resized, np.float32)
            aug = inputs[("color", f_i, 0)]
            if jitter is not None:
                aug = _apply_color_jitter(aug, jitter)
            inputs[("color_aug", f_i, 0)] = np.ascontiguousarray(aug, np.float32)

        for s in range(self.num_scales):
            k = self.K.copy()
            k[0, :] *= self.width // (2 ** s)
            k[1, :] *= self.height // (2 ** s)
            inputs[("K", s)] = k
            inputs[("inv_K", s)] = np.linalg.inv(k).astype(np.float32)

        if self.check_depth():
            depth = self.get_depth(line)
            if depth is not None:
                if do_flip:
                    depth = depth[:, ::-1].copy()
                inputs["depth_gt"] = depth[..., None].astype(np.float32)

        if "s" in self.frame_idxs:
            # fixed rig extrinsic, baseline 0.1 with side/flip signs
            # (``mono_dataset.py:193-198``)
            parts = line.split()
            side = parts[2] if len(parts) == 3 else "l"
            stereo_t = np.eye(4, dtype=np.float32)
            baseline_sign = -1 if do_flip else 1
            side_sign = -1 if side == "l" else 1
            stereo_t[0, 3] = side_sign * baseline_sign * 0.1
            inputs["stereo_T"] = stereo_t
        return inputs


class EndovisDataset(MonoDataset):
    """Hamlyn endoscopy frames: ``<folder> <frame_number>`` split lines."""

    K = np.array([[0.82, 0, 0.5, 0], [0, 1.02, 0.5, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    full_res_shape = (384, 192)

    side_map = {"1": 1, "2": 2, "l": 1, "r": 2}

    def _frame_path(self, folder: str, frame: int, side=None) -> str:
        if side is not None:
            # stereo layout: <folder>/image0{1,2}/<frame>
            # (``endovis_dataset.py:68-75``)
            return os.path.join(self.data_path, folder,
                                f"image0{self.side_map[side]}",
                                f"{frame:010d}{self.img_ext}")
        return os.path.join(self.data_path, folder,
                            f"{frame:010d}{self.img_ext}")

    def _center_crop(self, img: np.ndarray) -> np.ndarray:
        """Crop to a 320×256-proportioned window (``endovis_dataset.py:33-45``)."""
        h, w = img.shape[:2]
        target_ratio = 320.0 / 256.0
        if w / h > target_ratio:
            new_w = int(h * target_ratio)
            left = (w - new_w) // 2
            return img[:, left:left + new_w]
        new_h = int(w / target_ratio)
        top = (h - new_h) // 2
        return img[top:top + new_h]

    def get_color(self, line: str, frame_offset: int,
                  other_side: bool = False) -> np.ndarray:
        import cv2

        parts = line.split()
        folder = parts[0]
        frame = int(parts[1]) + frame_offset
        side = parts[2] if len(parts) == 3 else None
        if other_side:
            assert side in ("l", "r"), "stereo frames need an l/r side token"
            side = {"l": "r", "r": "l"}[side]
        p = self._frame_path(folder, frame, side)
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(p)
        img = img[:, :, ::-1].astype(np.float32) / 255.0
        return self._center_crop(img)

    def check_depth(self) -> bool:
        line = self.filenames[0].split()
        p = os.path.join(self.data_path, line[0], "depth",
                         f"{int(line[1]):010d}.png")
        return os.path.exists(p)

    def get_depth(self, line: str):
        import cv2

        parts = line.split()
        p = os.path.join(self.data_path, parts[0], "depth",
                         f"{int(parts[1]):010d}.png")
        d = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        if d is None:
            return None
        d = self._center_crop(d.astype(np.float32))
        return cv2.resize(d, (self.width, self.height),
                          interpolation=cv2.INTER_NEAREST)


class SequenceFolderDataset(MonoDataset):
    """Frames named ``<index>.<ext>`` in one folder; lines are indices."""

    def get_color(self, line: str, frame_offset: int) -> np.ndarray:
        import cv2

        idx = int(line) + frame_offset
        for pattern in (f"{idx:010d}{self.img_ext}", f"{idx}{self.img_ext}"):
            p = os.path.join(self.data_path, pattern)
            if os.path.exists(p):
                img = cv2.imread(p, cv2.IMREAD_COLOR)
                return img[:, :, ::-1].astype(np.float32) / 255.0
        raise FileNotFoundError(
            os.path.join(self.data_path, f"{idx}{self.img_ext}"))
