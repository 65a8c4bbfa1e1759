"""Host-side data helpers (counterpart of ``endosr/data/util.py``): image
paths, image reading (``cv2``, or an LMDB archive), paired flips and
rotations, and conversions."""

from __future__ import annotations

import os
import pickle
import random

import numpy as np

__all__ = ["IMG_EXTENSIONS", "is_image_file", "get_image_paths", "read_img",
           "augment", "bgr_to_rgb_f32", "to_f32_01", "get_one_hot"]

IMG_EXTENSIONS = [".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm",
                  ".PPM", ".bmp", ".BMP", ".tif", ".TIF", ".tiff", ".TIFF"]


def is_image_file(filename: str) -> bool:
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


def _get_paths_from_images(path: str) -> list[str]:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path} is not a valid directory")
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(dirpath, fname))
    if not images:
        raise FileNotFoundError(f"{path} has no valid image file")
    return images


def _get_paths_from_lmdb(dataroot: str):
    # meta_info.pkl is written by the repo's own LMDB tools
    with open(os.path.join(dataroot, "meta_info.pkl"), "rb") as f:
        meta = pickle.load(f)
    return meta["keys"], meta.get("resolution")


def get_image_paths(data_type: str, dataroot: str | None):
    """Sorted image paths ('img'), or (keys, "<h>_<w>_<c>" sizes) of an
    LMDB archive ('lmdb'); None without a root."""
    if dataroot is None:
        return None
    if data_type == "lmdb":
        return _get_paths_from_lmdb(dataroot)
    if data_type == "img":
        return sorted(_get_paths_from_images(dataroot))
    raise NotImplementedError(f"data_type [{data_type}] is not recognized.")


def read_img(env, path: str, size=None) -> np.ndarray:
    """An image as float32 HWC BGR in [0, 1]: from a file (``env`` None) or
    from the LMDB environment ``env`` under key ``path`` with ``size`` (h,
    w, c). A fourth channel is dropped."""
    if env is None:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(f"image not readable: {path}")
    else:
        with env.begin(write=False) as txn:
            buf = txn.get(path.encode("ascii"))
        img = np.frombuffer(buf, dtype=np.uint8).reshape(*size)
    img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.expand_dims(img, axis=2)
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def augment(imgs: list[np.ndarray], hflip: bool = True, rot: bool = True,
            rng: random.Random | None = None) -> list[np.ndarray]:
    """The same random flips and transpose for every HWC array of ``imgs``
    (three draws from ``rng``, as the JAX package draws them). Returns
    views; callers make them contiguous once at the end."""
    r = rng or random
    do_hflip = hflip and r.random() < 0.5
    do_vflip = rot and r.random() < 0.5
    do_rot90 = rot and r.random() < 0.5

    def _augment(img):
        if do_hflip:
            img = img[:, ::-1, :]
        if do_vflip:
            img = img[::-1, :, :]
        if do_rot90:
            img = img.transpose(1, 0, 2)
        return img

    return [_augment(img) for img in imgs]


def bgr_to_rgb_f32(img: np.ndarray) -> np.ndarray:
    """Contiguous float32 RGB from a BGR HWC array; an array without three
    channels comes back contiguous float32 as it is."""
    if img.ndim == 3 and img.shape[2] == 3:
        return np.ascontiguousarray(img[:, :, ::-1], dtype=np.float32)
    return np.ascontiguousarray(img, dtype=np.float32)


def to_f32_01(img: np.ndarray) -> np.ndarray:
    """uint8 → contiguous float32 [0, 1] by the same ``/ 255.0`` that
    :func:`read_img` divides by; float32 passes through contiguous."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return np.ascontiguousarray(img, np.float32)


def get_one_hot(label: np.ndarray, num_classes: int) -> np.ndarray:
    """Integer labels → one-hot along a new trailing axis."""
    flat = label.reshape(-1).astype(np.int64)
    eye = np.eye(num_classes, dtype=np.float32)
    return eye[flat].reshape(*label.shape, num_classes)
