"""Colour-space conversions and ``modcrop``, MATLAB-conformant
(counterpart of ``endosr/ops/color.py``): numpy, used for the Y-channel
PSNR and SSIM of evaluation and by the datasets' ``color`` option.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rgb2ycbcr", "bgr2ycbcr", "ycbcr2rgb", "channel_convert", "modcrop"]


def _pre(img: np.ndarray) -> tuple[np.ndarray, np.dtype]:
    in_type = img.dtype
    img = img.astype(np.float64)
    if in_type != np.uint8:
        img = img * 255.0
    return img, in_type


def _post(rlt: np.ndarray, in_type: np.dtype) -> np.ndarray:
    if in_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.0
    return rlt.astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr. Input uint8 [0,255] or float [0,1]."""
    img, in_type = _pre(img)
    if only_y:
        rlt = np.dot(img, [65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        rlt = np.matmul(
            img,
            [[65.481, -37.797, 112.0],
             [128.553, -74.203, -93.786],
             [24.966, 112.0, -18.214]],
        ) / 255.0 + [16, 128, 128]
    return _post(rlt, in_type)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR variant of :func:`rgb2ycbcr`."""
    img, in_type = _pre(img)
    if only_y:
        rlt = np.dot(img, [24.966, 128.553, 65.481]) / 255.0 + 16.0
    else:
        rlt = np.matmul(
            img,
            [[24.966, 112.0, -18.214],
             [128.553, -74.203, -93.786],
             [65.481, -37.797, 112.0]],
        ) / 255.0 + [16, 128, 128]
    return _post(rlt, in_type)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB ycbcr2rgb. Input uint8 [0,255] or float [0,1]."""
    img, in_type = _pre(img)
    rlt = np.matmul(
        img,
        [[0.00456621, 0.00456621, 0.00456621],
         [0, -0.00153632, 0.00791071],
         [0.00625893, -0.00318811, 0]],
    ) * 255.0 + [-222.921, 135.576, -276.836]
    return _post(rlt, in_type)


def channel_convert(in_c: int, tar_type: str, img_list: list[np.ndarray]) -> list[np.ndarray]:
    """Mode-string channel conversion matching ``data/util.py:149-166``."""
    if in_c == 3 and tar_type == "gray":
        gray_list = [np.dot(img[..., :3], [0.114, 0.587, 0.299]) for img in img_list]
        return [np.expand_dims(img, axis=2) for img in gray_list]
    if in_c == 3 and tar_type == "y":
        y_list = [bgr2ycbcr(img, only_y=True) for img in img_list]
        return [np.expand_dims(img, axis=2) for img in y_list]
    if in_c == 1 and tar_type == "RGB":
        return [np.repeat(img if img.ndim == 3 else img[..., None], 3, axis=2)
                for img in img_list]
    return img_list


def modcrop(img_in: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of scale (``data/util.py:236-249``)."""
    img = np.copy(img_in)
    if img.ndim == 2:
        h, w = img.shape
        img = img[: h - h % scale, : w - w % scale]
    elif img.ndim == 3:
        h, w, _ = img.shape
        img = img[: h - h % scale, : w - w % scale, :]
    else:
        raise ValueError(f"Wrong img ndim: [{img.ndim}].")
    return img
