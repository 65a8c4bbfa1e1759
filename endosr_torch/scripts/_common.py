"""What the data scripts share."""

from __future__ import annotations

import os

import numpy as np

__all__ = ["image_names", "to_u8"]


def image_names(folder: str, exts=(".png", ".jpg", ".jpeg", ".bmp")):
    """The sorted file names in ``folder`` with one of ``exts`` (any
    case)."""
    return sorted(f for f in os.listdir(folder) if f.lower().endswith(exts))


def to_u8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float → uint8, clipped and rounded."""
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
