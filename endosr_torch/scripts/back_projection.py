"""Iterative back-projection of SR outputs, SR ← SR + λ·up(LR − down(SR))
with the MATLAB bicubic: ``python -m endosr_torch.scripts.back_projection
--sr_dir S --lr_dir L --out_dir O --scale 4 [--iters 20]`` (counterpart of
``scripts/back_projection.py``)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from endosr_torch.ops.resize import imresize_np
from endosr_torch.scripts._common import image_names, to_u8


def back_projection(sr: np.ndarray, lr: np.ndarray, scale: int,
                    iters: int = 20, lam: float = 1.0) -> np.ndarray:
    """HWC float [0, 1] arrays → the refined SR, clipped to [0, 1]."""
    sr = sr.astype(np.float32).copy()
    for _ in range(iters):
        residual = lr - imresize_np(sr, 1 / scale, True)
        sr = sr + lam * imresize_np(residual, scale, True)
    return np.clip(sr, 0.0, 1.0)


def run_folder(sr_dir: str, lr_dir: str, out_dir: str, scale: int,
               iters: int = 20) -> int:
    """Every image of ``sr_dir`` with its namesake in ``lr_dir`` →
    ``out_dir``."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    names = image_names(sr_dir, (".png", ".jpg", ".jpeg"))
    for n in names:
        sr = cv2.imread(os.path.join(sr_dir, n)).astype(np.float32) / 255.0
        lr = cv2.imread(os.path.join(lr_dir, n)).astype(np.float32) / 255.0
        cv2.imwrite(os.path.join(out_dir, n),
                    to_u8(back_projection(sr, lr, scale, iters)))
    return len(names)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sr_dir", required=True)
    ap.add_argument("--lr_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--scale", type=int, required=True)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    n = run_folder(args.sr_dir, args.lr_dir, args.out_dir, args.scale,
                   args.iters)
    print(f"refined {n} images")


if __name__ == "__main__":
    main()
