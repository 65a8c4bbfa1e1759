"""Ground-truth depth PNGs (uint16) of a folder → one ``gt_depths.npz``
keyed by frame stem, in metres (÷ ``depth_scale``): ``python -m
endosr_torch.scripts.export_gt_depth --depth_dir D [--out gt_depths.npz]
[--depth_scale 1000]`` (counterpart of ``scripts/export_gt_depth.py``;
``depth/evaluate.py`` reads the file)."""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def export_gt_depths(depth_dir: str, out_path: str,
                     depth_scale: float = 1000.0) -> int:
    import cv2

    gt = {}
    for p in sorted(glob.glob(os.path.join(depth_dir, "*.png"))):
        d = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        if d is not None:
            key = os.path.splitext(os.path.basename(p))[0]
            gt[key] = d.astype(np.float32) / depth_scale
    np.savez_compressed(out_path, **gt)
    return len(gt)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth_dir", required=True)
    ap.add_argument("--out", default="gt_depths.npz")
    ap.add_argument("--depth_scale", type=float, default=1000.0)
    args = ap.parse_args(argv)
    n = export_gt_depths(args.depth_dir, args.out, args.depth_scale)
    print(f"exported {n} GT depth maps → {args.out}")


if __name__ == "__main__":
    main()
