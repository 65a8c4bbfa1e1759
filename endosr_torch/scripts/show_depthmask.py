"""The K binary depth-bin masks of one ``*_disp.npy`` as PNGs
(``<stem>_mask<k>.png``): ``python -m endosr_torch.scripts.show_depthmask
--disp D --out O [--num 10] [--fixed_range]`` (counterpart of
``scripts/show_depthmask.py``; the masks of ``ops/masks.py::depth_masks_np``)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from endosr_torch.ops.masks import depth_masks_np


def show_depth_mask(disp_npy: str, out_dir: str, num_masks: int = 10,
                    fixed_range: bool = False) -> list[str]:
    import cv2

    masks = depth_masks_np(np.squeeze(np.load(disp_npy)), fixed_range,
                           num_masks)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(disp_npy))[0]
    written = []
    for k in range(num_masks):
        p = os.path.join(out_dir, f"{stem}_mask{k}.png")
        cv2.imwrite(p, (masks[..., k] * 255).astype(np.uint8))
        written.append(p)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--disp", required=True, help="path to *_disp.npy")
    ap.add_argument("--out", required=True)
    ap.add_argument("--num", type=int, default=10)
    ap.add_argument("--fixed_range", action="store_true")
    args = ap.parse_args(argv)
    print("\n".join(show_depth_mask(args.disp, args.out, args.num,
                                    args.fixed_range)))


if __name__ == "__main__":
    main()
