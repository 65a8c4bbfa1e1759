"""``*_disp.npy`` disparity maps → uint16 PNGs scaled to their maximum
(``<stem>_depth.png``): ``python -m endosr_torch.scripts.read_depth_map
--input FILE_OR_FOLDER`` (counterpart of ``scripts/read_depth_map.py``)."""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def disp_npy_to_png(npy_path: str, out_path: str | None = None) -> str:
    import cv2

    disp = np.squeeze(np.load(npy_path))
    png = (disp / max(float(disp.max()), 1e-8) * 65535).astype(np.uint16)
    out_path = out_path or npy_path.replace("_disp.npy", "_depth.png")
    cv2.imwrite(out_path, png)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="file or folder of *_disp.npy")
    args = ap.parse_args(argv)
    paths = ([args.input] if os.path.isfile(args.input) else
             sorted(glob.glob(os.path.join(args.input, "*_disp.npy"))))
    for p in paths:
        print(disp_npy_to_png(p))


if __name__ == "__main__":
    main()
