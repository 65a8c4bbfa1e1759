"""Overlapping crops of large images for training: ``python -m
endosr_torch.scripts.extract_subimgs_single --input I --output O
[--crop_sz 480] [--step 240] [--thres_sz 48]`` (counterpart of
``scripts/extract_subimgs_single.py``; ``<stem>_s001.png``, … in row-major
order of the crops, a thread pool over the images)."""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from endosr_torch.scripts._common import image_names


def _starts(n: int, crop_sz: int, step: int, thres_sz: int) -> list[int]:
    """Crop origins along a side of ``n``: every ``step``, plus a last one
    flush with the end where more than ``thres_sz`` would be left over."""
    s = list(np.arange(0, n - crop_sz + 1, step))
    if n - (s[-1] + crop_sz) > thres_sz:
        s.append(n - crop_sz)
    return s


def extract_subimages(input_folder: str, save_folder: str, crop_sz: int = 480,
                      step: int = 240, thres_sz: int = 48,
                      compression_level: int = 3, n_threads: int = 4) -> int:
    import cv2

    os.makedirs(save_folder, exist_ok=True)

    def worker(name):
        img = cv2.imread(os.path.join(input_folder, name), cv2.IMREAD_UNCHANGED)
        h, w = img.shape[:2]
        stem = os.path.splitext(name)[0]
        idx = 0
        for x in _starts(h, crop_sz, step, thres_sz):
            for y in _starts(w, crop_sz, step, thres_sz):
                idx += 1
                cv2.imwrite(os.path.join(save_folder, f"{stem}_s{idx:03d}.png"),
                            np.ascontiguousarray(img[x:x + crop_sz,
                                                     y:y + crop_sz]),
                            [cv2.IMWRITE_PNG_COMPRESSION, compression_level])
        return idx

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        return sum(pool.map(worker, image_names(input_folder)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--crop_sz", type=int, default=480)
    ap.add_argument("--step", type=int, default=240)
    ap.add_argument("--thres_sz", type=int, default=48)
    args = ap.parse_args(argv)
    n = extract_subimages(args.input, args.output, args.crop_sz, args.step,
                          args.thres_sz)
    print(f"wrote {n} sub-images")


if __name__ == "__main__":
    main()
