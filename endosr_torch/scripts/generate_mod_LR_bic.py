"""Mod-cropped HR, MATLAB-bicubic LR and re-upsampled Bic images of a
folder under ``<savedir>/{HR,LR,Bic}/x<s>``: ``python -m
endosr_torch.scripts.generate_mod_LR_bic --sourcedir D --savedir O
[--scale 4] [--mod_scale S] [--no_bic]`` (counterpart of
``scripts/generate_mod_LR_bic.py``)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from endosr_torch.ops.color import modcrop
from endosr_torch.ops.resize import imresize_np
from endosr_torch.scripts._common import image_names, to_u8


def generate_mod_lr_bic(sourcedir: str, savedir: str, up_scale: int = 4,
                        mod_scale: int | None = None,
                        save_bic: bool = True) -> int:
    import cv2

    mod_scale = mod_scale or up_scale
    hr_dir = os.path.join(savedir, "HR", f"x{mod_scale}")
    lr_dir = os.path.join(savedir, "LR", f"x{up_scale}")
    bic_dir = os.path.join(savedir, "Bic", f"x{up_scale}")
    for d in (hr_dir, lr_dir, bic_dir):
        os.makedirs(d, exist_ok=True)
    names = image_names(sourcedir, (".png", ".jpg", ".jpeg", ".bmp", ".tif"))
    for name in names:
        img = cv2.imread(os.path.join(sourcedir, name), cv2.IMREAD_UNCHANGED)
        img_hr = modcrop(img.astype(np.float32) / 255.0, mod_scale)
        img_lr = imresize_np(img_hr, 1 / up_scale, True)
        cv2.imwrite(os.path.join(hr_dir, name), to_u8(img_hr))
        cv2.imwrite(os.path.join(lr_dir, name), to_u8(img_lr))
        if save_bic:
            cv2.imwrite(os.path.join(bic_dir, name),
                        to_u8(imresize_np(img_lr, up_scale, True)))
    return len(names)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sourcedir", required=True)
    ap.add_argument("--savedir", required=True)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--mod_scale", type=int, default=None)
    ap.add_argument("--no_bic", action="store_true")
    args = ap.parse_args(argv)
    n = generate_mod_lr_bic(args.sourcedir, args.savedir, args.scale,
                            args.mod_scale, not args.no_bic)
    print(f"processed {n} images")


if __name__ == "__main__":
    main()
