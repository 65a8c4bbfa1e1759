"""A folder of colour images → grey PNGs/JPEGs of the same names: ``python
-m endosr_torch.scripts.color2gray --input I --output O`` (counterpart of
``scripts/color2gray.py``)."""

from __future__ import annotations

import argparse
import os

from endosr_torch.scripts._common import image_names


def color2gray(input_folder: str, save_folder: str) -> int:
    import cv2

    os.makedirs(save_folder, exist_ok=True)
    names = image_names(input_folder)
    for n in names:
        img = cv2.imread(os.path.join(input_folder, n), cv2.IMREAD_COLOR)
        cv2.imwrite(os.path.join(save_folder, n),
                    cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    return len(names)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    print(f"converted {color2gray(args.input, args.output)} images")


if __name__ == "__main__":
    main()
