"""Pack an image folder into an LMDB archive: ``python -m
endosr_torch.scripts.create_lmdb --input I --output O.lmdb`` (counterpart
of ``scripts/create_lmdb.py``). Raw HWC uint8 blobs keyed by the file's
stem, written by ``data/lmdb_io.py::write_lmdb`` (no ``lmdb`` package is
needed), and ``meta_info.pkl`` with the keys and each image's
``h_w_c``, as ``data/util.py`` reads them."""

from __future__ import annotations

import argparse
import os
import pickle

from endosr_torch.data.lmdb_io import write_lmdb
from endosr_torch.scripts._common import image_names


def create_lmdb(img_folder: str, lmdb_save_path: str) -> int:
    import cv2

    items, keys, resolutions = [], [], []
    for n in image_names(img_folder):
        img = cv2.imread(os.path.join(img_folder, n), cv2.IMREAD_UNCHANGED)
        key = os.path.splitext(n)[0]
        items.append((key.encode("ascii"), img.tobytes()))
        keys.append(key)
        c = 1 if img.ndim == 2 else img.shape[2]
        resolutions.append(f"{img.shape[0]}_{img.shape[1]}_{c}")
    write_lmdb(lmdb_save_path, items)
    with open(os.path.join(lmdb_save_path, "meta_info.pkl"), "wb") as f:
        pickle.dump({"keys": keys, "resolution": resolutions}, f)
    return len(items)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True, help="path ending in .lmdb")
    args = ap.parse_args(argv)
    print(f"packed {create_lmdb(args.input, args.output)} images")


if __name__ == "__main__":
    main()
