"""The depth trainer's entry point (counterpart of ``endosr/depth/train.py``).

    python -m endosr_torch.depth.train --data_path <frames> [--no_cuda] ...

Runs on CUDA, and raises without a CUDA device, unless ``--no_cuda`` is
given. :func:`main` takes the argument list (None: ``sys.argv``) and
returns the trained :class:`~endosr_torch.depth.trainer.Trainer`.
"""

from __future__ import annotations

import os

from endosr_torch.depth.options import MonodepthOptions

__all__ = ["build_dataset", "main"]


def build_dataset(opts, is_train=True):
    """The dataset the options name. Without a split file (the package
    ships none, as the JAX package), the frames are every usable index of
    the ``data_path`` folder in a :class:`SequenceFolderDataset`; with one,
    the options' dataset class."""
    from endosr_torch.depth.datasets import (EndovisDataset,
                                             SequenceFolderDataset, readlines)

    split_file = os.path.join(
        os.path.dirname(__file__), "splits", opts.split,
        "train_files.txt" if is_train else "val_files.txt",
    )
    if os.path.exists(split_file):
        filenames = readlines(split_file)
    else:
        names = sorted(
            f for f in os.listdir(opts.data_path)
            if f.lower().endswith((".jpg", ".png"))
        )
        idxs = sorted(int(os.path.splitext(n)[0]) for n in names)
        lo, hi = min(opts.frame_ids), max(opts.frame_ids)
        filenames = [str(i) for i in idxs
                     if i + lo >= idxs[0] and i + hi <= idxs[-1]]

    cls = EndovisDataset if opts.dataset in ("endovis", "colondepth") else None
    if cls is None and opts.dataset.startswith("kitti"):
        from endosr_torch.depth.kitti import (KITTIDepthDataset,
                                              KITTIOdomDataset,
                                              KITTIRAWDataset)

        cls = {"kitti": KITTIRAWDataset, "kitti_odom": KITTIOdomDataset,
               "kitti_depth": KITTIDepthDataset}[opts.dataset]
    elif cls is None:
        cls = SequenceFolderDataset
    if not os.path.exists(split_file) and not opts.dataset.startswith("kitti"):
        cls = SequenceFolderDataset
    ext = ".png" if opts.png else ".jpg"
    return cls(opts.data_path, filenames, opts.height, opts.width,
               opts.frame_ids, num_scales=len(opts.scales),
               is_train=is_train, img_ext=ext)


def main(argv=None):
    opts = MonodepthOptions().parse(argv)
    from endosr_torch.depth.trainer import Trainer

    dataset = build_dataset(opts, is_train=True)
    trainer = Trainer(opts, dataset=dataset)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
