"""A blur kernel as a heat map: ``python -m endosr_torch.scripts.kernel_visual
[--out kernel.png] [--l 21] [--sig 2.6]`` (counterpart of
``scripts/kernel_visual.py``)."""

from __future__ import annotations

import argparse

import numpy as np

from endosr_torch.ops.degradation import isotropic_gaussian_kernel


def visualize_kernel(out_path: str, l: int = 21, sig: float = 2.6) -> None:
    """The isotropic kernel of σ ``sig`` scaled to its peak, resized to
    256² (nearest) and coloured with ``COLORMAP_JET``, written to
    ``out_path``."""
    import cv2

    k = isotropic_gaussian_kernel(l, sig).numpy()
    norm = (k / k.max() * 255).astype(np.uint8)
    heat = cv2.applyColorMap(cv2.resize(norm, (256, 256),
                                        interpolation=cv2.INTER_NEAREST),
                             cv2.COLORMAP_JET)
    cv2.imwrite(out_path, heat)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="kernel.png")
    ap.add_argument("--l", type=int, default=21)
    ap.add_argument("--sig", type=float, default=2.6)
    args = ap.parse_args(argv)
    visualize_kernel(args.out, args.l, args.sig)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
