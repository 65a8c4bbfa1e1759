"""monodepth2's geometry toolkit (counterpart of ``endosr/depth/layers.py``).

Only :func:`disp_to_depth` (``endosr/depth/layers.py:30``), which the
depth-map producer needs; the rest (poses, back-projection, warps,
smoothness) goes with the depth trainer.
"""

from __future__ import annotations

__all__ = ["disp_to_depth"]


def disp_to_depth(disp, min_depth: float = 0.1, max_depth: float = 100.0):
    """Sigmoid disparity → (scaled disparity, depth): the disparity mapped
    onto [1/max_depth, 1/min_depth] and its inverse. Takes a tensor or a
    numpy array."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp
