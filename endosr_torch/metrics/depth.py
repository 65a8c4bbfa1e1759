"""Depth evaluation metrics, monodepth2's 7-metric protocol (counterpart of
``endosr/metrics/depth.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["compute_depth_errors"]


def compute_depth_errors(gt: np.ndarray, pred: np.ndarray) -> dict[str, float]:
    """abs_rel, sq_rel, rmse, rmse_log and a1/a2/a3 (δ < 1.25^k) between
    two depth maps (numpy)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25 ** 2).mean())
    a3 = float((thresh < 1.25 ** 3).mean())
    rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))
    abs_rel = float((np.abs(gt - pred) / gt).mean())
    sq_rel = float((((gt - pred) ** 2) / gt).mean())
    return {"abs_rel": abs_rel, "sq_rel": sq_rel, "rmse": rmse,
            "rmse_log": rmse_log, "a1": a1, "a2": a2, "a3": a3}
