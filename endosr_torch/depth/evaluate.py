"""Depth and pose evaluation (counterpart of ``endosr/depth/evaluate.py``;
numpy).

:func:`evaluate_depth` runs a predictor over a dataset's frames, with
optional flip post-processing (:func:`batch_post_process_disparity`), the
median-scaling protocol and the 7 metrics; :func:`evaluate_pose` gives the
absolute trajectory error (:func:`compute_ate`) over 5-frame snippets.
"""

from __future__ import annotations

import numpy as np

from endosr_torch.metrics.depth import compute_depth_errors

__all__ = ["batch_post_process_disparity", "evaluate_depth", "evaluate_pose",
           "compute_ate"]


def batch_post_process_disparity(l_disp: np.ndarray, r_disp: np.ndarray):
    """Flip post-processing from the original monodepth
    (``evaluate_depth.py:48-57``): blend disp and flipped-disp with edge masks."""
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    grid = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h),
                       indexing="xy")[0][None]
    l_mask = 1.0 - np.clip(20 * (grid - 0.05), 0, 1)
    r_mask = l_mask[:, :, ::-1]
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp


def evaluate_depth(predictor, dataset, post_process: bool = False,
                   median_scaling: bool = True, min_depth: float = 1e-3,
                   max_depth: float = 80.0) -> dict[str, float]:
    """``predictor``: HWC RGB [0, 1] → disparity HW (e.g.
    ``depth/infer.py::DepthPredictor.predict_disp``). Returns the 7 metrics
    averaged over the items with GT (``depth_gt``) and, with
    ``median_scaling``, ``med_ratio``."""
    errors = []
    ratios = []
    for i in range(len(dataset)):
        item = dataset[i]
        color = item[("color", 0, 0)]
        disp = predictor(color)
        if post_process:
            disp_flipped = predictor(color[:, ::-1].copy())
            disp = batch_post_process_disparity(
                disp[None], disp_flipped[None, :, ::-1])[0]
        gt = item.get("depth_gt")
        if gt is None:
            continue
        gt = gt[..., 0]
        pred_depth = 1.0 / np.maximum(disp, 1e-7)
        mask = (gt > min_depth) & (gt < max_depth)
        if not mask.any():
            continue
        p, g = pred_depth[mask], gt[mask]
        if median_scaling:
            ratio = np.median(g) / np.median(p)
            ratios.append(ratio)
            p = p * ratio
        p = np.clip(p, min_depth, max_depth)
        errors.append(compute_depth_errors(g, p))
    if not errors:
        raise RuntimeError("no GT depth found in the dataset")
    out = {k: float(np.mean([e[k] for e in errors])) for k in errors[0]}
    if ratios:
        out["med_ratio"] = float(np.median(ratios))
    return out


def compute_ate(gtruth_xyz: np.ndarray, pred_xyz: np.ndarray) -> float:
    """Absolute trajectory error with origin+scale alignment
    (``evaluate_pose.py:23-43``)."""
    offset = gtruth_xyz[0] - pred_xyz[0]
    pred_xyz = pred_xyz + offset[None]
    scale = np.sum(gtruth_xyz * pred_xyz) / np.sum(pred_xyz ** 2)
    alignment_error = pred_xyz * scale - gtruth_xyz
    return float(np.sqrt(np.sum(alignment_error ** 2) / gtruth_xyz.shape[0]))


def evaluate_pose(pose_fn, frame_pairs, gt_poses: np.ndarray,
                  track_length: int = 5) -> dict[str, float]:
    """pose_fn: (img_a, img_b) → 4×4 cam_T_cam. Computes ATE over sliding
    snippets (``evaluate_pose.py:49-134``)."""
    pred_local = [pose_fn(a, b) for a, b in frame_pairs]
    ates = []
    num = len(pred_local) - track_length + 2
    for i in range(max(0, num)):
        local = np.stack(pred_local[i:i + track_length - 1])
        gt_local = gt_poses[i:i + track_length]
        pred_xyz = _accumulate(local)
        gt_xyz = gt_local[:, :3, 3]
        ates.append(compute_ate(gt_xyz, pred_xyz))
    return {"ate_mean": float(np.mean(ates)), "ate_std": float(np.std(ates))}


def _accumulate(local_poses: np.ndarray) -> np.ndarray:
    cam_to_world = np.eye(4)
    xyzs = [cam_to_world[:3, 3].copy()]
    for t in local_poses:
        cam_to_world = cam_to_world @ np.linalg.inv(t)
        xyzs.append(cam_to_world[:3, 3].copy())
    return np.stack(xyzs)
