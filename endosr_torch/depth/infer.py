"""The depth-map producer (counterpart of ``endosr/depth/infer.py``).

Loads monodepth2's ``encoder.pth`` / ``depth.pth``
(``utils/port_params.py::load_monodepth``), runs every image of a folder
through the encoder and decoder, and writes the ``<stem>_disp.npy`` files
the SR datasets read (the scaled disparity of ``disp_to_depth``, shape
[1, 1, H, W] at the networks' feed size, float32), with an optional MAGMA
preview ``<stem>_disp.jpeg``; :func:`evaluate_against_gt` scores depth
maps by the 7-metric protocol.

It runs on CUDA unless the caller passes ``device="cpu"``, and raises
without a CUDA device (``utils/device.py::resolve_device``); on CUDA it
turns TF32 off for the process, as the entry points do.

    python -c "from endosr_torch.depth.infer import run_folder; \\
        run_folder('frames/', 'weights_19/')"
"""

from __future__ import annotations

import glob as globlib
import os

import numpy as np
import torch

from endosr_torch.depth.layers import disp_to_depth
from endosr_torch.metrics.depth import compute_depth_errors
from endosr_torch.utils.device import resolve_device, true_fp32
from endosr_torch.utils.port_params import load_monodepth

__all__ = ["DepthPredictor", "run_folder", "evaluate_against_gt"]


class DepthPredictor:
    """monodepth2 ResNet encoder + depth decoder from ``model_path``, in
    fp32 on ``device`` (None: CUDA)."""

    def __init__(self, model_path: str, num_layers: int = 18, device=None):
        self.device = resolve_device(device)
        true_fp32(self.device)
        (self.encoder, self.decoder, self.feed_height,
         self.feed_width) = load_monodepth(model_path, num_layers, self.device)

    @torch.inference_mode()
    def predict_disp(self, image_rgb01: np.ndarray) -> np.ndarray:
        """HWC RGB [0, 1] float image → the sigmoid disparity [H, W] at the
        feed size (numpy fp32). The image is resized on the host with
        ``cv2.resize(INTER_LINEAR)``, as the JAX producer does."""
        import cv2

        resized = cv2.resize(image_rgb01, (self.feed_width, self.feed_height),
                             interpolation=cv2.INTER_LINEAR)
        x = torch.from_numpy(np.ascontiguousarray(
            resized.astype(np.float32).transpose(2, 0, 1)[None]))
        disp = self.decoder(self.encoder(x.to(self.device)))[("disp", 0)]
        return disp[0, 0].cpu().numpy()


def _image_paths(image_path: str, ext: str) -> list[str]:
    """The images ``run_folder`` reads, in its order: ``image_path`` itself
    if it is a file, else the folder's ``*.<ext>`` sorted, or, when there
    are none, its ``.jpg`` / ``.jpeg`` / ``.png`` files sorted."""
    if os.path.isfile(image_path):
        return [image_path]
    paths = sorted(globlib.glob(os.path.join(image_path, f"*.{ext}")))
    if not paths:
        paths = sorted(p for p in globlib.glob(os.path.join(image_path, "*"))
                       if p.lower().endswith((".jpg", ".jpeg", ".png")))
    return paths


def run_folder(image_path: str, model_path: str, output_dir: str | None = None,
               ext: str = "jpg", save_colormap: bool = True,
               min_depth: float = 0.1, max_depth: float = 100.0,
               device=None) -> list[str]:
    """Write ``<stem>_disp.npy`` (and, with ``save_colormap``, the MAGMA
    ``<stem>_disp.jpeg``) for every image of ``image_path`` into
    ``output_dir`` (default: beside the images). Returns the ``.npy``
    paths in the order written."""
    import cv2

    pred = DepthPredictor(model_path, device=device)
    paths = _image_paths(image_path, ext)
    out_dir = output_dir or (os.path.dirname(image_path)
                             if os.path.isfile(image_path) else image_path)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for p in paths:
        bgr = cv2.imread(p, cv2.IMREAD_COLOR)
        rgb = bgr[:, :, ::-1].astype(np.float32) / 255.0
        disp = pred.predict_disp(rgb)
        scaled_disp, _ = disp_to_depth(disp, min_depth, max_depth)
        stem = os.path.splitext(os.path.basename(p))[0]
        npy_path = os.path.join(out_dir, f"{stem}_disp.npy")
        np.save(npy_path, np.asarray(scaled_disp)[None, None])
        written.append(npy_path)
        if save_colormap:
            vmax = np.percentile(disp, 95)
            norm = np.clip(disp / max(vmax, 1e-8), 0, 1)
            cm = cv2.applyColorMap((norm * 255).astype(np.uint8),
                                   cv2.COLORMAP_MAGMA)
            cv2.imwrite(os.path.join(out_dir, f"{stem}_disp.jpeg"), cm)
    return written


def evaluate_against_gt(pred_depths: list[np.ndarray],
                        gt_depths: list[np.ndarray],
                        median_scaling: bool = True) -> dict[str, float]:
    """The 7 metrics averaged over image pairs, on the pixels where GT > 0,
    each prediction scaled by the ratio of the medians first with
    ``median_scaling`` (monodepth2's ``evaluate_depth.py`` protocol)."""
    accum = []
    for pred, gt in zip(pred_depths, gt_depths):
        mask = gt > 0
        p, g = pred[mask], gt[mask]
        if median_scaling:
            p = p * np.median(g) / np.median(p)
        accum.append(compute_depth_errors(g, p))
    return {k: float(np.mean([a[k] for a in accum])) for k in accum[0]}
