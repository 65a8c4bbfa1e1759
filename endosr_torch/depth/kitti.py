"""KITTI loaders of the depth trainer (counterpart of
``endosr/depth/kitti.py``; host numpy).

Velodyne points, the calibration files and their projection into a
sparse depth map (duplicate pixels keep the closest return, one
``np.minimum.at`` scatter), then the raw, odometry and improved-GT
datasets. Split lines are ``<folder> <frame> <side>``.
"""

from __future__ import annotations

import os

import numpy as np

from endosr_torch.depth.datasets import MonoDataset

__all__ = [
    "load_velodyne_points", "read_calib_file", "generate_depth_map",
    "KITTIRAWDataset", "KITTIOdomDataset", "KITTIDepthDataset",
]


def load_velodyne_points(filename: str) -> np.ndarray:
    """KITTI velodyne .bin → homogeneous [N,4] points (``kitti_utils.py:8-15``)."""
    points = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def read_calib_file(path: str) -> dict:
    """KITTI calib txt → dict of float arrays (``kitti_utils.py:18-37``)."""
    float_chars = set("0123456789.e+- ")
    data: dict = {}
    with open(path) as f:
        for line in f:
            key, value = line.split(":", 1)
            value = value.strip()
            data[key] = value
            if float_chars.issuperset(value):
                try:
                    data[key] = np.array([float(v) for v in value.split()])
                except ValueError:
                    pass
    return data


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Project velodyne points into the camera → sparse depth map
    (``kitti_utils.py:46-103``; duplicate pixels keep the closest return)."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    v2c = np.hstack((velo2cam["R"].reshape(3, 3), velo2cam["T"][:, None]))
    v2c = np.vstack((v2c, np.array([0, 0, 0, 1.0])))

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)

    r_rect = np.eye(4)
    r_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    p_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    p_velo2im = p_rect @ r_rect @ v2c

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0]

    pts = (p_velo2im @ velo.T).T
    pts[:, :2] = pts[:, :2] / pts[:, 2:3]
    if vel_depth:
        pts[:, 2] = velo[:, 0]

    # −1 matches the KITTI matlab rounding convention
    pts[:, 0] = np.round(pts[:, 0]) - 1
    pts[:, 1] = np.round(pts[:, 1]) - 1
    ok = (pts[:, 0] >= 0) & (pts[:, 1] >= 0)
    ok &= (pts[:, 0] < im_shape[1]) & (pts[:, 1] < im_shape[0])
    pts = pts[ok]

    depth = np.full(tuple(im_shape[:2]), np.inf, np.float64)
    np.minimum.at(depth, (pts[:, 1].astype(np.int64),
                          pts[:, 0].astype(np.int64)), pts[:, 2])
    depth[~np.isfinite(depth)] = 0
    depth[depth < 0] = 0
    return depth


class _KITTIBase(MonoDataset):
    K = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    full_res_shape = (1242, 375)
    side_map = {"2": 2, "3": 3, "l": 2, "r": 3}

    def _parse(self, line: str, other_side: bool):
        parts = line.split()
        folder = parts[0]
        frame = int(parts[1]) if len(parts) > 1 else 0
        side = parts[2] if len(parts) == 3 else "l"
        if other_side:
            side = {"l": "r", "r": "l"}[side]
        return folder, frame, side

    def get_image_path(self, folder, frame, side):
        raise NotImplementedError

    def get_color(self, line: str, frame_offset: int,
                  other_side: bool = False) -> np.ndarray:
        import cv2

        folder, frame, side = self._parse(line, other_side)
        p = self.get_image_path(folder, frame + frame_offset, side)
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(p)
        return img[:, :, ::-1].astype(np.float32) / 255.0


class KITTIRAWDataset(_KITTIBase):
    """Raw KITTI with velodyne GT (``kitti_dataset.py:57-85``)."""

    def get_image_path(self, folder, frame, side):
        return os.path.join(self.data_path, folder,
                            f"image_0{self.side_map[side]}", "data",
                            f"{frame:010d}{self.img_ext}")

    def check_depth(self) -> bool:
        folder, frame, _ = self._parse(self.filenames[0], False)
        return os.path.isfile(os.path.join(
            self.data_path, folder, "velodyne_points", "data",
            f"{frame:010d}.bin"))

    def get_depth(self, line: str):
        import cv2

        folder, frame, side = self._parse(line, False)
        calib = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(self.data_path, folder, "velodyne_points",
                            "data", f"{frame:010d}.bin")
        depth = generate_depth_map(calib, velo, self.side_map[side])
        return cv2.resize(depth.astype(np.float32), self.full_res_shape,
                          interpolation=cv2.INTER_NEAREST)


class KITTIOdomDataset(_KITTIBase):
    """KITTI odometry sequences (``kitti_dataset.py:88-103``)."""

    def get_image_path(self, folder, frame, side):
        return os.path.join(self.data_path, f"sequences/{int(folder):02d}",
                            f"image_{self.side_map[side]}",
                            f"{frame:06d}{self.img_ext}")


class KITTIDepthDataset(_KITTIBase):
    """KITTI with the improved GT depth PNGs (``kitti_dataset.py:106-140``)."""

    def get_image_path(self, folder, frame, side):
        return os.path.join(self.data_path, folder,
                            f"image_0{self.side_map[side]}", "data",
                            f"{frame:010d}{self.img_ext}")

    def check_depth(self) -> bool:
        folder, frame, side = self._parse(self.filenames[0], False)
        return os.path.isfile(os.path.join(
            self.data_path, folder, "proj_depth/groundtruth",
            f"image_0{self.side_map[side]}", f"{frame:010d}.png"))

    def get_depth(self, line: str):
        import cv2

        folder, frame, side = self._parse(line, False)
        p = os.path.join(self.data_path, folder, "proj_depth/groundtruth",
                         f"image_0{self.side_map[side]}", f"{frame:010d}.png")
        d = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        d = cv2.resize(d, self.full_res_shape,
                       interpolation=cv2.INTER_NEAREST)
        return d.astype(np.float32) / 256.0
