"""The datasets (counterpart of ``endosr/data/datasets.py``): the
flagship ``LQGTKerDepthDataset`` and ``EndoSceneDepthDataset``, the
EndoScene variant ``EndoSceneDepthnewDataset``, and the depth-free ones of
the other models — ``LQGTKerDataset`` (LR/GT pairs), ``LQDataset`` (LR
only), ``LQKerDataset`` (LR + real kernel code) and ``SRKerDataset`` (SR +
estimated kernel code) — and ``LRHRSegBGDataset``, SFT-GAN's images with
their segmentation maps and categories.

A sample is a dict of numpy arrays in NHWC order: 'LQ' and 'GT' HWC RGB
float32 in [0, 1] (uint8 with ``u8_pipeline``), 'Depth' HW1 float32,
'DepthMaskList' HWK float32 (uint8 with ``u8_pipeline``), and the
'LQ_path' and 'GT_path' strings. Depth maps are ``<stem>_disp.npy`` of
shape [1, 1, H, W] (monodepth2's convention).
"""

from __future__ import annotations

import os
import random

import numpy as np

from endosr_torch.data import util
from endosr_torch.ops.color import channel_convert, modcrop
from endosr_torch.ops.masks import depth_masks_np
from endosr_torch.ops.resize import imresize_np

__all__ = ["LQGTKerDepthDataset", "EndoSceneDepthDataset",
           "EndoSceneDepthnewDataset", "LQGTKerDataset", "LQDataset",
           "LQKerDataset", "SRKerDataset", "LRHRSegBGDataset"]


class _Base:
    def __init__(self, opt):
        self.opt = opt
        # augmentation draws; a loader's workers reseed it per epoch
        self.rng = random.Random()
        # ``cache_data``: decoded images and arrays kept in host memory
        self._cache = {} if opt.get("cache_data") else None
        self._envs: dict = {}            # LMDB environments by root
        self.GT_sizes = self.LR_sizes = None

    def _img(self, root, paths, sizes, index):
        """Image ``index`` from files or an LMDB archive (``data_type``)."""
        if self.opt["data_type"] == "lmdb":
            from endosr_torch.data.lmdb_io import open_lmdb

            env = self._envs.get(root)
            if env is None:
                env = self._envs[root] = open_lmdb(root)
            h, w, c = (int(s) for s in sizes[index].split("_"))
            return util.read_img(env, paths[index], (h, w, c))
        return self._read_img(paths[index])

    def _read_img(self, path):
        if self._cache is None:
            return util.read_img(None, path)
        img = self._cache.get(path)
        if img is None:
            img = self._cache[path] = util.read_img(None, path)
        return img

    def _load_npy(self, path):
        if self._cache is None:
            return np.load(path)
        arr = self._cache.get(path)
        if arr is None:
            arr = self._cache[path] = np.load(path)
        return arr

    def __len__(self):
        return len(self.GT_paths)

    def _is_train(self):
        return self.opt["phase"] == "train"

    @staticmethod
    def _rgb_u8(img_f32_bgr):
        """Decoded float32 BGR [0, 1] → RGB uint8 when that is exact (8-bit
        sources: (u / 255) · 255 == u in float32), else RGB float32."""
        rgb = util.bgr_to_rgb_f32(img_f32_bgr)
        u8 = (rgb * 255.0).astype(np.uint8)
        if np.array_equal(u8.astype(np.float32) / 255.0, rgb):
            return u8
        return rgb


class LQGTKerDepthDataset(_Base):
    """LR and GT pairs, the depth map and its K binary depth masks.

    With ``data_augment`` a second set of LR images (``<stem>_DA.jpg`` under
    ``dataroot_LQ_Aug``) is appended; without ``dataroot_LQ`` the LR image
    is made from GT with the MATLAB bicubic (:func:`imresize_np`).
    """

    def __init__(self, opt):
        super().__init__(opt)
        self.LR_paths = util.get_image_paths(opt["data_type"], opt.get("dataroot_LQ"))
        self.GT_paths = util.get_image_paths(opt["data_type"], opt.get("dataroot_GT"))
        if opt["data_type"] == "lmdb":
            if self.LR_paths is not None:
                self.LR_paths, self.LR_sizes = self.LR_paths
            self.GT_paths, self.GT_sizes = self.GT_paths

        if self._is_train() and opt.get("data_num"):
            if self.LR_paths:
                self.LR_paths = self.LR_paths[: opt["data_num"]]
            self.GT_paths = self.GT_paths[: opt["data_num"]]

        origin_LR_paths = list(self.LR_paths or [])
        if self._is_train() and opt.get("data_augment"):
            aug_paths = []
            for imagepath in self.LR_paths:
                imgname = os.path.basename(imagepath).split(".")[0] + "_DA.jpg"
                aug_paths.append(os.path.join(opt["dataroot_LQ_Aug"], imgname))
            self.LR_paths = self.LR_paths + aug_paths
            self.GT_paths = self.GT_paths + self.GT_paths

        base = origin_LR_paths if (self._is_train() and opt.get("data_augment")) else (
            self.LR_paths or self.GT_paths)
        self.Depth_paths = [
            os.path.join(opt["dataroot_depthMap"],
                         os.path.basename(p).split(".")[0] + "_disp.npy")
            for p in base]
        if self._is_train() and opt.get("data_augment"):
            self.Depth_paths = self.Depth_paths + self.Depth_paths

        if not self.GT_paths:
            raise ValueError("GT paths are empty")
        if self.LR_paths and not (len(self.LR_paths) == len(self.GT_paths)
                                  == len(self.Depth_paths)):
            raise ValueError(
                f"GT, LR and Depth datasets have different number of images - "
                f"{len(self.LR_paths)}, {len(self.GT_paths)}, {len(self.Depth_paths)}.")

    def _prepared_train(self, index):
        """The cached, fully prepared training sample (``cache_data``): RGB
        uint8 LR and GT, float32 depth, uint8 masks, so that a sample costs
        only its augmentation and the uint8 → float32 conversion. The
        channel reversal and the / 255 commute with the flips, so a batch
        equals the uncached path's bit for bit. None where the sample needs
        ``channel_convert`` (the slow path then serves it)."""
        key = ("prep", index)
        if key in self._cache:
            return self._cache[key]
        opt = self.opt
        scale = opt["scale"]
        lmdb = opt["data_type"] == "lmdb"

        img_GT = (self._img(opt.get("dataroot_GT"), self.GT_paths,
                            self.GT_sizes, index) if lmdb
                  else util.read_img(None, self.GT_paths[index]))
        if self.LR_paths:
            img_LR = (self._img(opt.get("dataroot_LQ"), self.LR_paths,
                                self.LR_sizes, index) if lmdb
                      else util.read_img(None, self.LR_paths[index]))
        else:
            img_LR = imresize_np(img_GT, 1 / scale, True)
            if img_LR.ndim == 2:
                img_LR = np.expand_dims(img_LR, axis=2)

        if (img_LR.ndim != 3 or img_LR.shape[2] != 3
                or img_GT.ndim != 3 or img_GT.shape[2] != 3):
            self._cache[key] = None
            return None
        depth_map = np.squeeze(np.load(self.Depth_paths[index]), axis=1)[0]
        mask_list = depth_masks_np(
            depth_map, opt.get("depthFixedRange", True),
            opt.get("depthMaskNum", 10))
        got = (self._rgb_u8(img_LR), self._rgb_u8(img_GT),
               np.ascontiguousarray(depth_map[..., None], np.float32),
               mask_list.astype(np.uint8))
        self._cache[key] = got
        return got

    def __getitem__(self, index):
        opt = self.opt
        scale = opt["scale"]

        prep = (self._prepared_train(index)
                if (self._cache is not None and self._is_train()
                    and opt.get("color") in (None, "RGB")) else None)
        if prep is not None:
            lr, gt, dep, masks = util.augment(
                list(prep), opt.get("use_flip", False),
                opt.get("use_rot", False), self.rng)
            paths = {"LQ_path": (self.LR_paths or self.GT_paths)[index],
                     "GT_path": self.GT_paths[index]}
            if opt.get("u8_pipeline"):
                # uint8 to the model, which divides by 255 exactly as here
                return {"LQ": np.ascontiguousarray(lr),
                        "GT": np.ascontiguousarray(gt),
                        "Depth": np.ascontiguousarray(dep, np.float32),
                        "DepthMaskList": np.ascontiguousarray(masks), **paths}
            return {"LQ": util.to_f32_01(lr), "GT": util.to_f32_01(gt),
                    "Depth": np.ascontiguousarray(dep, np.float32),
                    "DepthMaskList": np.ascontiguousarray(masks, np.float32),
                    **paths}

        GT_path = self.GT_paths[index]
        img_GT = self._img(opt.get("dataroot_GT"), self.GT_paths, self.GT_sizes,
                           index)
        if not self._is_train():
            img_GT = modcrop(img_GT, scale)

        if self.LR_paths:
            LR_path = self.LR_paths[index]
            img_LR = self._img(opt.get("dataroot_LQ"), self.LR_paths,
                               self.LR_sizes, index)
        else:
            LR_path = GT_path
            img_LR = imresize_np(img_GT, 1 / scale, True)
            if img_LR.ndim == 2:
                img_LR = np.expand_dims(img_LR, axis=2)

        depth_map = self._load_npy(self.Depth_paths[index])
        depth_map = np.squeeze(depth_map, axis=1)[0]          # [1,1,H,W] → HW
        mask_list = depth_masks_np(
            depth_map, opt.get("depthFixedRange", True),
            opt.get("depthMaskNum", 10))                      # HWK
        depth_map = depth_map[..., None].astype(np.float32)   # HW1

        if self._is_train():
            if opt["LR_size"] != opt["GT_size"] // scale:
                raise ValueError(f"GT_size {opt['GT_size']} does not match "
                                 f"LR_size {opt['LR_size']} at ×{scale}")
            img_LR, img_GT, depth_map, mask_list = util.augment(
                [img_LR, img_GT, depth_map, mask_list],
                opt.get("use_flip", False), opt.get("use_rot", False), self.rng)

        if opt.get("color"):
            img_LR = channel_convert(img_LR.shape[2], opt["color"], [img_LR])[0]
            img_GT = channel_convert(img_GT.shape[2], opt["color"], [img_GT])[0]

        return {"LQ": util.bgr_to_rgb_f32(img_LR),
                "GT": util.bgr_to_rgb_f32(img_GT),
                "Depth": np.ascontiguousarray(depth_map, np.float32),
                "DepthMaskList": np.ascontiguousarray(mask_list, np.float32),
                "LQ_path": LR_path, "GT_path": GT_path}


class EndoSceneDepthDataset(_Base):
    """CVC-EndoSceneStill: image names from the ``dataset_split_list`` text
    file (one a line; without it, every image under ``dataroot_GT``), LR
    images under ``dataroot_LQ/x<scale>/`` (or ``dataroot_LQ/`` itself when
    the first is not there; without an LR root, the MATLAB bicubic of GT),
    ``<stem>_disp.npy`` depth and, with ``dataroot_seglabel``, a one-hot
    polyp mask (pixels > 127) as 'SegLabel' / 'Seg_onehot' (HW2 float32)
    and 'Seg' (HW int64). Training takes whole frames (no crop), flipped
    and rotated; ``cache_data`` and ``u8_pipeline`` as for
    :class:`LQGTKerDepthDataset`. Validation and test crop GT to a multiple
    of the scale."""

    def __init__(self, opt):
        super().__init__(opt)
        scale = opt["scale"]
        split_list = opt.get("dataset_split_list")
        if split_list:
            with open(split_list) as f:
                names = [line.strip() for line in f if line.strip()]
        else:
            names = [os.path.basename(p)
                     for p in util.get_image_paths("img", opt["dataroot_GT"])]
        self.names = names
        self.GT_paths = [os.path.join(opt["dataroot_GT"], n) for n in names]
        lq_root = opt.get("dataroot_LQ")
        self.LR_paths = ([os.path.join(lq_root, f"x{scale}", n) for n in names]
                         if lq_root else None)
        if self.LR_paths and not os.path.exists(self.LR_paths[0]):
            self.LR_paths = [os.path.join(lq_root, n) for n in names]
        self.Depth_paths = [
            os.path.join(opt["dataroot_depthMap"],
                         n.split(".")[0] + "_disp.npy") for n in names]
        self.Seg_paths = None
        if opt.get("dataroot_seglabel"):
            self.Seg_paths = [os.path.join(opt["dataroot_seglabel"], n)
                              for n in names]

    def _seg(self, index):
        """The polyp mask of image ``index`` as integer labels (HW)."""
        import cv2

        raw = cv2.imread(self.Seg_paths[index], cv2.IMREAD_GRAYSCALE)
        return (raw > 127).astype(np.int64)

    def _prepared_train(self, index):
        """The cached training sample (``cache_data``): RGB uint8 LR and GT,
        float32 depth, uint8 masks and one-hot segmentation; None where an
        image is not 3-channel (the slow path then serves it)."""
        key = ("prep", index)
        if key in self._cache:
            return self._cache[key]
        opt = self.opt
        img_GT = util.read_img(None, self.GT_paths[index])
        if self.LR_paths:
            img_LR = util.read_img(None, self.LR_paths[index])
        else:
            img_LR = imresize_np(img_GT, 1 / opt["scale"], True)
        if (img_LR.ndim != 3 or img_LR.shape[2] != 3
                or img_GT.ndim != 3 or img_GT.shape[2] != 3):
            self._cache[key] = None
            return None
        depth_map = np.squeeze(np.load(self.Depth_paths[index]), axis=1)[0]
        mask_list = depth_masks_np(
            depth_map, opt.get("depthFixedRange", True),
            opt.get("depthMaskNum", 10))
        seg = None
        if self.Seg_paths is not None:
            seg = util.get_one_hot(self._seg(index), 2).astype(np.uint8)
        got = (self._rgb_u8(img_LR), self._rgb_u8(img_GT),
               np.ascontiguousarray(depth_map[..., None], np.float32),
               mask_list.astype(np.uint8), seg)
        self._cache[key] = got
        return got

    def _paths(self, index):
        return {"LQ_path": (self.LR_paths or self.GT_paths)[index],
                "GT_path": self.GT_paths[index]}

    @staticmethod
    def _seg_keys(seg):
        """'SegLabel' and its alias 'Seg_onehot' (one-hot, float32) and
        'Seg' (the labels, int64) of an HW2 one-hot array."""
        onehot = np.ascontiguousarray(seg, np.float32)
        return {"SegLabel": onehot, "Seg_onehot": onehot,
                "Seg": np.ascontiguousarray(np.argmax(onehot, axis=-1),
                                            np.int64)}

    def __getitem__(self, index):
        opt = self.opt
        scale = opt["scale"]
        prep = (self._prepared_train(index)
                if self._cache is not None and self._is_train() else None)
        if prep is not None:
            lr, gt, dep, masks, seg = prep
            arrays = util.augment(
                [lr, gt, dep, masks] + ([seg] if seg is not None else []),
                opt.get("use_flip", False), opt.get("use_rot", False),
                self.rng)
            u8 = bool(opt.get("u8_pipeline"))

            def im(x):
                return np.ascontiguousarray(x) if u8 else util.to_f32_01(x)

            out = {"LQ": im(arrays[0]), "GT": im(arrays[1]),
                   "Depth": np.ascontiguousarray(arrays[2], np.float32),
                   "DepthMaskList": np.ascontiguousarray(
                       arrays[3], None if u8 else np.float32),
                   **self._paths(index)}
            if seg is not None:
                out.update(self._seg_keys(arrays[4]))
            return out

        img_GT = self._read_img(self.GT_paths[index])
        if not self._is_train():
            img_GT = modcrop(img_GT, scale)
        if self.LR_paths:
            img_LR = self._read_img(self.LR_paths[index])
        else:
            img_LR = imresize_np(img_GT, 1 / scale, True)
        depth_map = np.squeeze(self._load_npy(self.Depth_paths[index]),
                               axis=1)[0]
        mask_list = depth_masks_np(
            depth_map, opt.get("depthFixedRange", True),
            opt.get("depthMaskNum", 10))
        depth_map = depth_map[..., None].astype(np.float32)
        seg = (util.get_one_hot(self._seg(index), 2)
               if self.Seg_paths is not None else None)
        arrays = [img_LR, img_GT, depth_map, mask_list] + (
            [seg] if seg is not None else [])
        if self._is_train():
            arrays = util.augment(arrays, opt.get("use_flip", False),
                                  opt.get("use_rot", False), self.rng)
        out = {"LQ": util.bgr_to_rgb_f32(arrays[0]),
               "GT": util.bgr_to_rgb_f32(arrays[1]),
               "Depth": np.ascontiguousarray(arrays[2], np.float32),
               "DepthMaskList": np.ascontiguousarray(arrays[3], np.float32),
               **self._paths(index)}
        if seg is not None:
            out.update(self._seg_keys(arrays[4]))
        return out


class EndoSceneDepthnewDataset(EndoSceneDepthDataset):
    """:class:`EndoSceneDepthDataset` whose depth maps are named from the
    image's stem (``<stem>_disp.npy``, a ``.tif`` frame's too) and come from
    the ×2 producer: a depth map of another size than the LR image is
    resized to it (``cv2`` bilinear) and its masks are rebuilt."""

    def __init__(self, opt):
        super().__init__(opt)
        self.Depth_paths = [os.path.join(opt["dataroot_depthMap"],
                                         n.split(".")[0] + "_disp.npy")
                            for n in self.names]

    def __getitem__(self, index):
        import cv2

        item = super().__getitem__(index)
        lr_h, lr_w = item["LQ"].shape[:2]
        d = item["Depth"][..., 0]
        if d.shape != (lr_h, lr_w):
            d = cv2.resize(d, (lr_w, lr_h), interpolation=cv2.INTER_LINEAR)
            item["DepthMaskList"] = depth_masks_np(
                d, self.opt.get("depthFixedRange", True),
                self.opt.get("depthMaskNum", 10))
            item["Depth"] = d[..., None].astype(np.float32)
        return item


class LQGTKerDataset(_Base):
    """LR + GT pairs without depth (the SR / SFTMD models): whole images
    (no crop), flipped and rotated when training; without an LR root the
    MATLAB bicubic of GT; validation and test crop GT to a multiple of the
    scale."""

    def __init__(self, opt):
        super().__init__(opt)
        self.LR_paths = util.get_image_paths(opt["data_type"],
                                             opt.get("dataroot_LQ"))
        self.GT_paths = util.get_image_paths(opt["data_type"],
                                             opt.get("dataroot_GT"))

    def __getitem__(self, index):
        opt = self.opt
        scale = opt["scale"]
        gt_path = self.GT_paths[index]
        img_GT = self._read_img(gt_path)
        if not self._is_train():
            img_GT = modcrop(img_GT, scale)
        if self.LR_paths:
            lr_path = self.LR_paths[index]
            img_LR = self._read_img(lr_path)
        else:
            lr_path = gt_path
            img_LR = imresize_np(img_GT, 1 / scale, True)
        if self._is_train():
            img_LR, img_GT = util.augment(
                [img_LR, img_GT], opt.get("use_flip", False),
                opt.get("use_rot", False), self.rng)
        return {"LQ": util.bgr_to_rgb_f32(img_LR),
                "GT": util.bgr_to_rgb_f32(img_GT),
                "LQ_path": lr_path, "GT_path": gt_path}


class LQDataset(_Base):
    """LR images alone (the kernel Predictor's input)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.LR_paths = util.get_image_paths(opt["data_type"],
                                             opt["dataroot_LQ"])
        self.GT_paths = self.LR_paths

    def __getitem__(self, index):
        path = self.LR_paths[index]
        return {"LQ": util.bgr_to_rgb_f32(self._read_img(path)),
                "LQ_path": path}


class LQKerDataset(LQDataset):
    """LR images and, given ``ker_map_list``, each one's real kernel code
    as 'real_ker'."""

    def __init__(self, opt, ker_map_list=None):
        super().__init__(opt)
        self.ker_map_list = ker_map_list

    def __getitem__(self, index):
        item = super().__getitem__(index)
        if self.ker_map_list is not None:
            item["real_ker"] = np.asarray(self.ker_map_list[index],
                                          np.float32)
        return item


class SRKerDataset(_Base):
    """SR images (``dataroot_SR``) and, given ``est_ker_map_list``, each
    one's estimated kernel code as 'est_ker_map' (the Corrector's
    input)."""

    def __init__(self, opt, est_ker_map_list=None):
        super().__init__(opt)
        self.SR_paths = util.get_image_paths(opt["data_type"],
                                             opt["dataroot_SR"])
        self.GT_paths = self.SR_paths
        self.est_ker_map_list = est_ker_map_list

    def __getitem__(self, index):
        path = self.SR_paths[index]
        item = {"SR": util.bgr_to_rgb_f32(util.read_img(None, path)),
                "SR_path": path}
        if self.est_ker_map_list is not None:
            item["est_ker_map"] = np.asarray(self.est_ker_map_list[index],
                                             np.float32)
        return item


class LRHRSegBGDataset(_Base):
    """SFT-GAN's data: HR images with 8-channel segmentation probability
    maps (``<stem>.npy``, HWC, under ``dataroot_seg``; all background
    where there is none), one item in ``ratio`` (10) a background image
    from ``dataroot_GT_bg`` with an all-background map, a random rescale
    (``cv2`` INTER_LINEAR for the image, INTER_NEAREST for the map) and
    MATLAB-bicubic LR in training, a paired crop and ``augment``, and the
    category from the path (the OST names, 1–7; 0 otherwise, −1 in
    validation). The draws from ``self.rng`` are the JAX dataset's, in its
    order, so an item equals JAX's at the same seed."""

    CATEGORIES = ("building", "plant", "mountain", "water", "sky", "grass",
                  "animal")

    def __init__(self, opt):
        super().__init__(opt)
        self.HR_paths = util.get_image_paths("img", opt["dataroot_GT"])
        self.GT_paths = self.HR_paths
        self.LR_paths = (util.get_image_paths("img", opt["dataroot_LR"])
                         if opt.get("dataroot_LR") else None)
        self.BG_paths = (util.get_image_paths("img", opt["dataroot_GT_bg"])
                         if opt.get("dataroot_GT_bg") else None)
        self.seg_root = opt.get("dataroot_seg")
        self.random_scale_list = [1, 0.9, 0.8, 0.7, 0.6, 0.5]
        self.ratio = 10

    @staticmethod
    def _background(shape):
        seg = np.zeros((shape[0], shape[1], 8), np.float32)
        seg[..., 0] = 1.0
        return seg

    def _load_seg(self, hr_path, shape):
        if self.seg_root:
            p = os.path.join(self.seg_root, os.path.basename(hr_path)
                             .rsplit(".", 1)[0] + ".npy")
            if os.path.exists(p):
                return np.load(p).astype(np.float32)
        return self._background(shape)

    def _rescale(self, img_hr, seg, scale, hr_size):
        import cv2

        rs = self.rng.choice(self.random_scale_list)

        def mod(n):
            r = (int(n * rs) // scale) * scale
            return hr_size if r < hr_size else r

        h_s, w_s = mod(img_hr.shape[0]), mod(img_hr.shape[1])
        img_hr = cv2.resize(np.copy(img_hr), (w_s, h_s),
                            interpolation=cv2.INTER_LINEAR)
        seg = cv2.resize(np.copy(seg), (w_s, h_s),
                         interpolation=cv2.INTER_NEAREST)
        return img_hr, seg

    def __getitem__(self, index):
        opt = self.opt
        scale = opt["scale"]
        hr_size = opt.get("HR_size") or opt.get("GT_size")
        train = self._is_train()

        use_bg = (train and self.BG_paths
                  and self.rng.randrange(self.ratio) == 0)
        if use_bg:
            HR_path = self.BG_paths[self.rng.randrange(len(self.BG_paths))]
            img_HR = util.read_img(None, HR_path)
            seg = self._background(img_HR.shape)
        else:
            HR_path = self.HR_paths[index]
            img_HR = util.read_img(None, HR_path)
            seg = self._load_seg(HR_path, img_HR.shape)
        if not train:
            img_HR = modcrop(img_HR, 8)
            seg = seg[: img_HR.shape[0], : img_HR.shape[1]]

        LR_path = None
        if self.LR_paths and not use_bg:
            LR_path = self.LR_paths[index]
            img_LR = self._read_img(LR_path)
        else:
            if train:
                img_HR, seg = self._rescale(img_HR, seg, scale, hr_size)
            img_LR = imresize_np(img_HR, 1 / scale, True)
            if img_LR.ndim == 2:
                img_LR = np.expand_dims(img_LR, axis=2)

        category = -1
        if train:
            lr_size = hr_size // scale
            h, w = img_LR.shape[:2]
            rnd_h = self.rng.randint(0, max(0, h - lr_size))
            rnd_w = self.rng.randint(0, max(0, w - lr_size))
            img_LR = img_LR[rnd_h:rnd_h + lr_size, rnd_w:rnd_w + lr_size]
            rh, rw = rnd_h * scale, rnd_w * scale
            img_HR = img_HR[rh:rh + hr_size, rw:rw + hr_size]
            seg = seg[rh:rh + hr_size, rw:rw + hr_size]
            img_LR, img_HR, seg = util.augment(
                [img_LR, img_HR, seg], opt.get("use_flip", False),
                opt.get("use_rot", False), self.rng)
            category = next((i for i, name in enumerate(self.CATEGORIES, 1)
                             if name in HR_path), 0)

        img_HR = util.bgr_to_rgb_f32(img_HR)
        img_LR = util.bgr_to_rgb_f32(img_LR)
        return {"LR": img_LR, "HR": img_HR, "GT": img_HR.copy(),
                "seg": np.ascontiguousarray(seg, np.float32),
                "category": np.int64(category),
                "LR_path": LR_path or HR_path, "HR_path": HR_path}
