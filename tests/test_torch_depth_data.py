"""The port's depth-trainer data, options and evaluation
(``endosr_torch/depth/{datasets,kitti,options,train,evaluate}.py``)
against the JAX package's, on the CPU.

- Items of ``SequenceFolderDataset``, ``EndovisDataset`` (stereo ``l`` /
  ``r`` sides, GT depth PNGs, the centre crop) and the three KITTI
  datasets are equal, key for key and bit for bit, with flips and colour
  jitter drawn from equal ``random.Random`` seeds; so are the velodyne
  projection and the calibration reader.
- Both option parsers give the same namespace (but the two packages'
  default paths) with and without flags.
- ``build_dataset`` picks the same class and frames.
- The trainer's loader with no workers gives JAX's ``run_epoch`` batches
  (the global ``np.random`` seeded as the port's ``RandomState``); with
  two spawned workers kept over two epochs, the same batches twice.
- ``batch_post_process_disparity``, ``compute_ate``, ``evaluate_pose``
  and ``evaluate_depth`` (median scaling, flip post-processing) equal
  JAX's.
"""

import os
import random

import cv2
import numpy as np
import pytest

from endosr.depth import datasets as JD
from endosr.depth import evaluate as JE
from endosr.depth import kitti as JK
from endosr.depth import options as JO
from endosr.depth import train as JT
from endosr_torch.depth import datasets as TD
from endosr_torch.depth import evaluate as TE
from endosr_torch.depth import kitti as TK
from endosr_torch.depth import options as TO
from endosr_torch.depth import train as TT
from tests.torch_depth_common import write_sequence
from tests.torch_threads import one_torch_thread  # noqa: F401


def _items_equal(a, b):
    assert sorted(map(str, a)) == sorted(map(str, b))
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def _same_items(jds, tds, seed, n=None):
    jds.rng, tds.rng = random.Random(seed), random.Random(seed)
    for i in range(n or len(jds)):
        _items_equal(jds[i], tds[i])


@pytest.mark.parametrize("is_train", [True, False])
def test_sequence_folder_items_match_jax(tmp_path, is_train):
    write_sequence(str(tmp_path), n=8, h=70, w=90)
    args = (str(tmp_path), [str(i) for i in range(1, 7)], 32, 64, [0, -1, 1])
    kw = dict(num_scales=4, is_train=is_train)
    jds, tds = JD.SequenceFolderDataset(*args, **kw), \
        TD.SequenceFolderDataset(*args, **kw)
    _same_items(jds, tds, 3)
    item = tds[0]
    assert item[("color", -1, 3)].shape == (4, 8, 3)
    assert item[("K", 2)].shape == (4, 4)


def _write_endovis(root, n=6, hw=(60, 100), depth=True):
    rng = np.random.default_rng(1)
    base = (rng.random((*hw, 3)) * 255).astype(np.uint8)
    for cam in (1, 2):
        d = os.path.join(root, "seq", f"image0{cam}")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            cv2.imwrite(os.path.join(d, f"{i:010d}.png"),
                        np.roll(base, i * 2 + 3 * cam, axis=1))
    os.makedirs(os.path.join(root, "seq", "depth"), exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(root, "seq", f"{i:010d}.png"),
                    np.roll(base, i * 2, axis=1))
        if depth:
            cv2.imwrite(os.path.join(root, "seq", "depth", f"{i:010d}.png"),
                        (rng.random(hw) * 60000).astype(np.uint16))


def test_endovis_items_match_jax(tmp_path):
    _write_endovis(str(tmp_path))
    for lines, fids in (([f"seq {i} l" for i in range(1, 5)]
                         + ["seq 2 r"], [0, -1, 1, "s"]),
                        ([f"seq {i}" for i in range(1, 5)], [0, -1, 1])):
        args = (str(tmp_path), lines, 32, 40, fids)
        kw = dict(num_scales=4, is_train=True, img_ext=".png")
        jds, tds = JD.EndovisDataset(*args, **kw), TD.EndovisDataset(*args, **kw)
        assert tds.check_depth() and jds.check_depth()
        _same_items(jds, tds, 5)
        assert tds[0]["depth_gt"].shape == (32, 40, 1)
    stereo = TD.EndovisDataset(str(tmp_path), ["seq 1 l", "seq 1 r"], 32, 40,
                               [0, "s"], img_ext=".png")
    assert stereo[0]["stereo_T"][0, 3] == pytest.approx(-0.1)
    assert stereo[1]["stereo_T"][0, 3] == pytest.approx(0.1)
    plain = TD.EndovisDataset(str(tmp_path), ["seq 1"], 32, 40, [0],
                              img_ext=".png")[0]
    assert plain["depth_gt"].shape == (32, 40, 1)


def _write_calib(d, h, w):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"S_rect_02: {w}.0 {h}.0\n")
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        f.write(f"P_rect_02: 10 0 {w / 2} 0 0 10 {h / 2} 0 0 0 1 0\n")
        f.write(f"P_rect_03: 10 0 {w / 2} -5.4 0 10 {h / 2} 0 0 0 1 0\n")
        f.write("some_text_key: not a number\n")
    with open(os.path.join(d, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\n")
        f.write("T: 0 0 0\n")


def _write_kitti(root, h=16, w=32):
    folder = "2011_01_01/drive_0001"
    rng = np.random.default_rng(2)
    for cam in (2, 3):
        for sub in (f"{folder}/image_0{cam}/data", f"sequences/03/image_{cam}",
                    f"{folder}/proj_depth/groundtruth/image_0{cam}"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(4):
            img = rng.integers(0, 255, (h * 4, w * 4, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(root, folder, f"image_0{cam}", "data",
                                     f"{i:010d}.png"), img)
            cv2.imwrite(os.path.join(root, "sequences/03", f"image_{cam}",
                                     f"{i:06d}.png"), img)
            cv2.imwrite(os.path.join(
                root, folder, "proj_depth/groundtruth", f"image_0{cam}",
                f"{i:010d}.png"), rng.integers(0, 20000, (h, w), dtype=np.uint16))
    _write_calib(os.path.join(root, "2011_01_01"), h, w)
    vd = os.path.join(root, folder, "velodyne_points", "data")
    os.makedirs(vd)
    for i in range(4):
        pts = rng.uniform([-1, -1, -0.5], [9, 1, 0.5], (40, 3))
        np.concatenate([pts, np.ones((40, 1))], 1).astype(np.float32).tofile(
            os.path.join(vd, f"{i:010d}.bin"))
    return folder


@pytest.mark.parametrize("cls", ["KITTIRAWDataset", "KITTIOdomDataset",
                                 "KITTIDepthDataset"])
def test_kitti_items_match_jax(tmp_path, cls):
    folder = _write_kitti(str(tmp_path))
    if cls == "KITTIOdomDataset":
        lines = ["3 1 l", "3 2 r"]
    else:
        lines = [f"{folder} 1 l", f"{folder} 2 r"]
    args = (str(tmp_path), lines, 32, 64, [0, -1, 1, "s"])
    kw = dict(num_scales=2, is_train=True, img_ext=".png")
    jds, tds = getattr(JK, cls)(*args, **kw), getattr(TK, cls)(*args, **kw)
    _same_items(jds, tds, 7)
    assert ("depth_gt" in tds[0]) == (cls != "KITTIOdomDataset")


def test_velodyne_projection_matches_jax(tmp_path):
    folder = _write_kitti(str(tmp_path))
    calib = os.path.join(str(tmp_path), "2011_01_01")
    velo = os.path.join(str(tmp_path), folder, "velodyne_points", "data",
                        f"{1:010d}.bin")
    for cam, vel_depth in ((2, False), (3, True)):
        want = JK.generate_depth_map(calib, velo, cam, vel_depth)
        got = TK.generate_depth_map(calib, velo, cam, vel_depth)
        np.testing.assert_array_equal(got, want)
        assert (got > 0).sum() > 0
    c = TK.read_calib_file(os.path.join(calib, "calib_cam_to_cam.txt"))
    assert c["some_text_key"] == "not a number"
    np.testing.assert_array_equal(
        c["P_rect_02"], JK.read_calib_file(
            os.path.join(calib, "calib_cam_to_cam.txt"))["P_rect_02"])


@pytest.mark.parametrize("argv", [[], [
    "--height", "64", "--width", "96", "--batch_size", "2", "--frame_ids",
    "0", "-1", "1", "--scales", "0", "2", "--use_stereo", "--pose_model_type",
    "posecnn", "--v1_multiscale", "--no_ssim", "--num_layers", "50",
    "--models_to_load", "encoder", "depth", "--learning_rate", "3e-4",
    "--no_cuda", "--num_workers", "0"]])
def test_options_parse_as_jax(argv):
    j = vars(JO.MonodepthOptions().parse(argv))
    t = vars(TO.MonodepthOptions().parse(argv))
    for k in ("data_path", "log_dir"):          # under each package's folder
        assert os.path.basename(t.pop(k)) == os.path.basename(j.pop(k))
    assert t == j
    if not argv:
        assert (t["height"], t["width"], t["batch_size"], t["num_layers"],
                t["frame_ids"], t["scales"], t["learning_rate"],
                t["pose_model_type"]) == (256, 320, 12, 18, [0, -1, 1],
                                          [0, 1, 2, 3], 1e-4,
                                          "separate_resnet")


def test_build_dataset_matches_jax(tmp_path):
    write_sequence(str(tmp_path), n=7, names="{}.jpg")
    argv = ["--data_path", str(tmp_path), "--height", "32", "--width", "64"]
    j = JT.build_dataset(JO.MonodepthOptions().parse(argv))
    t = TT.build_dataset(TO.MonodepthOptions().parse(argv))
    assert type(t).__name__ == type(j).__name__ == "SequenceFolderDataset"
    assert t.filenames == j.filenames == [str(i) for i in range(1, 6)]
    assert t.is_train and t.num_scales == 4
    _same_items(j, t, 11, n=2)


def _loader_trainer(tmp_path, workers, seed=4):
    from endosr_torch.depth.trainer import Trainer

    opts = TO.MonodepthOptions().parse([
        "--no_cuda", "--data_path", str(tmp_path), "--log_dir",
        str(tmp_path / "logs"), "--height", "32", "--width", "64",
        "--batch_size", "2", "--num_workers", str(workers)])
    ds = TT.build_dataset(opts)
    ds.rng = random.Random(9)
    return Trainer(opts, dataset=ds, seed=seed), ds


def test_loader_gives_jax_batches(tmp_path):
    write_sequence(str(tmp_path), n=9, h=50, w=90)
    tr, ds = _loader_trainer(tmp_path, 0)
    jds = JD.SequenceFolderDataset(ds.data_path, ds.filenames, 32, 64,
                                   [0, -1, 1], num_scales=4, is_train=True)
    jds.rng = random.Random(9)
    np.random.seed(4)
    for epoch in range(2):
        order = np.random.permutation(len(jds))   # JAX's run_epoch
        got = list(tr.loader())
        assert len(got) == len(jds) // 2 == 3
        for n, batch in enumerate(got):
            items = [jds[int(i)] for i in order[2 * n:2 * n + 2]]
            for k in items[0]:
                np.testing.assert_array_equal(
                    batch[k].numpy(), np.stack([it[k] for it in items]),
                    err_msg=f"epoch {epoch} batch {n} {k}")


def test_loader_with_workers_repeats(tmp_path):
    write_sequence(str(tmp_path), n=9, h=50, w=90)
    runs = []
    for _ in range(2):
        tr, _ = _loader_trainer(tmp_path, 2)
        runs.append([b for _ in range(2) for b in tr.loader()])
        tr.close()
    assert len(runs[0]) == 6
    for a, b in zip(*runs):
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


def test_evaluate_helpers_match_jax():
    rng = np.random.default_rng(1)
    l, r = rng.random((2, 3, 16, 20)).astype(np.float32)
    np.testing.assert_array_equal(TE.batch_post_process_disparity(l, r),
                                  JE.batch_post_process_disparity(l, r))
    gt = np.cumsum(rng.random((5, 3)), axis=0)
    pred = gt + 0.05 * rng.standard_normal(gt.shape)
    assert TE.compute_ate(gt, pred) == JE.compute_ate(gt, pred)
    assert TE.compute_ate(gt, gt.copy()) == pytest.approx(0.0, abs=1e-12)

    def pose(a, b):
        t = np.eye(4)
        t[:3, 3] = (b - a).mean(axis=(0, 1))
        return t

    frames = [rng.random((4, 4, 3)) for _ in range(8)]
    pairs = list(zip(frames[:-1], frames[1:]))
    gt_poses = np.stack([np.eye(4)] * 8)
    gt_poses[:, :3, 3] = np.cumsum(rng.random((8, 3)) * 0.1, axis=0)
    assert TE.evaluate_pose(pose, pairs, gt_poses) == \
        JE.evaluate_pose(pose, pairs, gt_poses)


@pytest.mark.parametrize("post_process,median", [(False, True), (True, False)])
def test_evaluate_depth_matches_jax(tmp_path, post_process, median):
    _write_endovis(str(tmp_path))
    lines = [f"seq {i}" for i in range(1, 5)]
    args = (str(tmp_path), lines, 32, 40, [0])
    kw = dict(num_scales=1, img_ext=".png")

    def predictor(img):
        return 0.05 + img.mean(-1) * np.linspace(0.5, 1.5, img.shape[1])

    want = JE.evaluate_depth(predictor, JD.EndovisDataset(*args, **kw),
                             post_process, median, max_depth=60000.0)
    got = TE.evaluate_depth(predictor, TD.EndovisDataset(*args, **kw),
                            post_process, median, max_depth=60000.0)
    assert got == want
    assert len(got) == 7 + median and all(np.isfinite(list(got.values())))
