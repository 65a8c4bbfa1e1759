"""The port's data layer against the JAX package's.

- ``read_img`` and ``save_img`` (``cv2``) against JAX's: grey, BGR and
  BGRA files in several formats, bit-equal.
- ``imresize_np`` at 1/2, 1/3, 1/4, 1/8 and ×4, the colour conversions,
  ``modcrop``, ``read_img``, ``augment`` and the other helpers: equal to
  JAX's (the same numpy arithmetic; ``augment``'s and ``bgr_to_rgb_f32``'s
  ``cv2`` calls in JAX are exact permutations).
- ``LQGTKerDepthDataset`` samples equal JAX's: training with ``cache_data``
  on and off, ``u8_pipeline`` on and off, with and without an LR root, flips
  and rotations under equally seeded ``rng``; validation with ``modcrop``;
  LMDB archives.
- ``EndoSceneDepthDataset`` (``EndoScene_Depth``) samples equal JAX's on a
  synthetic CVC-EndoSceneStill tree: names from the split file or the GT
  listing, the ``x3/`` LR subdirectory or the flat layout or no LR root,
  polyp masks, training cached or not and u8 or not, validation with
  ``modcrop``, and a worker's batches.
- The loader's batches come in ``ShardedLoader``'s order over two epochs for
  several seeds, ratios and shuffles; with one worker process, the batches
  (augmentation included) equal the JAX loader's one-worker batches.
- Each package's LMDB reader reads what the other's writer wrote.
- ``calculate_psnr`` / ``calculate_ssim`` equal JAX's.
"""

import pickle
import random

import cv2
import numpy as np
import pytest
import torch

import endosr.data as jdata
import endosr.data.lmdb_io as jlmdb
import endosr.data.util as jutil
import endosr.metrics.psnr_ssim as jmetrics
import endosr.ops.color as jcolor
import endosr.utils.misc as jmisc
from endosr.ops.resize import imresize_np as jax_imresize_np
import endosr_torch.data as tdata
import endosr_torch.data.lmdb_io as tlmdb
import endosr_torch.data.util as tutil
import endosr_torch.metrics.psnr_ssim as tmetrics
import endosr_torch.ops.color as tcolor
import endosr_torch.utils.misc as tmisc
from endosr_torch.ops.resize import imresize_np

SCALE, LR, N = 4, 12, 5


def _smooth(rng, h, w, c):
    """A smooth random uint8 image [h, w, c] (plus a little noise)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for _ in range(c):
        fx, fy, px = rng.uniform(0.05, 0.4, 3)
        out.append(np.sin(xx * fx + px) * np.cos(yy * fy) * 90 + 128)
    img = np.stack(out, -1) + rng.integers(0, 12, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------- resize, colour, helpers

@pytest.mark.parametrize("scale", [1 / 2, 1 / 3, 1 / 4, 1 / 8, 4],
                         ids=["half", "third", "quarter", "eighth", "x4"])
def test_imresize_np_equals_jax(scale):
    rng = np.random.default_rng(4)
    for img in (rng.random((48, 41, 3)), rng.random((24, 17))):
        img = img.astype(np.float32)
        got = imresize_np(img, scale)
        np.testing.assert_array_equal(got, jax_imresize_np(img, scale))
        assert got.dtype == np.float32


def test_colour_conversions_and_modcrop_equal_jax():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    f = rng.random((9, 7, 3))
    for img in (u8, f, f.astype(np.float32)):
        for only_y in (True, False):
            np.testing.assert_array_equal(tcolor.rgb2ycbcr(img, only_y),
                                          jcolor.rgb2ycbcr(img, only_y))
            np.testing.assert_array_equal(tcolor.bgr2ycbcr(img, only_y),
                                          jcolor.bgr2ycbcr(img, only_y))
        np.testing.assert_array_equal(tcolor.ycbcr2rgb(img), jcolor.ycbcr2rgb(img))
        for in_c, tar, x in ((3, "gray", img), (3, "y", img),
                             (1, "RGB", img[..., :1]), (3, "RGB", img)):
            for a, b in zip(tcolor.channel_convert(in_c, tar, [x]),
                            jcolor.channel_convert(in_c, tar, [x])):
                np.testing.assert_array_equal(a, b)
        for x in (img, img[..., 0]):
            np.testing.assert_array_equal(tcolor.modcrop(x, 4),
                                          jcolor.modcrop(x, 4))
    with pytest.raises(ValueError):
        tcolor.modcrop(u8[None], 2)


@pytest.mark.parametrize("c,ext", [
    (c, ext) for ext in (".png", ".bmp", ".jpg", ".tif") for c in (1, 3, 4)
    if not (c == 4 and ext == ".jpg")])        # JPEG has no alpha
def test_read_img_equals_jax(c, ext, tmp_path):
    img = _smooth(np.random.default_rng(6), 10, 13, c)
    path = str(tmp_path / f"x{ext}")
    assert cv2.imwrite(path, img[..., 0] if c == 1 else img)
    got = tutil.read_img(None, path)
    np.testing.assert_array_equal(got, jutil.read_img(None, path))
    assert got.shape == (10, 13, min(c, 3)) and got.dtype == np.float32


def test_read_img_names_an_unreadable_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="not readable"):
        tutil.read_img(None, str(tmp_path / "missing.png"))


@pytest.mark.parametrize("c", [1, 3], ids=["grey", "bgr"])
def test_save_img_writes_what_jax_writes(c, tmp_path):
    img = _smooth(np.random.default_rng(8), 9, 11, c)
    img = img[..., 0] if c == 1 else img
    tmisc.save_img(img, str(tmp_path / "port.png"))
    jmisc.save_img(img, str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED), img)


def test_augment_and_conversions_equal_jax():
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, (6, 5, 3), dtype=np.uint8),
              rng.random((6, 5, 3), dtype=np.float32),
              rng.random((6, 5, 1), dtype=np.float32),
              (rng.random((6, 5, 10)) > 0.5).astype(np.uint8)]
    for seed in range(12):
        for hflip, rot in ((True, True), (True, False), (False, True)):
            got = tutil.augment(arrays, hflip, rot, random.Random(seed))
            want = jutil.augment(arrays, hflip, rot, random.Random(seed))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    for x in arrays:
        np.testing.assert_array_equal(tutil.bgr_to_rgb_f32(x),
                                      jutil.bgr_to_rgb_f32(np.ascontiguousarray(x)))
        np.testing.assert_array_equal(tutil.to_f32_01(x), jutil.to_f32_01(x))
    lab = rng.integers(0, 4, (3, 5))
    np.testing.assert_array_equal(tutil.get_one_hot(lab, 4),
                                  jutil.get_one_hot(lab, 4))


# ---------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Kvasir-style tree written by cv2: train (GT 48², LR 12²) and val
    (GT 50×46, LR 12×11: modcrop cuts GT to 48×44), ``*_disp.npy`` depth."""
    root = tmp_path_factory.mktemp("kvasir_port")
    rng = np.random.default_rng(8)
    for split, (gh, gw), (lh, lw) in (("train", (48, 48), (LR, LR)),
                                      ("val", (50, 46), (12, 11))):
        for sub in ("HR", "LR", "D"):
            (root / sub / split).mkdir(parents=True)
        for i in range(N if split == "train" else 2):
            gt = _smooth(rng, gh, gw, 3)
            lr = cv2.resize(gt, (lw, lh), interpolation=cv2.INTER_AREA)
            cv2.imwrite(str(root / "HR" / split / f"im{i}.png"), gt)
            cv2.imwrite(str(root / "LR" / split / f"im{i}.png"), lr)
            np.save(root / "D" / split / f"im{i}_disp.npy",
                    rng.random((1, 1, lh, lw)).astype(np.float32))
    return root


def _dataset_opt(root, split="train", lr=True, **kw):
    opt = {"name": split, "mode": "LQGTker_Depth", "phase": split,
           "scale": SCALE, "data_type": "img",
           "dataroot_GT": str(root / "HR" / split),
           "dataroot_LQ": str(root / "LR" / split) if lr else None,
           "dataroot_depthMap": str(root / "D" / split),
           "GT_size": LR * SCALE, "LR_size": LR, "use_flip": True,
           "use_rot": True, "color": "RGB", "depthMaskNum": 10,
           "depthFixedRange": False, "batch_size": 2, "use_shuffle": True}
    opt.update(kw)
    return opt


def _assert_sample_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def _both(opt):
    return (tdata.create_dataset(dict(opt)), jdata.create_dataset(dict(opt)))


@pytest.mark.parametrize("lr", [True, False], ids=["lr_root", "lr_made"])
@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("cache", [True, False], ids=["cache", "nocache"])
def test_train_samples_equal_jax(tree, cache, u8, lr):
    got_ds, want_ds = _both(_dataset_opt(tree, lr=lr, cache_data=cache,
                                         u8_pipeline=u8))
    assert len(got_ds) == len(want_ds) == N
    got_ds.rng, want_ds.rng = random.Random(9), random.Random(9)
    for _ in range(2):
        for i in range(N):
            _assert_sample_equal(got_ds[i], want_ds[i])
    s = got_ds[0]
    assert s["LQ"].shape == (LR, LR, 3) and s["GT"].shape == (LR * SCALE,) * 2 + (3,)
    assert s["DepthMaskList"].shape == (LR, LR, 10)
    u8_out = np.uint8 if cache and u8 else np.float32
    assert s["GT"].dtype == u8_out
    # an LR image made by the bicubic is not 8-bit exact: it stays float32
    assert s["LQ"].dtype == (u8_out if lr else np.float32)


def test_val_samples_modcrop_and_equal_jax(tree):
    got_ds, want_ds = _both(_dataset_opt(tree, "val"))
    for i in range(len(want_ds)):
        s = got_ds[i]
        _assert_sample_equal(s, want_ds[i])
        assert s["GT"].shape == (48, 44, 3) and s["LQ"].shape == (12, 11, 3)


def test_lmdb_dataset_equals_jax_and_the_image_files(tree, tmp_path):
    opt = _dataset_opt(tree, "val")
    for key in ("GT", "LQ"):
        files = sorted((tree / ("HR" if key == "GT" else "LR") / "val").glob("*.png"))
        imgs = {f.stem: cv2.imread(str(f), cv2.IMREAD_UNCHANGED) for f in files}
        arch = str(tmp_path / f"{key}.lmdb")
        tlmdb.write_lmdb(arch, [(k.encode(), v.tobytes()) for k, v in imgs.items()])
        with open(f"{arch}/meta_info.pkl", "wb") as f:
            pickle.dump({"keys": list(imgs), "resolution": [
                "_".join(map(str, v.shape)) for v in imgs.values()]}, f)
        opt[f"dataroot_{key}"] = arch
    opt["data_type"] = "lmdb"
    got_ds, want_ds = _both(opt)
    files_ds = tdata.create_dataset(_dataset_opt(tree, "val"))
    for i in range(len(want_ds)):
        got = got_ds[i]
        _assert_sample_equal(got, want_ds[i])
        for k in ("LQ", "GT", "DepthMaskList"):
            np.testing.assert_array_equal(got[k], files_ds[i][k])


# ------------------------------------------------------------ EndoScene

ES_SCALE = 3
ES_NAMES = ["p3.png", "p0.png", "p2.png"]       # the split file's order


@pytest.fixture(scope="module")
def endoscene(tmp_path_factory):
    """A CVC-EndoSceneStill-style tree written by cv2: four frames a split
    (GT 50×46, so modcrop by 3 cuts validation GT to 48×45; LR 16×15 =
    ``imresize_np(GT, 1/3)`` under ``LR/<split>/x3/``, and a flat copy under
    ``LR_flat/<split>/``), ``<stem>_disp.npy`` depth, polyp masks, and a
    split file naming three of the train frames out of order."""
    root = tmp_path_factory.mktemp("endoscene")
    rng = np.random.default_rng(12)
    for split in ("train", "test"):
        for sub in (f"HR/{split}", f"LR/{split}/x{ES_SCALE}",
                    f"LR_flat/{split}", f"D/{split}", f"seg/{split}"):
            (root / sub).mkdir(parents=True)
        for i in range(4):
            gt = _smooth(rng, 50, 46, 3)
            lr = imresize_np(gt / 255.0, 1 / ES_SCALE)
            lr = np.clip(lr * 255.0, 0, 255).round().astype(np.uint8)
            name = f"p{i}.png"
            cv2.imwrite(str(root / "HR" / split / name), gt)
            cv2.imwrite(str(root / "LR" / split / f"x{ES_SCALE}" / name), lr)
            cv2.imwrite(str(root / "LR_flat" / split / name), lr)
            cv2.imwrite(str(root / "seg" / split / name),
                        (rng.random((50, 46)) > 0.7).astype(np.uint8) * 255)
            np.save(root / "D" / split / f"p{i}_disp.npy",
                    rng.random((1, 1) + lr.shape[:2]).astype(np.float32))
    (root / "train.txt").write_text("".join(n + "\n" for n in ES_NAMES))
    return root


def _endoscene_opt(root, split="train", lr="LR", split_list=True, seg=False,
                   **kw):
    opt = {"name": split, "mode": "EndoScene_Depth", "phase": split,
           "scale": ES_SCALE, "data_type": "img",
           "dataset_split_list": (str(root / "train.txt")
                                  if split_list else None),
           "dataroot_GT": str(root / "HR" / split),
           "dataroot_LQ": str(root / lr / split) if lr else None,
           "dataroot_depthMap": str(root / "D" / split),
           "dataroot_seglabel": str(root / "seg" / split) if seg else None,
           "use_flip": True, "use_rot": True, "depthMaskNum": 10,
           "depthFixedRange": False, "batch_size": 2}
    opt.update(kw)
    return opt


@pytest.mark.parametrize("seg", [False, True], ids=["no_seg", "seg"])
@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("cache", [True, False], ids=["cache", "nocache"])
def test_endoscene_train_samples_equal_jax(endoscene, cache, u8, seg):
    """Whole frames from the split file's names, flipped and rotated under
    equally seeded ``rng``: bit for bit JAX's, cached or not."""
    got_ds, want_ds = _both(_endoscene_opt(endoscene, cache_data=cache,
                                           u8_pipeline=u8, seg=seg))
    assert got_ds.names == want_ds.names == ES_NAMES
    assert got_ds.LR_paths[0].endswith(f"x{ES_SCALE}/p3.png")
    got_ds.rng, want_ds.rng = random.Random(4), random.Random(4)
    for _ in range(2):
        for i in range(len(want_ds)):
            _assert_sample_equal(got_ds[i], want_ds[i])
    s = got_ds[0]
    assert {s["GT"].shape[:2], s["LQ"].shape[:2]} <= {(50, 46), (46, 50),
                                                      (17, 16), (16, 17)}
    assert ("Seg" in s) == seg


@pytest.mark.parametrize("lr", ["LR", "LR_flat", None],
                         ids=["x3_subdir", "flat", "lr_made"])
def test_endoscene_val_samples_equal_jax(endoscene, lr):
    """Without a split file the names are the sorted GT listing; the LR
    root's ``x3/`` subdirectory, else the root itself, else the bicubic of
    GT; validation GT cut by modcrop."""
    got_ds, want_ds = _both(_endoscene_opt(endoscene, "test", lr=lr,
                                           split_list=False, seg=True))
    assert got_ds.names == want_ds.names == [f"p{i}.png" for i in range(4)]
    assert got_ds.LR_paths == want_ds.LR_paths
    for i in range(len(want_ds)):
        s = got_ds[i]
        _assert_sample_equal(s, want_ds[i])
        assert s["GT"].shape == (48, 45, 3) and s["Seg"].shape == (50, 46)


def test_endoscene_loader_batches_equal_jax(endoscene):
    """One worker process on each side, flips on (a rotated frame would
    not stack with an upright one: training takes whole, non-square
    frames): the same batches over two epochs."""
    dopt = _endoscene_opt(endoscene, cache_data=True, u8_pipeline=True,
                          n_workers=1, use_rot=False)
    opt = {"train": {"manual_seed": 3}}
    got = tdata.create_dataloader(tdata.create_dataset(dict(dopt)), dopt, opt)
    want = jdata.create_dataloader(jdata.create_dataset(dict(dopt)), dopt, opt)
    for epoch in range(2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        pairs = list(zip(got, want, strict=True))
        assert len(pairs) == len(ES_NAMES) // 2
        for g, w in pairs:
            assert g.keys() == w.keys()
            for k, v in w.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(g[k].numpy(), v, err_msg=k)
                else:
                    assert g[k] == v


@pytest.mark.parametrize("mode", ["EndoScene_Depthnew",
                                  "LQ", "LQGTker", "SRker", "LQker",
                                  "LRHR_seg_bg"])
def test_dataset_modes_build_their_class(mode, tmp_path):
    """Every mode is ported and builds its class (the items are held to
    JAX's in ``tests/test_torch_models_data.py`` and, ``LRHR_seg_bg``'s,
    ``tests/test_torch_gan_sft.py``); an unknown mode raises by name."""
    with pytest.raises(NotImplementedError, match="Nope"):
        tdata.create_dataset({"mode": "Nope"})
    cv2.imwrite(str(tmp_path / "a.png"), np.zeros((8, 8, 3), np.uint8))
    np.save(tmp_path / "a_disp.npy", np.ones((1, 1, 8, 8), np.float32))
    opt = {"mode": mode, "phase": "test", "data_type": "img", "scale": 2,
           "dataroot_GT": str(tmp_path), "dataroot_LQ": str(tmp_path),
           "dataroot_SR": str(tmp_path), "dataroot_depthMap": str(tmp_path)}
    assert type(tdata.create_dataset(opt)).__name__ == tdata.MODES[mode]


# ----------------------------------------------------------------- loaders

class _Len:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "ordered"])
@pytest.mark.parametrize("ratio", [1, 3])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_batch_order_equals_sharded_loader(seed, ratio, shuffle):
    n, bs = 7, 2
    got = tdata.EpochBatchSampler(n, bs, shuffle, seed, ratio, drop_last=True)
    want = jdata.ShardedLoader(_Len(n), bs, shuffle, seed, ratio,
                               drop_last=True)
    assert len(got) == len(want)
    for epoch in range(2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        idx = want._indices()
        np.testing.assert_array_equal(got.indices(), idx)
        assert list(got) == [idx[i * bs:(i + 1) * bs].tolist()
                             for i in range(len(want))]


def test_val_loader_is_batch_one_in_order(tree):
    ds = tdata.create_dataset(_dataset_opt(tree, "val"))
    batches = list(tdata.create_dataloader(ds, _dataset_opt(tree, "val")))
    assert len(batches) == len(ds) == 2
    for i, b in enumerate(batches):
        assert b["LQ_path"] == [ds.LR_paths[i]] and b["LQ"].shape[0] == 1
        assert torch.equal(b["GT"][0], torch.from_numpy(ds[i]["GT"]))


@pytest.mark.parametrize("cache_u8", [True, False], ids=["cache_u8", "plain"])
def test_one_worker_batches_equal_jax(tree, cache_u8):
    """One worker process on each side, flips and rotations on: the same
    batches, augmentation included, over two epochs (each reseeds its
    worker from the seed and the epoch)."""
    dopt = _dataset_opt(tree, n_workers=1, cache_data=cache_u8,
                        u8_pipeline=cache_u8)
    opt = {"train": {"manual_seed": 4}}
    got = tdata.create_dataloader(tdata.create_dataset(dict(dopt)), dopt, opt)
    want = jdata.create_dataloader(jdata.create_dataset(dict(dopt)), dopt, opt)
    assert len(got) == len(want) == N // 2
    for epoch in range(2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        pairs = list(zip(got, want, strict=True))
        assert len(pairs) == N // 2
        for g, w in pairs:
            assert g.keys() == w.keys()
            for k, v in w.items():
                if isinstance(v, np.ndarray):
                    assert isinstance(g[k], torch.Tensor)
                    np.testing.assert_array_equal(g[k].numpy(), v, err_msg=k)
                else:
                    assert g[k] == v


# -------------------------------------------------------- LMDB, metrics

def test_lmdb_each_package_reads_the_other(tmp_path):
    rng = np.random.default_rng(10)
    items = [(f"key-{i:04d}".encode(),
              rng.integers(0, 256, 9000 if i % 5 == 0 else 40,
                           dtype=np.uint8).tobytes()) for i in range(400)]
    for writer, reader, name in ((tlmdb, jlmdb, "port"), (jlmdb, tlmdb, "jax")):
        path = str(tmp_path / f"{name}.lmdb")
        assert writer.write_lmdb(path, items) == len(items)
        r = reader.Reader(path)
        with r.begin(write=False) as txn:
            for k, v in items:
                assert txn.get(k) == v
            assert txn.get(b"missing") is None
        assert r.keys() == [k for k, _ in items]
        r.close()
    assert ((tmp_path / "port.lmdb" / "data.mdb").read_bytes()
            == (tmp_path / "jax.lmdb" / "data.mdb").read_bytes())


@pytest.mark.parametrize("shape", [(40, 37), (40, 37, 1), (40, 37, 3)])
def test_psnr_and_ssim_equal_jax(shape):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-9, 10, shape), 0, 255)
    for x, y in ((a, b.astype(np.uint8)), (a.astype(np.float64), b * 1.0)):
        assert tmetrics.calculate_psnr(x, y) == jmetrics.calculate_psnr(x, y)
        assert tmetrics.calculate_ssim(x, y) == jmetrics.calculate_ssim(x, y)
    assert tmetrics.calculate_psnr(a, a) == float("inf")
    assert tmetrics.calculate_ssim(a, a) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        tmetrics.calculate_ssim(a, a[:-1])
