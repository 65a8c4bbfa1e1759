"""The port's data scripts (``endosr_torch/scripts/``) against the
repository's JAX scripts (``scripts/``), on small seeded folders written
with ``cv2``: each function writes the files the JAX script writes —
images decoded equal (the kernel heat map within one level, since the two
packages' fp32 kernels may differ in the last bit), arrays and pickles
equal — and each ``main`` takes the JAX script's arguments."""

import importlib.util
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return importlib.import_module(f"endosr_torch.scripts.{name}")


def _images(folder, n=3, seed=0, shape=(52, 60, 3), ext=".png"):
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        cv2.imwrite(os.path.join(folder, f"im{i}{ext}"), img)
    return folder


def _same_tree(a, b, lsb=0):
    import cv2

    fa = sorted(p.relative_to(a) for p in Path(a).rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in Path(b).rglob("*") if p.is_file())
    assert fa == fb and fa
    for rel in fa:
        pa, pb = Path(a) / rel, Path(b) / rel
        if rel.suffix == ".png":
            x = cv2.imread(str(pa), cv2.IMREAD_UNCHANGED).astype(np.int64)
            y = cv2.imread(str(pb), cv2.IMREAD_UNCHANGED).astype(np.int64)
            assert x.shape == y.shape and int(np.abs(x - y).max()) <= lsb, rel
        elif rel.suffix == ".npz":
            with np.load(pa) as x, np.load(pb) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    assert np.array_equal(x[k], y[k]), (rel, k)
        elif rel.suffix == ".pkl":
            assert pickle.loads(pa.read_bytes()) == pickle.loads(
                pb.read_bytes())
        else:
            assert pa.read_bytes() == pb.read_bytes(), rel


def test_kernel_visual_matches_jax(tmp_path):
    for tag, mod in (("jax", _jax_script("kernel_visual")),
                     ("port", _port("kernel_visual"))):
        (tmp_path / tag).mkdir()
        mod.visualize_kernel(str(tmp_path / tag / "k.png"), 21, 2.6)
    _same_tree(tmp_path / "jax", tmp_path / "port", lsb=1)
    _port("kernel_visual").main(["--out", str(tmp_path / "m.png"), "--l",
                                 "15", "--sig", "1.5"])
    assert (tmp_path / "m.png").exists()


@pytest.mark.parametrize("scale,mod_scale", [(4, None), (3, 6)])
def test_generate_mod_lr_bic_matches_jax(tmp_path, scale, mod_scale):
    src = _images(str(tmp_path / "src"))
    for tag, mod in (("jax", _jax_script("generate_mod_LR_bic")),
                     ("port", _port("generate_mod_LR_bic"))):
        assert mod.generate_mod_lr_bic(src, str(tmp_path / tag), scale,
                                       mod_scale) == 3
    _same_tree(tmp_path / "jax", tmp_path / "port")


def test_back_projection_matches_jax(tmp_path):
    sr = _images(str(tmp_path / "sr"), 2, 1, (32, 40, 3))
    lr = _images(str(tmp_path / "lr"), 2, 2, (8, 10, 3))
    for tag, mod in (("jax", _jax_script("back_projection")),
                     ("port", _port("back_projection"))):
        assert mod.run_folder(sr, lr, str(tmp_path / tag), 4, 3) == 2
    _same_tree(tmp_path / "jax", tmp_path / "port")


def test_color2gray_matches_jax(tmp_path):
    src = _images(str(tmp_path / "src"), 2, 3)
    _images(src, 1, 4, ext=".jpg")
    for tag, mod in (("jax", _jax_script("color2gray")),
                     ("port", _port("color2gray"))):
        mod.color2gray(src, str(tmp_path / tag))
    _same_tree(tmp_path / "jax", tmp_path / "port")
    _port("color2gray").main(["--input", src, "--output",
                              str(tmp_path / "cli")])
    _same_tree(tmp_path / "jax", tmp_path / "cli")


def test_extract_subimgs_matches_jax(tmp_path):
    src = _images(str(tmp_path / "src"), 2, 5, (100, 130, 3))
    for tag, mod in (("jax", _jax_script("extract_subimgs_single")),
                     ("port", _port("extract_subimgs_single"))):
        n = mod.extract_subimages(src, str(tmp_path / tag), 48, 24, 8)
        assert n == 30      # 3 rows × 5 columns of crops an image
    _same_tree(tmp_path / "jax", tmp_path / "port")


def test_create_lmdb_matches_jax_and_reads_back(tmp_path):
    from endosr_torch.data.util import get_image_paths, read_img
    from endosr_torch.data.lmdb_io import open_lmdb

    src = _images(str(tmp_path / "src"), 3, 6)
    for tag, mod in (("jax", _jax_script("create_lmdb")),
                     ("port", _port("create_lmdb"))):
        assert mod.create_lmdb(src, str(tmp_path / f"{tag}.lmdb")) == 3
    _same_tree(tmp_path / "jax.lmdb", tmp_path / "port.lmdb")
    keys, sizes = get_image_paths("lmdb", str(tmp_path / "port.lmdb"))
    env = open_lmdb(str(tmp_path / "port.lmdb"))
    h, w, c = (int(s) for s in sizes[1].split("_"))
    got = read_img(env, keys[1], (h, w, c))
    want = read_img(None, os.path.join(src, "im1.png"))
    assert np.array_equal(got, want)


def test_export_and_read_depth_match_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(7)
    depth = tmp_path / "depth"
    depth.mkdir()
    for i in range(2):
        cv2.imwrite(str(depth / f"f{i}.png"),
                    rng.integers(0, 60000, (12, 16), dtype=np.uint16))
    disp = tmp_path / "disp"
    for tag in ("jax", "port"):
        (disp / tag).mkdir(parents=True)
        np.save(disp / tag / "a_disp.npy",
                np.random.default_rng(8).random((1, 1, 12, 16),
                                                dtype=np.float32))
    for tag, exp, rd in (("jax", _jax_script("export_gt_depth"),
                          _jax_script("read_depth_map")),
                         ("port", _port("export_gt_depth"),
                          _port("read_depth_map"))):
        (tmp_path / tag).mkdir()
        assert exp.export_gt_depths(str(depth),
                                    str(tmp_path / tag / "gt.npz")) == 2
        rd.disp_npy_to_png(str(disp / tag / "a_disp.npy"))
    _same_tree(tmp_path / "jax", tmp_path / "port")
    _same_tree(disp / "jax", disp / "port")
    _port("read_depth_map").main(["--input", str(disp / "port")])


@pytest.mark.parametrize("fixed_range", [False, True])
def test_show_depthmask_matches_jax(tmp_path, fixed_range):
    path = tmp_path / "x_disp.npy"
    np.save(path, np.random.default_rng(9).random((1, 1, 20, 24),
                                                  dtype=np.float32))
    for tag, mod in (("jax", _jax_script("show_depthmask")),
                     ("port", _port("show_depthmask"))):
        out = mod.show_depth_mask(str(path), str(tmp_path / tag), 6,
                                  fixed_range)
        assert len(out) == 6
    _same_tree(tmp_path / "jax", tmp_path / "port")


def test_transfer_params_matches_jax(tmp_path):
    from flax import serialization

    g = torch.Generator().manual_seed(10)
    donor = {"conv.weight": torch.rand(4, 3, 3, 3, generator=g),
             "conv.bias": torch.rand(4, generator=g),
             "block.0.weight": torch.rand(8, 4, 1, 1, generator=g),
             "head.weight": torch.rand(2, 8, generator=g)}
    target = {"conv.weight": torch.zeros(4, 3, 3, 3),   # exact match
              "conv.bias": torch.zeros(5),              # shape differs
              "trunk.7.weight": torch.zeros(8, 4, 1, 1),   # one candidate
              "tail.weight": torch.zeros(3, 3)}          # none
    torch.save(donor, tmp_path / "donor.pth")
    torch.save(target, tmp_path / "target.pth")
    n_jax = _jax_script("transfer_params").transfer_params(
        str(tmp_path / "donor.pth"), str(tmp_path / "target.pth"),
        str(tmp_path / "out.ckpt"))
    n = _port("transfer_params").transfer_params(
        str(tmp_path / "donor.pth"), str(tmp_path / "target.pth"),
        str(tmp_path / "out.pth"))
    assert n == n_jax == 2
    tree = serialization.msgpack_restore((tmp_path / "out.ckpt").read_bytes())
    want = {".".join(k): np.asarray(v) for k, v in _flat(tree["torch"])}
    got = torch.load(tmp_path / "out.pth", weights_only=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v
