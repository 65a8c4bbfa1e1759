"""The port's serving pipeline (``python -m endosr_torch.tools.sr_pipeline``)
against ``scripts/sr_pipeline.py``, on the CPU.

The setup of ``tests/test_sr_pipeline.py``: 3 frames of 32² written by
``cv2``, scale 2, latent 16, 10 masks, the flagship net (nb 16, every
block a depth block), a generator ``.pth`` the port writes (its seeded
init), read by both pipelines through ``--model``; depth from
``--depth_dir`` (seeded ``_disp.npy`` files) or from ``--depth_weights``
(seeded monodepth2 files, feed 64×96: the network resizes the depth map
and masks to its feature size):

- the port's PNGs against JAX's within 1 LSB, both ways of getting depth
  (the ``--depth_dir`` case is ``slow``: the JAX pipeline compiles the
  whole network each run, ≈ 35 s on the CPU);
- the port's pipeline equals, bit for bit, its own parts composed by hand:
  ``depth/infer.py::run_folder``, ``ops/masks.py::depth_masks_np`` and
  ``FModelDepthCond.test``, frames of two shapes in batches of 2;
- ``--spatial`` at world 2 (two gloo ranks started as ``torchrun``
  starts them, ``tests/torch_dist_common.py``), at ×2 with depth from
  ``--depth_weights`` (rank 0 makes the maps, the ranks share their
  paths) and at ×8 with ``--depth_dir``: rank 0's PNGs equal the
  unsharded pipeline's within 1 LSB, and rank 1 writes nothing;
- ``--spatial`` outside a ``torchrun`` launch raises by name, a missing
  depth map exits naming it, and without ``--device cpu`` it takes CUDA.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from endosr_torch.depth.infer import run_folder
from endosr_torch.ops.masks import depth_masks_np
from endosr_torch.tools import sr_pipeline as t_pipe
from endosr_torch.utils.misc import tensor2img
from endosr_torch.utils.port_params import write_seeded_monodepth
from tests.torch_dist_common import run_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

LATENT, MASKS, SCALE, H = 16, 10, 2, 32


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    lr, depth = root / "lr", root / "depth"
    lr.mkdir()
    depth.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(lr / f"f{i}.png"),
                    (rng.random((H, H, 3)) * 255).astype(np.uint8))
        np.save(depth / f"f{i}_disp.npy",
                rng.random((1, 1, H, H)).astype(np.float32))
    weights = write_seeded_monodepth(str(root / "md"), seed=3, height=64,
                                     width=96)
    args = t_pipe.parse_args(["--input", str(lr), "--output", "", "--model",
                              "", "--scale", str(SCALE), "--latent",
                              str(LATENT), "--mask_num", str(MASKS)])
    model_path = str(root / "g.pth")
    torch.save(t_pipe.build_model(args, "cpu").netG.state_dict(), model_path)
    return {"root": root, "lr": str(lr), "depth": str(depth),
            "weights": weights, "model": model_path}


def _argv(env, out, depth):
    src = (["--depth_dir", env["depth"]] if depth == "depth_dir"
           else ["--depth_weights", env["weights"]])
    return ["--input", env["lr"], "--output", str(env["root"] / out),
            "--model", env["model"], "--scale", str(SCALE), "--latent",
            str(LATENT), "--mask_num", str(MASKS), *src]


def _pngs(out):
    return {n: cv2.imread(os.path.join(out, n)).astype(np.int16)
            for n in sorted(os.listdir(out)) if n.endswith(".png")}


@pytest.mark.parametrize("depth", [
    # each JAX pipeline compiles the whole network (≈ 35 s on the CPU): one
    # case is enough for tier 1, the one that also runs the producer
    pytest.param("depth_dir", marks=pytest.mark.slow), "depth_weights"])
def test_pipeline_matches_jax(env, depth):
    import sr_pipeline as jax_pipe

    jax_pipe.main(_argv(env, f"jax_{depth}", depth))
    written = t_pipe.main(_argv(env, f"port_{depth}", depth) +
                          ["--device", "cpu"])
    want = _pngs(env["root"] / f"jax_{depth}")
    got = _pngs(env["root"] / f"port_{depth}")
    assert sorted(got) == sorted(want) == ["f0.png", "f1.png", "f2.png"]
    assert sorted(written.values()) == sorted(
        str(env["root"] / f"port_{depth}" / n) for n in got)
    for n, w in want.items():
        assert got[n].shape == w.shape == (H * SCALE, H * SCALE, 3)
        assert np.abs(got[n] - w).max() <= 1, n
    if depth == "depth_weights":
        for s in ("f0", "f1", "f2"):
            a, b = (np.load(env["root"] / f"{who}_{depth}" / "depth"
                            / f"{s}_disp.npy") for who in ("jax", "port"))
            assert np.abs(a - b).max() <= 1e-5


def test_pipeline_is_its_parts_composed(env, tmp_path):
    """Two frame shapes (32² and 24×40), batches of 2: the pipeline's
    PNGs and depth maps equal ``run_folder`` + ``depth_masks_np`` +
    ``FModelDepthCond.test`` on the same frames, bit for bit."""
    lr = tmp_path / "lr"
    lr.mkdir()
    rng = np.random.default_rng(1)
    shapes = {"a": (H, H), "b": (24, 40), "c": (H, H), "d": (H, H),
              "e": (24, 40)}
    for stem, hw in shapes.items():
        cv2.imwrite(str(lr / f"{stem}.png"),
                    (rng.random((*hw, 3)) * 255).astype(np.uint8))
    argv = ["--input", str(lr), "--output", str(tmp_path / "out"), "--model",
            env["model"], "--scale", str(SCALE), "--latent", str(LATENT),
            "--mask_num", str(MASKS), "--depth_weights", env["weights"],
            "--batch", "2", "--device", "cpu"]
    written = t_pipe.main(argv)
    assert sorted(written) == sorted(shapes)

    run_folder(str(lr), env["weights"], str(tmp_path / "depth"),
               save_colormap=False, device="cpu")
    model = t_pipe.build_model(t_pipe.parse_args(argv), "cpu")
    for stems in (["a", "c"], ["d"], ["b", "e"]):
        dms = [np.load(tmp_path / "depth" / f"{s}_disp.npy")[0, 0]
               for s in stems]
        for s, dm in zip(stems, dms):
            np.testing.assert_array_equal(
                np.load(tmp_path / "out" / "depth" / f"{s}_disp.npy")[0, 0],
                dm)
        imgs = [cv2.imread(str(lr / f"{s}.png"))[:, :, ::-1] / np.float32(255)
                for s in stems]
        model.feed_data({
            "LQ": np.stack(imgs).astype(np.float32),
            "Depth": np.stack(dms)[..., None],
            "DepthMaskList": np.stack([depth_masks_np(d, True, MASKS)
                                       for d in dms])})
        sr = model.test()
        for j, s in enumerate(stems):
            np.testing.assert_array_equal(
                cv2.imread(written[s]), tensor2img(sr[j]))


def test_spatial_pipeline_matches_unsharded(env, tmp_path):
    x8 = _argv(env, "unused", "depth_dir")
    x8[x8.index("--scale") + 1] = "8"
    x8[x8.index("--model") + 1] = ""           # the seeded init, saved
    net = t_pipe.build_model(t_pipe.parse_args(x8), "cpu").netG
    x8[x8.index("--model") + 1] = str(tmp_path / "g8.pth")
    torch.save(net.state_dict(), x8[x8.index("--model") + 1])
    runs = {2: _argv(env, "unused", "depth_weights"), 8: x8}
    for scale, argv in runs.items():
        t_pipe.main(argv + ["--device", "cpu", "--output",
                            str(tmp_path / f"x{scale}" / "whole")])
    ranks = run_ranks("sr_pipeline_spatial", 2, {"runs": [
        (argv, str(tmp_path / f"x{scale}")) for scale, argv in runs.items()]},
        tmp_path / "ranks")
    for scale in runs:
        want = _pngs(tmp_path / f"x{scale}" / "whole")
        got = _pngs(tmp_path / f"x{scale}" / "rank0")
        assert sorted(got) == sorted(want) == ["f0.png", "f1.png", "f2.png"]
        for n, w in want.items():
            assert got[n].shape == w.shape == (H * scale, H * scale, 3)
            assert np.abs(got[n] - w).max() <= 1, (scale, n)
        assert not (tmp_path / f"x{scale}" / "rank1").exists()
    for r, written in enumerate(ranks):     # every rank names the frames
        assert written == [{f"f{i}": str(tmp_path / f"x{scale}" / f"rank{r}"
                                         / f"f{i}.png") for i in range(3)}
                           for scale in runs]


def test_pipeline_refusals(env, tmp_path, monkeypatch):
    argv = _argv(env, "unused", "depth_dir")
    with pytest.raises(RuntimeError, match="spatial.*torchrun"):
        t_pipe.main(argv + ["--spatial", "--device", "cpu"])
    empty = tmp_path / "none"
    empty.mkdir()
    with pytest.raises(SystemExit, match="f0_disp.npy"):
        t_pipe.main(argv[:-1] + [str(empty), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pipe.main(argv)
