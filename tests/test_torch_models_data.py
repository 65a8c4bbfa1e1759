"""The datasets of the other models, and the entry points on them.

- Datasets: ``LQGTker`` (training with flips and rotations, test with the
  GT cropped to the scale, and without an LR root: the MATLAB bicubic),
  ``LQ``, ``LQker`` (with its ``ker_map_list``), ``SRker`` (with its
  ``est_ker_map_list``) and ``EndoScene_Depthnew`` (``.tif`` frames,
  depth maps at the GT size resized to the LR image with their masks
  rebuilt, segmentation labels; training, test, and the ``cache_data`` /
  ``u8_pipeline`` path) give JAX's items, bit for bit, from the same
  files and augmentation seeds.
- ``python -m endosr_torch.train`` (``main``, ``--device cpu``) trains
  ``sr`` (MSRResNet in BasicSR's ×4 recipe, ``models/recipes.py``, cut to
  nf 8, nb 1, batch 2 and 3 steps) and ``sftmd_depthSegNet`` (the
  EndoScene ×2 co-training options, a small DepthNet, 2 steps): each
  step's losses equal those of a replay of the same batches through the
  model API; the checkpoints are the model's (``{iter}_segNet.pth``
  beside ``{iter}_G.pth``; no ``dyn_weight`` in the ``sr`` trainer
  state); ``python -m endosr_torch.test`` serves the ``sr`` weights.
"""

import copy
import random

import cv2
import numpy as np
import pytest
import torch
import yaml

import endosr.data as jdata
import endosr.data.datasets as jds
import endosr_torch.data as tdata
import endosr_torch.data.datasets as tds
import endosr_torch.test as ttest
import endosr_torch.train as ttrain
from endosr_torch.config import options as toptions
from endosr_torch.models import create_model
from endosr_torch.models.common import SimpleModel
from endosr_torch.models.f_depthseg import FModelDepthSeg
from endosr_torch.models.recipes import depthseg_yaml, msrresnet_x4_yaml
from endosr_torch.utils import misc as tmisc
from tests.torch_threads import one_torch_thread  # noqa: F401


def _smooth(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([np.sin(xx * rng.uniform(0.1, 0.4) + rng.uniform(0, 6))
                    * np.cos(yy * rng.uniform(0.1, 0.4)) * 90 + 128
                    for _ in range(3)], -1)
    return np.clip(img + rng.integers(0, 6, (h, w, 3)), 0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Square image pairs (GT 16² → LR 8², as training patches are), GT of
    17×21, SR images, and an EndoScene tree of ``.tif`` frames (GT 64×96,
    whose sides the FCN's five poolings need as multiples of 32; LR 32×48
    under ``x2/``; depth at the GT size; segmentation masks)."""
    root = tmp_path_factory.mktemp("models_data")
    rng = np.random.default_rng(0)
    for d in ("HR", "LR", "HR17", "SR", "es/HR", "es/LR/x2", "es/D",
              "es/seg"):
        (root / d).mkdir(parents=True)
    names = []
    for i in range(3):
        gt = _smooth(rng, 16, 16)
        cv2.imwrite(str(root / "HR" / f"p{i}.png"), gt)
        cv2.imwrite(str(root / "LR" / f"p{i}.png"), gt[::2, ::2])
        gt = _smooth(rng, 64, 96)
        cv2.imwrite(str(root / "HR17" / f"p{i}.png"), _smooth(rng, 17, 21))
        cv2.imwrite(str(root / "SR" / f"s{i}.png"), _smooth(rng, 12, 12))
        name = f"{i + 1}.tif"
        names.append(name)
        cv2.imwrite(str(root / "es/HR" / name), gt)
        cv2.imwrite(str(root / "es/LR/x2" / name), gt[::2, ::2])
        np.save(root / "es/D" / f"{i + 1}_disp.npy",
                rng.random((1, 1, 64, 96)).astype(np.float32))
        cv2.imwrite(str(root / "es/seg" / name),
                    (rng.random((64, 96)) > 0.5).astype(np.uint8) * 255)
    (root / "es/split.txt").write_text("".join(n + "\n" for n in names))
    return root


def _pairs(tree, phase, lq=True, gt="HR"):
    return {"mode": "LQGTker", "phase": phase, "scale": 2,
            "data_type": "img", "dataroot_GT": str(tree / gt),
            "dataroot_LQ": str(tree / "LR") if lq else None,
            "use_flip": True, "use_rot": True}


def _endoscene(tree, phase, **kw):
    return {"mode": "EndoScene_Depthnew", "phase": phase, "scale": 2,
            "data_type": "img", "dataroot_GT": str(tree / "es/HR"),
            "dataroot_LQ": str(tree / "es/LR"),
            "dataroot_depthMap": str(tree / "es/D"),
            "dataroot_seglabel": str(tree / "es/seg"),
            "dataset_split_list": str(tree / "es/split.txt"),
            "use_flip": True, "use_rot": True, "depthMaskNum": 4,
            "depthFixedRange": False, **kw}


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.array_equal(g, w), k
        else:
            assert g == w, k


def _compare(t, j, seed=3):
    assert len(t) == len(j)
    t.rng, j.rng = random.Random(seed), random.Random(seed)
    for i in range(len(t)):
        _assert_items_equal(t[i], j[i])


CASES = {
    "lqgtker_train": lambda tr: _pairs(tr, "train"),
    "lqgtker_test_modcrop": lambda tr: _pairs(tr, "val", gt="HR17",
                                              lq=False),
    "lqgtker_no_lr_root": lambda tr: _pairs(tr, "train", lq=False),
    "lq": lambda tr: {"mode": "LQ", "phase": "train", "data_type": "img",
                      "dataroot_LQ": str(tr / "LR")},
    "endoscene_new_train": lambda tr: _endoscene(tr, "train"),
    "endoscene_new_test": lambda tr: _endoscene(tr, "test"),
    "endoscene_new_cached_u8": lambda tr: _endoscene(
        tr, "train", cache_data=True, u8_pipeline=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_items_equal_jax(tree, case):
    opt = CASES[case](tree)
    t, j = tdata.create_dataset(dict(opt)), jdata.create_dataset(dict(opt))
    assert type(t).__name__ == type(j).__name__
    _compare(t, j)
    if case.startswith("endoscene"):
        item = t[0]
        assert item["Depth"].shape in ((32, 48, 1), (48, 32, 1))
        assert item["DepthMaskList"].shape[:2] == item["Depth"].shape[:2]
        assert item["SegLabel"].shape[:2] == item["GT"].shape[:2]


def test_kernel_code_datasets_equal_jax(tree):
    codes = np.random.default_rng(1).random((3, 10)).astype(np.float32)
    opt = {"mode": "LQker", "phase": "train", "data_type": "img",
           "dataroot_LQ": str(tree / "LR")}
    _compare(tds.LQKerDataset(opt, list(codes)),
             jds.LQKerDataset(opt, list(codes)))
    assert np.array_equal(tds.LQKerDataset(opt, codes)[1]["real_ker"],
                          codes[1])
    opt = {"mode": "SRker", "phase": "train", "data_type": "img",
           "dataroot_SR": str(tree / "SR")}
    _compare(tds.SRKerDataset(opt, codes), jds.SRKerDataset(opt, codes))
    item = tdata.create_dataset(opt)[2]
    assert set(item) == {"SR", "SR_path"} and item["SR"].shape == (12, 12, 3)


# ------------------------------------------------------------ entry points

def _write_yaml(path, y):
    path.write_text(yaml.safe_dump(y))
    return str(path)


def _record(monkeypatch, cls, sink):
    orig = cls.optimize_parameters

    def wrapped(self, *a, **k):
        out = orig(self, *a, **k)
        sink.append(dict(self.log_dict))
        return out

    monkeypatch.setattr(cls, "optimize_parameters", wrapped)


def _replay(yml, steps):
    """The run's batches, in its order, through the model API: the logs of
    each step."""
    opt = toptions.dict_to_nonedict(toptions.parse(yml, is_train=True))
    tmisc.set_random_seed(opt["train"]["manual_seed"])
    model = create_model(opt, device="cpu")
    ds_opt = opt["datasets"]["train"]
    loader = tdata.create_dataloader(tdata.create_dataset(ds_opt), ds_opt,
                                     opt)
    logs, epoch = [], 0
    while len(logs) < steps:
        loader.set_epoch(epoch)
        for batch in loader:
            model.feed_data(batch)
            logs.append(dict(model.optimize_parameters(len(logs) + 1)))
            if len(logs) == steps:
                break
        epoch += 1
    return logs


def test_train_main_runs_sr_and_its_replay_matches(tree, tmp_path,
                                                   monkeypatch):
    y = msrresnet_x4_yaml(str(tmp_path / "run"), str(tree / "HR"),
                          str(tree / "LR"), str(tree / "HR"),
                          str(tree / "LR"))
    y["scale"] = 2
    y["network_G"].update(nf=8, nb=1)
    # in this process a dataset's augmentation RNG is not seeded (as in
    # JAX): no flips, so the replay sees the run's batches
    y["datasets"]["train"].update(batch_size=2, n_workers=0,
                                  dataset_enlarge_ratio=1, use_flip=False,
                                  use_rot=False)
    y["train"].update(niter=3, val_freq=2)
    y["logger"].update(print_freq=1, save_checkpoint_freq=3)
    yml = _write_yaml(tmp_path / "sr.yml", y)
    logs = []
    _record(monkeypatch, SimpleModel, logs)
    model = ttrain.main(["-opt_F", yml, "--device", "cpu"])
    assert type(model).__name__ == "SRModel" and len(logs) == 3
    monkeypatch.undo()
    assert logs == _replay(yml, 3)
    exp = tmp_path / "run" / "experiments" / "sr_x4"
    assert (exp / "models" / "3_G.pth").is_file()
    assert (exp / "models" / "latest_G.pth").is_file()
    st = torch.load(exp / "training_state" / "3.state", weights_only=True)
    assert "dyn_weight" not in st and st["step"] == 3
    # test.py serves the trained weights
    t = {"name": "sr_test", "model": "sr", "scale": 2,
         "datasets": {"test_1": {"name": "set", "mode": "LQGTker",
                                 "data_type": "img",
                                 "dataroot_GT": str(tree / "HR"),
                                 "dataroot_LQ": str(tree / "LR")}},
         "network_G": y["network_G"],
         "path": {"root": str(tmp_path / "eval"), "strict_load": True,
                  "pretrain_model_G": str(exp / "models" / "latest_G.pth")}}
    m = ttest.main(["-opt_F", _write_yaml(tmp_path / "t.yml", t),
                    "--device", "cpu"])
    res = next((tmp_path / "eval" / "results").iterdir())
    rows = (res / "result_x2.tsv").read_text().splitlines()
    assert len(rows) == 5 and rows[-1].startswith("Average")
    assert len(list((res / "x2").glob("*.png"))) == 3
    for k, v in model.netG.state_dict().items():
        assert torch.equal(m.netG.state_dict()[k], v), k


def test_train_main_runs_depthseg_and_its_replay_matches(tree, tmp_path,
                                                         monkeypatch):
    es = tree / "es"
    y = depthseg_yaml(str(tmp_path / "run"), str(es / "HR"), str(es / "LR"),
                      str(es / "D"), str(es / "seg"), str(es / "split.txt"))
    # a small DepthNet; no flips or rotations (the augmentation RNG is
    # not seeded in this process, and rotated 64×96 frames do not stack
    # with upright ones: C7)
    y["network_G"].update(nb=4, depth_latent_ch=16, which_ResBlk_depth=[0])
    y["datasets"]["train"].update(
        mode="EndoScene_Depthnew", batch_size=2, n_workers=0,
        use_flip=False, use_rot=False, data_num=3)
    y["train"].update(niter=2, val_freq=1000)
    y["logger"].update(print_freq=1, save_checkpoint_freq=2)
    yml = _write_yaml(tmp_path / "seg.yml", y)
    logs = []
    _record(monkeypatch, FModelDepthSeg, logs)
    model = ttrain.main(["-opt_F", yml, "--device", "cpu"])
    assert type(model).__name__ == "FModelDepthSeg" and len(logs) == 2
    assert {"l_segBCE", "l_dynamic", "l_all"} <= set(logs[0])
    monkeypatch.undo()
    assert logs == _replay(yml, 2)
    models = tmp_path / "run" / "experiments" / "depthseg_x2" / "models"
    for name in ("2_G.pth", "2_segNet.pth", "latest_G.pth",
                 "latest_segNet.pth"):
        assert (models / name).is_file(), name
    seg = torch.load(models / "latest_segNet.pth", weights_only=True)
    for k, v in model.segNet.state_dict().items():
        assert torch.equal(seg[k], v), k
    assert int(seg["bn1.num_batches_tracked"]) == 2


def test_chip_smoke_defines_each_top_level_name_once():
    """A second ``def`` of a name in ``chip_smoke.py`` silently replaces
    the first for every phase that calls it."""
    import ast
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    names = [n.name for n in ast.parse(path.read_text()).body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name)]
    assert sorted({n for n in names if names.count(n) > 1}) == []
