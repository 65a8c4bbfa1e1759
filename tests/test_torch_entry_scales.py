"""The training entry point on the ×2 Kvasir YAML (``remat_blocks``) and
the ×3 EndoScene YAML against the JAX ``train.py``, the EndoScene training
loader with rotations against JAX's, and the fp32 of the entry points on
CUDA, on the CPU.

- **Training.** As ``tests/test_torch_entry.py`` does at ×8: the repo's
  YAML with the data roots, ``path.root``, the step counts, the batch (2),
  flips off, no worker process and the network cut to the smoke net (nb 4,
  latent 16, K 10) on a synthetic tree written with ``cv2`` (×2: a Kvasir
  layout, GT 32² crops of 32² pairs; ×3: CVC-EndoSceneStill whole frames of
  GT 48×42, LR 16×14 under ``x3/``, a split file). Both ``train.main``
  start from the same ``.pth`` and run two steps: ``l_pix``,
  ``l_dynamic`` and ``l_all`` agree to ≤ 1e-5 relative, the bar of
  ``tests/test_torch_entry.py``.
- **EndoScene batches with rotations.** Training takes whole frames, and
  ``use_rot`` transposes each with probability ½, so a batch stacks
  upright and transposed frames of a non-square size; both packages' loaders
  stack with ``np.stack``, which raises: at the ×3 YAML's batch of 4, 7 of
  8 batches (``ROADMAP.md`` Queue C, C7). With one worker process each,
  the YAML's seed and flips and rotations on, the two loaders give the
  same batches and raise at the same batch of the same epoch.
- **TF32.** ``main`` of both entry points on a CUDA device (the device
  check mocked) turns cuDNN's and the matmuls' TF32 off before it builds
  the model.
"""

import logging
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

import endosr.data as jdata
import endosr.models.f_depthcond as jfdc
import endosr.parallel.mesh as jmesh
import endosr.utils.cache as jcache
import endosr_torch.data as tdata
import endosr_torch.test as ttest
import endosr_torch.train as ttrain
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.models.recipes import TRAIN_YAMLS
from endosr_torch.ops.resize import imresize_np

REPO = Path(__file__).resolve().parent.parent
NET = {"nb": 4, "depth_latent_ch": 16}
LOG_KEYS = ("l_pix", "l_dynamic", "l_all")
# case: (the YAML, GT size, LR size, the dataset's layout)
CASES = {"x2_kvasir_remat": (TRAIN_YAMLS[("kvasir", 2)], (32, 32), (16, 16),
                             "kvasir"),
         "x3_endoscene": (TRAIN_YAMLS[("endoscene", 3)], (48, 42), (16, 14),
                          "endoscene")}
N_TRAIN = 4


def _smooth(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    chans = [np.sin(xx * rng.uniform(0.05, 0.3) + rng.uniform(0, 6))
             * np.cos(yy * rng.uniform(0.05, 0.3)) * 90 + 128 for _ in range(3)]
    img = np.stack(chans, -1) + rng.integers(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_tree(root, scale, gt_hw, lr_hw, layout, n=N_TRAIN, seed=0):
    """``n`` pairs of GT ``gt_hw`` and LR ``lr_hw`` (the MATLAB bicubic)
    with ``<stem>_disp.npy`` depth: Kvasir (HR, LR, D) or EndoScene (the LR
    under ``x<scale>/``, ``split.txt`` naming the frames in reverse)."""
    rng = np.random.default_rng(seed)
    lr_dir = root / "LR" / (f"x{scale}" if layout == "endoscene" else "")
    for d in (root / "HR", lr_dir, root / "D"):
        d.mkdir(parents=True, exist_ok=True)
    names = [f"f{i}.png" for i in range(n)]
    for name in names:
        gt = _smooth(rng, *gt_hw)
        lr = imresize_np(gt / 255.0, 1 / scale)
        assert lr.shape[:2] == lr_hw
        cv2.imwrite(str(root / "HR" / name), gt)
        cv2.imwrite(str(lr_dir / name),
                    np.clip(lr * 255.0, 0, 255).round().astype(np.uint8))
        np.save(root / "D" / f"{name[:-4]}_disp.npy",
                rng.random((1, 1) + lr_hw).astype(np.float32))
    (root / "split.txt").write_text("".join(n + "\n" for n in names[::-1]))
    return root


def _train_yaml(tmp, case, run, pretrain):
    src, gt_hw, lr_hw, layout = CASES[case]
    y = yaml.safe_load(src.read_text())
    scale = int(y["scale"])
    data = tmp / f"tree_{case}"
    if not data.exists():
        _write_tree(data, scale, gt_hw, lr_hw, layout)
    roots = {"dataroot_GT": str(data / "HR"), "dataroot_LQ": str(data / "LR"),
             "dataroot_depthMap": str(data / "D")}
    for phase in ("train", "val"):
        y["datasets"][phase].update(roots)
        if layout == "endoscene":
            y["datasets"][phase]["dataset_split_list"] = str(data / "split.txt")
    y["datasets"]["train"].update(
        data_num=N_TRAIN, batch_size=2, GT_size=gt_hw[0], LR_size=lr_hw[0],
        use_flip=False, use_rot=False, n_workers=0)
    y["network_G"].update(NET)
    y["use_tb_logger"] = False
    y["path"].update(root=str(tmp / run), pretrain_model_G=pretrain)
    y["train"].update(niter=2, val_freq=1000)
    y["logger"].update(print_freq=1, save_checkpoint_freq=1000)
    path = tmp / f"{run}.yml"
    path.write_text(yaml.safe_dump(y))
    return str(path), y


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: the suite runs several worker
    processes on the machine's cores, and this module's steps slow down
    many times over when every worker's threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_env(monkeypatch):
    """The JAX ``train.py`` on one CPU device, without the persistent
    compilation cache; the log handlers it adds are taken back."""
    monkeypatch.setattr(jfdc, "get_mesh",
                        lambda: jmesh.make_mesh(jax.devices()[:1]))
    monkeypatch.setattr(jcache, "enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.syspath_prepend(str(REPO))
    saved = {n: list(logging.getLogger(n).handlers) for n in ("base", "val")}
    yield monkeypatch
    for n, hs in saved.items():
        lg = logging.getLogger(n)
        for h in [h for h in lg.handlers if h not in hs]:
            lg.removeHandler(h)
            h.close()


def _recording(mp, cls, sink):
    orig = cls.optimize_parameters

    def wrapped(self, *a, **k):
        out = orig(self, *a, **k)
        sink.append(dict(self.log_dict))
        return out

    mp.setattr(cls, "optimize_parameters", wrapped)


@pytest.mark.parametrize("case", CASES)
def test_train_main_matches_jax(case, tmp_path, jax_env):
    _, y = _train_yaml(tmp_path, case, "probe", None)
    init = FModelDepthCond({"model": y["model"], "scale": y["scale"],
                            "network_G": y["network_G"],
                            "path": {"models": str(tmp_path / "init")}},
                           device="cpu")
    assert init.netG.remat_blocks == (case == "x2_kvasir_remat")
    weights = init.save(0)
    logs = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, jfdc.FModelDepthCond, logs["jax"])
        _recording(mp, FModelDepthCond, logs["port"])
        jax_env.setattr(sys, "argv", ["train.py", "-opt_F", _train_yaml(
            tmp_path, case, "jax", weights)[0]])
        __import__("train").main()
        model = ttrain.main(["-opt_F", _train_yaml(tmp_path, case, "port",
                                                   weights)[0],
                             "--device", "cpu"])
    assert model.step == 2 and model.netG.scale == y["scale"]
    assert len(logs["jax"]) == len(logs["port"]) == 2
    for n, (got, want) in enumerate(zip(logs["port"], logs["jax"]), 1):
        assert got.keys() == want.keys()
        for k in LOG_KEYS:
            rel = abs(got[k] - want[k]) / abs(want[k])
            assert rel <= 1e-5, (n, k, got[k], want[k])


ES_FRAMES, ES_EPOCHS = 8, 12


def _outcomes(loader):
    """Per epoch: the batches until the loader raised, and what it
    raised (None: the epoch ended)."""
    out = []
    for epoch in range(ES_EPOCHS):
        loader.set_epoch(epoch)
        got, err = [], None
        try:
            for b in loader:
                got.append({k: np.asarray(v) for k, v in b.items()
                            if k in ("LQ", "GT", "Depth", "DepthMaskList")})
        except ValueError as e:
            err = type(e)
        out.append((got, err))
    return out


def test_endoscene_rotated_batches_stack_or_raise_like_jax(tmp_path):
    """The ×3 EndoScene YAML's training block (batch 4, whole frames,
    flips and rotations, its seed) with one worker a package: the same
    batches, and the same ``ValueError`` from ``np.stack`` where a batch
    mixes upright and transposed frames."""
    y = yaml.safe_load(TRAIN_YAMLS[("endoscene", 3)].read_text())
    data = _write_tree(tmp_path / "es", 3, (48, 42), (16, 14), "endoscene",
                       n=ES_FRAMES)
    dopt = {**y["datasets"]["train"], "phase": "train", "scale": 3,
            "data_type": "img", "dataroot_GT": str(data / "HR"),
            "dataroot_LQ": str(data / "LR"),
            "dataroot_depthMap": str(data / "D"),
            "dataset_split_list": str(data / "split.txt"), "n_workers": 1}
    assert (dopt["batch_size"], dopt["use_rot"], dopt["use_flip"]) == (
        4, True, True)
    opt = {"train": {"manual_seed": y["train"]["manual_seed"]}}
    got = _outcomes(tdata.create_dataloader(
        tdata.create_dataset(dict(dopt)), dopt, opt))
    want = _outcomes(jdata.create_dataloader(
        jdata.create_dataset(dict(dopt)), dopt, opt))
    assert [(len(b), e) for b, e in got] == [(len(b), e) for b, e in want]
    for (gb, _), (wb, _) in zip(got, want):
        for g, w in zip(gb, wb):
            for k, v in w.items():
                np.testing.assert_array_equal(g[k], v, err_msg=k)
    # both outcomes occur at this seed: whole batches (upright or all
    # transposed) and the raise
    shapes = {b["GT"].shape[1:3] for bs, _ in got for b in bs}
    assert shapes == {(48, 42), (42, 48)}
    assert any(e is ValueError for _, e in got)


@pytest.mark.parametrize("entry", ["train", "test"])
def test_entry_points_turn_tf32_off_on_cuda(entry, monkeypatch, tmp_path):
    """On a CUDA device ``main`` turns TF32 off for cuDNN and the matmuls
    before it builds anything (PyTorch's default runs fp32 convolutions on
    TF32); the flags are restored after the test."""
    mod = ttrain if entry == "train" else ttest
    seen = {}

    def stop(opt, device, *a):
        seen.update(device=device, cudnn=torch.backends.cudnn.allow_tf32,
                    matmul=torch.backends.cuda.matmul.allow_tf32)

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(mod, "_train" if entry == "train" else "_evaluate",
                        stop)
    if entry == "train":
        path, _ = _train_yaml(tmp_path, "x2_kvasir_remat", "run", None)
    else:
        y = yaml.safe_load((REPO / "options/test/test_depthNet.yml")
                           .read_text())
        y["path"]["root"] = str(tmp_path / "eval")
        path = str(tmp_path / "test.yml")
        Path(path).write_text(yaml.safe_dump(y))
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        mod.main(["-opt_F", path])
        assert seen == {"device": torch.device("cuda"), "cudnn": False,
                        "matmul": False}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
