"""The port's entry points (``python -m endosr_torch.train`` / ``.test``)
against the JAX package's ``train.py`` / ``test.py``, on the CPU.

The YAMLs are the JAX package's own (``options/train/…_x8.yml``,
``options/test/test_depthNet.yml``) with the data roots, ``path.root``,
the step counts and the network cut to a small DepthNet (×8, LR 16 → GT
128, nb 4, latent 16, K 10, batch 2) on a synthetic Kvasir-style tree
written with ``cv2``.

- **Training.** Both ``train.main`` start from the same ``.pth`` (the port
  saves it, JAX loads it through its porter) and run two steps on the same
  data, flips off, no worker process: ``l_pix``, ``l_dynamic`` and
  ``l_all`` of both steps agree to ≤ 1e-5 relative (fp32 sums over the
  batch in other orders; measured ≤ 2.5e-6).
- **Checkpoints across packages.** JAX's ``test.main`` loads the port's
  ``latest_G.pth`` through its porter: the parameters equal the port's bit
  for bit, and the JAX forward of each test image equals the port's to
  ≤ 2e-4 (the repo's parity bar).
- **Evaluation.** Both ``test.main`` in fp32 on those weights: the same
  TSV rows (≤ 1e-3 dB, ≤ 1e-5 SSIM) and PNGs (≤ 1 level, a rounding at a
  half).
- **Resume.** Both packages' two-step runs save at step 2 (the end of
  epoch 0) and resume with ``resume_state: auto`` to step 4: steps 3–4
  rerun epoch 0 from its first batch, as the JAX ``train.py`` does, and
  their losses agree to ≤ 1e-5 relative (measured ≤ 2.1e-7). Both resume
  from one state, the port's step-2 weights, K-vector and Adam moments
  carried into the JAX copy, on one CPU thread. With flips and rotations on and
  one worker process, a resumed port run equals bit for bit a replay of
  that rule through the model API (``resume_training``, then epoch 0's
  batches): logs and final weights.
- ``logger.profile_iter`` writes a ``torch.profiler`` trace; tensorboardX
  is optional (its absence is logged).
- **×2 and ×3.** The repo's test YAML at ×2 (Kvasir layout) and ×3 (the
  EndoScene dataset) with ``precision`` unset: both ``test.main`` serve
  ``bf16c3`` unbucketed, and their TSV rows and PNGs agree.
- The entry points default to CUDA and raise without it; unported models
  and a directory that is no orbax checkpoint raise by name.
"""

import copy
import json
import logging
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import cv2
import yaml
from flax import serialization

import endosr.models as jmodels
import endosr.models.f_depthcond as jfdc
import endosr.parallel.mesh as jmesh
import endosr.utils.cache as jcache
import endosr.utils.port_torch as jport
import endosr_torch.test as ttest
import endosr_torch.train as ttrain
from endosr_torch.config import options as toptions
from endosr_torch.data import create_dataloader, create_dataset
from endosr_torch.models import create_model
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.ops.resize import imresize_np
from endosr_torch.utils import misc as tmisc
from endosr_torch.utils.port_params import from_flax, load_params

REPO = Path(__file__).resolve().parent.parent
TRAIN_YAML = REPO / "options/train/train_depthNet_SEAN_depthMask_x8.yml"
TEST_YAML = REPO / "options/test/test_depthNet.yml"
NET = {"nb": 4, "depth_latent_ch": 16, "which_ResBlk_depth": [0]}
LR, SCALE, N_TRAIN = 16, 8, 4
VAL_LR = (15, 14)                # GT 120×112: bucketing pads to 32
LOG_KEYS = ("l_pix", "l_dynamic", "l_all")


def _smooth(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    chans = [np.sin(xx * rng.uniform(0.02, 0.1) + rng.uniform(0, 6))
             * np.cos(yy * rng.uniform(0.02, 0.1)) * 90 + 128 for _ in range(3)]
    img = np.stack(chans, -1) + rng.integers(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """HR/LR/depth trees: 4 train pairs (GT 128², LR 16² by the MATLAB
    bicubic) and 2 test pairs (GT 120×112, LR 15×14)."""
    root = tmp_path_factory.mktemp("kvasir_entry")
    rng = np.random.default_rng(0)
    for split, n, (lh, lw) in (("train", N_TRAIN, (LR, LR)),
                               ("test", 2, VAL_LR)):
        for sub in ("HR", "LR", "D"):
            (root / sub / split).mkdir(parents=True)
        for i in range(n):
            gt = _smooth(rng, lh * SCALE, lw * SCALE)
            lr = imresize_np(gt / 255.0, 1 / SCALE)
            lr = np.clip(lr * 255.0, 0, 255).round().astype(np.uint8)
            cv2.imwrite(str(root / "HR" / split / f"f{i}.png"), gt)
            cv2.imwrite(str(root / "LR" / split / f"f{i}.png"), lr)
            np.save(root / "D" / split / f"f{i}_disp.npy",
                    rng.random((1, 1, lh, lw)).astype(np.float32))
    return root


def _imread(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


def _roots(block, data, split):
    block.update(dataroot_GT=str(data / "HR" / split),
                 dataroot_LQ=str(data / "LR" / split),
                 dataroot_depthMap=str(data / "D" / split))


def _train_yaml(tmp, data, run, niter, val_freq=1000, save_freq=1000,
                flips=False, workers=0, pretrain=None, resume=None):
    y = yaml.safe_load(TRAIN_YAML.read_text())
    tr, va = y["datasets"]["train"], y["datasets"]["val"]
    _roots(tr, data, "train")
    _roots(va, data, "test")
    tr.update(data_num=N_TRAIN, batch_size=2, GT_size=LR * SCALE, LR_size=LR,
              use_flip=flips, use_rot=flips, n_workers=workers)
    y["network_G"].update(NET)
    y["use_tb_logger"] = False
    y["path"].update(root=str(tmp / run), pretrain_model_G=pretrain,
                     resume_state=resume)
    y["train"].update(niter=niter, val_freq=val_freq)
    y["logger"].update(print_freq=1, save_checkpoint_freq=save_freq)
    path = tmp / f"{run}.yml"
    path.write_text(yaml.safe_dump(y))
    return str(path)


def _test_yaml(tmp, data, run, weights, **top):
    y = yaml.safe_load(TEST_YAML.read_text())
    _roots(y["datasets"]["test_1"], data, "test")
    y["network_G"].update(NET)
    y["path"].update(root=str(tmp / run), pretrain_model_G=weights)
    y.update(top)
    path = tmp / f"{run}.yml"
    path.write_text(yaml.safe_dump(y))
    return str(path)


@pytest.fixture
def jax_env(monkeypatch):
    """Run the JAX ``train.py`` and ``test.py`` on one CPU device, without
    the persistent compilation cache, and take back the log handlers they
    add."""
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


def _record(monkeypatch, cls, method, sink, what):
    orig = getattr(cls, method)

    def wrapped(self, *a, **k):
        out = orig(self, *a, **k)
        sink.append(what(self))
        return out

    monkeypatch.setattr(cls, method, wrapped)


def _run_jax(monkeypatch, module, opt_path):
    monkeypatch.setattr(sys, "argv", [f"{module}.py", "-opt_F", opt_path])
    __import__(module).main()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data):
    """Lazily made runs shared by the tests: {name: result}."""
    tmp = tmp_path_factory.mktemp("entry_runs")
    cache = {}

    def get(name, make):
        if name not in cache:
            cache[name] = make(tmp)
        return cache[name]

    return get


EXP = "experiments/DepthNet_ResBlk_depthMask_x8"


def _train_both(monkeypatch, logs, jax_opt, port_opt):
    """JAX ``train.main`` on ``jax_opt``, then the port's on ``port_opt``,
    with each ``optimize_parameters`` call's losses appended to ``logs``;
    returns the port's model."""
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, jfdc.FModelDepthCond, "optimize_parameters", logs["jax"],
                lambda m: dict(m.log_dict))
        _record(mp, FModelDepthCond, "optimize_parameters", logs["port"],
                lambda m: dict(m.log_dict))
        _run_jax(monkeypatch, "train", jax_opt)
        return ttrain.main(["-opt_F", port_opt, "--device", "cpu"])


def _slice(tmp, data, monkeypatch):
    """Two steps of JAX ``train.main`` and of the port's from one ``.pth``,
    each saving at step 2."""
    init = FModelDepthCond({"model": "sftmd_depthCond", "scale": SCALE,
                            "network_G": {**yaml.safe_load(
                                TRAIN_YAML.read_text())["network_G"], **NET},
                            "path": {"models": str(tmp / "init")}},
                           device="cpu")
    weights = init.save(0)
    logs = {"jax": [], "port": []}
    model = _train_both(
        monkeypatch, logs,
        _train_yaml(tmp, data, "jax_train", 2, save_freq=2, pretrain=weights),
        _train_yaml(tmp, data, "port_train", 2, save_freq=2, pretrain=weights))
    return {"logs": logs, "model": model, "tmp": tmp, "weights": weights,
            "latest": str(tmp / "port_train" / EXP / "models/latest_G.pth")}


def _carry_port_state(port_state, jax_state, names):
    """Overwrite the JAX run's step-2 training state with the port's: the
    weights, the dynamic loss's K-vector and Adam's moments (``names``:
    the port optimizer's parameter names in order), carried into JAX's
    layout by the JAX package's own porter."""
    st = torch.load(str(port_state), map_location="cpu", weights_only=True)
    raw = serialization.msgpack_restore(Path(jax_state).read_bytes())
    adam = st["optimizer"]["state"]
    (moments,) = [s for s in raw["opt_state"].values()
                  if isinstance(s, dict) and "mu" in s]
    assert int(moments["count"]) == st["step"] == 2

    def tree(by_name, like):
        out = {"netG": jport.port_state_dict(
            {k[len("netG."):]: np.asarray(v) for k, v in by_name.items()
             if k.startswith("netG.")}, like["netG"])}
        if "dyn" in like:
            out["dyn"] = {"trainable_weight": np.asarray(
                by_name["dyn.trainable_weight"], np.float32)}
        return out

    weights = {f"netG.{k}": v for k, v in st["netG"].items()}
    weights["dyn.trainable_weight"] = st["dyn_weight"]
    raw["params"] = tree(weights, raw["params"])
    for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        moments[key] = tree({n: adam[i][slot] for i, n in enumerate(names)},
                            moments[key])
    Path(jax_state).write_bytes(serialization.msgpack_serialize(raw))


def _slice_resumed(slice_run, data, monkeypatch):
    """Copies of both slice runs resumed to step 4 from one step-2 state,
    the port's (carried into the JAX copy), on one CPU thread: the two
    packages then differ only by the steps compared. From their own
    step-2 states (≤ 5e-7 apart), two Adam updates of near-zero gradients
    drew the losses up to 9.3e-6 apart, close to the bar."""
    tmp = slice_run["tmp"]
    logs = {"jax": [], "port": []}
    opts = []
    for side in ("jax", "port"):
        shutil.copytree(tmp / f"{side}_train", tmp / f"{side}_resumed")
        opts.append(_train_yaml(tmp, data, f"{side}_resumed", 4, save_freq=2,
                                pretrain=slice_run["weights"], resume="auto"))
    state = Path(EXP) / "training_state/2.state"
    names = [n for n, _ in slice_run["model"].named_train_parameters()]
    _carry_port_state(tmp / "port_resumed" / state,
                      tmp / "jax_resumed" / state, names)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _train_both(monkeypatch, logs, *opts)
    finally:
        torch.set_num_threads(threads)
    text = "".join(p.read_text() for p in sorted(
        (tmp / "port_resumed" / EXP).glob("train_*.log")))
    return {"logs": logs, "port_log": _logs_by_step(text)}


def test_train_main_matches_jax(runs, data, jax_env):
    r = runs("slice", lambda tmp: _slice(tmp, data, jax_env))
    jl, pl = r["logs"]["jax"], r["logs"]["port"]
    assert len(jl) == len(pl) == 2
    for n, (got, want) in enumerate(zip(pl, jl), 1):
        assert got.keys() == want.keys()
        for k in LOG_KEYS:
            rel = abs(got[k] - want[k]) / abs(want[k])
            assert rel <= 1e-5, (n, k, got[k], want[k])
    assert r["model"].step == 2


def _eval(tmp, data, weights, monkeypatch):
    out = {"jax_sr": [], "port_sr": [], "jax_model": []}
    _record(monkeypatch, jfdc.FModelDepthCond, "test", out["jax_sr"],
            lambda m: np.asarray(m.fake_SR))
    orig = jmodels.create_model

    def keep(*a, **k):
        m = orig(*a, **k)
        out["jax_model"].append(m)
        return m

    monkeypatch.setattr(jmodels, "create_model", keep)
    _run_jax(monkeypatch, "test",
             _test_yaml(tmp, data, "jax_eval", weights, precision="fp32"))
    _record(monkeypatch, FModelDepthCond, "test", out["port_sr"],
            lambda m: m.fake_SR.numpy().copy())
    ttest.main(["-opt_F", _test_yaml(tmp, data, "port_eval", weights,
                                     precision="fp32"), "--device", "cpu"])
    for side in ("jax", "port"):
        res = tmp / f"{side}_eval/results/DepthNet_test"
        out[side] = {"tsv": (res / "result_x8.tsv").read_text().splitlines(),
                     "png": {p.name: _imread(p)
                             for p in sorted((res / "x8").glob("*.png"))}}
    return out


def _eval_runs(runs, data, monkeypatch):
    latest = runs("slice", lambda tmp: _slice(tmp, data, monkeypatch))["latest"]
    return runs("eval", lambda tmp: _eval(tmp, data, latest, monkeypatch)), latest


def test_jax_reads_the_port_checkpoint(runs, data, jax_env):
    r, latest = _eval_runs(runs, data, jax_env)
    (jm,) = r["jax_model"]
    got = from_flax(jax.tree_util.tree_map(np.asarray,
                                           jm.state.params["netG"]))
    saved = load_params(latest)
    assert got.keys() <= saved.keys()
    for k, v in got.items():
        assert torch.equal(v, saved[k]), k
    assert len(r["jax_sr"]) == len(r["port_sr"]) == 2
    for j, p in zip(r["jax_sr"], r["port_sr"]):
        assert j.shape == p.shape == (1, VAL_LR[0] * SCALE, VAL_LR[1] * SCALE, 3)
        assert float(np.abs(j - p).max()) <= 2e-4


def test_test_main_matches_jax(runs, data, jax_env):
    r, _ = _eval_runs(runs, data, jax_env)
    got, want = r["port"]["tsv"], r["jax"]["tsv"]
    assert got[0] == want[0] == "Name\tPSNR\tSSIM\tPSNR_Y\tSSIM_Y"
    assert [row.split("\t")[0] for row in got] == \
        [row.split("\t")[0] for row in want] == [want[0].split("\t")[0],
                                                 "f0", "f1", "Average"]
    for g_row, w_row in zip(got[1:], want[1:]):
        g = [float(x) for x in g_row.split("\t")[1:]]
        w = [float(x) for x in w_row.split("\t")[1:]]
        assert max(abs(g[0] - w[0]), abs(g[2] - w[2])) <= 1e-3, (g, w)
        assert max(abs(g[1] - w[1]), abs(g[3] - w[3])) <= 1e-5, (g, w)
    assert r["port"]["png"].keys() == r["jax"]["png"].keys() == {"f0.png",
                                                                 "f1.png"}
    for name, img in r["port"]["png"].items():
        ref = r["jax"]["png"][name]
        assert img.shape == ref.shape == (VAL_LR[0] * SCALE, VAL_LR[1] * SCALE, 3)
        assert int(np.abs(img.astype(int) - ref).max()) <= 1


def _logs_by_step(log_text):
    """{step: the message of its log line}."""
    out = {}
    for line in log_text.splitlines():
        if "<epoch:" in line:
            msg = line.split("INFO: ", 1)[1]
            out[int(msg.split("iter:")[1].split(",")[0].replace(",", ""))] = msg
    return out


def _log_message(epoch, step, lr, logs):
    """The training loop's log line for one step."""
    return (f"<epoch:{epoch:3d}, iter:{step:8,d}, lr:{lr:.3e}> "
            + "".join(f"{k:s}: {v:.4e} " for k, v in logs.items()))


def _replay(opt_path, state, val_dir):
    """The resume rule through the model API: ``state`` restored, then
    epoch 0's batches as steps 3 and 4, then a validation; returns
    ({step: log message}, the validation line, the model)."""
    opt = toptions.dict_to_nonedict(toptions.parse(opt_path, is_train=True))
    opt["path"]["val_images"] = str(val_dir)
    tmisc.set_random_seed(opt["train"]["manual_seed"])
    model = create_model(opt, device="cpu")
    epoch, step = model.resume_training(str(state))
    ds_opt = opt["datasets"]["train"]
    loader = create_dataloader(create_dataset(ds_opt), ds_opt, opt)
    loader.set_epoch(epoch)
    logs = {}
    for batch in loader:
        step += 1
        model.feed_data(batch)
        model.optimize_parameters(step)
        logs[step] = _log_message(epoch, step,
                                  model.get_current_learning_rate(step),
                                  model.get_current_log())
        if step == 4:
            break
    ds_val = opt["datasets"]["val"]
    psnr, ssim_v, _ = ttrain.validate(
        model, create_dataloader(create_dataset(ds_val), ds_val, opt), opt, 4)
    val = f"<epoch:{epoch:3d}, iter:{step:8d}> psnr: {psnr:.4e} ssim: {ssim_v:.4e}"
    return logs, val, model


def _resume_runs(tmp, data):
    """One run of 4 steps; one of 2 steps, resumed to 4; the replay of that
    resume through the model API. On one CPU thread: with several,
    PyTorch's CPU backward sums in an order that varies from run to run."""
    kw = dict(val_freq=4, save_freq=2, flips=True, workers=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ttrain.main(["-opt_F", _train_yaml(tmp, data, "whole", 4, **kw),
                     "--device", "cpu"])
        ttrain.main(["-opt_F", _train_yaml(tmp, data, "cut", 2, **kw),
                     "--device", "cpu"])
        resumed = _train_yaml(tmp, data, "cut", 4, resume="auto", **kw)
        ttrain.main(["-opt_F", resumed, "--device", "cpu"])
        replay = _replay(resumed, tmp / "cut" / EXP / "training_state/2.state",
                         tmp / "replay_val")
    finally:
        torch.set_num_threads(threads)
    out = {"replay": replay}
    for run in ("whole", "cut"):
        d = tmp / run / EXP
        out[run] = {
            "logs": {},
            "val": [line.split("INFO: ", 1)[1]
                    for p in sorted(d.glob("val_*.log"))
                    for line in p.read_text().splitlines() if line],
            "latest": load_params(str(d / "models/latest_G.pth")),
            "images": sorted(str(p.relative_to(d / "val_images")) for p in
                             (d / "val_images").rglob("*.png")),
            "dir": d}
        for p in sorted(d.glob("train_*.log")):
            out[run]["logs"].update(_logs_by_step(p.read_text()))
    return out


def test_resumed_run_reruns_the_saved_epoch(runs, data):
    """A run resumed from the end of epoch 0 reruns epoch 0 from its first
    batch, as the JAX ``train.py`` does: bit for bit the replay of that
    rule through the model API (logs, validation, weights, Adam state)."""
    r = runs("resume", lambda tmp: _resume_runs(tmp, data))
    whole, cut = r["whole"], r["cut"]
    logs, val, model = r["replay"]
    assert sorted(whole["logs"]) == sorted(cut["logs"]) == [1, 2, 3, 4]
    for step in (1, 2):
        assert cut["logs"][step] == whole["logs"][step], step
    for step in (3, 4):
        assert "<epoch:  0, " in cut["logs"][step]          # epoch 0 again
        assert cut["logs"][step] == logs[step], step
        assert cut["logs"][step] != whole["logs"][step], step
    assert cut["val"] == [val]
    for k, v in model.netG.state_dict().items():
        assert torch.equal(cut["latest"][k], v), k
    state = torch.load(str(cut["dir"] / "training_state/4.state"),
                       weights_only=True)
    assert (state["epoch"], state["iter"], state["step"]) == (0, 4, 4)
    want = model.optimizer_G.state_dict()["state"]
    for i, s in state["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, want[i][k]), (i, k)


def test_resumed_run_matches_jax(runs, data, jax_env):
    """Both packages resume their step-2 save to step 4 (epoch 0 again):
    the losses of steps 3 and 4 agree as the first two steps' do."""
    sl = runs("slice", lambda tmp: _slice(tmp, data, jax_env))
    r = runs("slice resumed", lambda tmp: _slice_resumed(sl, data, jax_env))
    jl, pl = r["logs"]["jax"], r["logs"]["port"]
    assert len(jl) == len(pl) == 2
    for n, (got, want) in enumerate(zip(pl, jl), 3):
        for k in LOG_KEYS:
            rel = abs(got[k] - want[k]) / abs(want[k])
            assert rel <= 1e-5, (n, k, got[k], want[k])
    assert sorted(r["port_log"]) == [1, 2, 3, 4]       # the copy's, then its own
    assert all("<epoch:  0, " in r["port_log"][n] for n in (3, 4))


def test_training_writes_checkpoints_images_and_logs(runs, data):
    r = runs("resume", lambda tmp: _resume_runs(tmp, data))
    d = r["whole"]["dir"]
    assert sorted(p.name for p in (d / "models").iterdir()) == [
        "2_G.pth", "4_G.pth", "latest_G.pth"]
    assert sorted(p.name for p in (d / "training_state").iterdir()) == [
        "2.state", "4.state"]
    assert r["whole"]["images"] == ["f0/f0_4.png", "f1/f1_4.png"]
    img = _imread(d / "val_images/f0/f0_4.png")
    assert img.shape == (VAL_LR[0] * SCALE, VAL_LR[1] * SCALE, 3)
    (log,) = d.glob("train_*.log")
    text = log.read_text()
    assert "# Validation # PSNR:" in text and "Saving the final model." in text
    state = torch.load(str(d / "training_state/4.state"), weights_only=True)
    assert (state["epoch"], state["iter"], state["step"]) == (1, 4, 4)
    latest = load_params(str(d / "models/latest_G.pth"))
    four = load_params(str(d / "models/4_G.pth"))
    assert all(torch.equal(latest[k], four[k]) for k in four)


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    for main, opt in ((ttrain.main, _train_yaml(tmp_path, data, "t", 1)),
                      (ttest.main, _test_yaml(tmp_path, data, "e", None))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-opt_F", opt])
    assert not (tmp_path / "t").exists() and not (tmp_path / "e").exists()


X23_LR = (15, 14)             # the frames' LR size at ×2 and ×3


def _x23_tree(root, scale):
    """Two test frames for ×``scale``: at ×2 a Kvasir tree (HR, LR, D), at
    ×3 a CVC-EndoSceneStill tree (the LR under ``x3/``, a split file naming
    the frames out of order)."""
    rng = np.random.default_rng(20 + scale)
    lr_dir = root / "LR" / (f"x{scale}" if scale == 3 else "")
    for d in (root / "HR", lr_dir, root / "D"):
        d.mkdir(parents=True, exist_ok=True)
    names = ["f1.png", "f0.png"]
    for name in names:
        gt = _smooth(rng, X23_LR[0] * scale, X23_LR[1] * scale)
        lr = imresize_np(gt / 255.0, 1 / scale)
        cv2.imwrite(str(root / "HR" / name), gt)
        cv2.imwrite(str(lr_dir / name),
                    np.clip(lr * 255.0, 0, 255).round().astype(np.uint8))
        np.save(root / "D" / f"{name[:-4]}_disp.npy",
                rng.random((1, 1) + X23_LR).astype(np.float32))
    (root / "test.txt").write_text("".join(n + "\n" for n in names))


def _x23_yaml(tmp, scale, run, weights):
    """The repo's test YAML at ×``scale``, ``precision`` unset; at ×3 the
    dataset block is the ×3 training YAML's EndoScene one."""
    y = yaml.safe_load(TEST_YAML.read_text())
    root = tmp / f"tree_x{scale}"
    ds = y["datasets"]["test_1"]
    ds.update(dataroot_GT=str(root / "HR"), dataroot_LQ=str(root / "LR"),
              dataroot_depthMap=str(root / "D"))
    if scale == 3:
        ds.update(mode="EndoScene_Depth", name="EndoScene_x3_test",
                  dataset_split_list=str(root / "test.txt"))
    y["scale"] = scale
    y["network_G"].update(NET)
    y["path"].update(root=str(tmp / run), pretrain_model_G=weights)
    path = tmp / f"{run}.yml"
    path.write_text(yaml.safe_dump(y))
    return str(path)


@pytest.mark.parametrize("scale", [2, 3])
def test_x2_x3_eval_serves_bf16c3_like_jax(tmp_path, jax_env, scale, caplog):
    """The ×2 and ×3 test YAMLs with ``precision`` unset: both ``test.main``
    auto-select ``bf16c3`` and serve unbucketed with one warning, on the
    same weights; the TSV rows agree to ≤ 1e-3 dB and ≤ 1e-4 SSIM
    (measured ≤ 1.2e-4 dB, ≤ 3.8e-5) and the PNGs to one level (the port's
    and JAX's bf16c3 forwards differ by fp32 summation order, ≤ 2e-4 at
    this size, ``tests/test_torch_precision.py``; a rounding at a half moves
    a level: 5–23 pixels here).
    At ×3 the frames come through ``EndoScene_Depth``."""
    _x23_tree(tmp_path / f"tree_x{scale}", scale)
    init = FModelDepthCond({"model": "sftmd_depthCond", "scale": scale,
                            "network_G": {**yaml.safe_load(
                                TEST_YAML.read_text())["network_G"], **NET},
                            "path": {"models": str(tmp_path / "init")}},
                           device="cpu")
    weights = init.save(0)
    models = []
    orig = jmodels.create_model

    def keep(*a, **k):
        models.append(orig(*a, **k))
        return models[-1]

    jax_env.setattr(jmodels, "create_model", keep)
    with caplog.at_level(logging.INFO, logger="base"):
        _run_jax(jax_env, "test", _x23_yaml(tmp_path, scale, "jax", weights))
        models.append(ttest.main(["-opt_F", _x23_yaml(tmp_path, scale, "port",
                                                      weights),
                                  "--device", "cpu"]))
    jm, pm = models
    assert jm.opt["precision"] == pm.opt["precision"] == "bf16c3"
    assert pm.netG.centered_convs == 3 and pm._bucket() == 0
    text = caplog.text
    assert text.count("precision auto-selected: bf16c3") == 2
    assert text.count("eval bucketing disabled") == 2
    out = {}
    for side in ("jax", "port"):
        res = tmp_path / side / "results/DepthNet_test"
        out[side] = ((res / f"result_x{scale}.tsv").read_text().splitlines(),
                     {p.name: _imread(p)
                      for p in sorted((res / f"x{scale}").glob("*.png"))})
    (got, gpng), (want, wpng) = out["port"], out["jax"]
    assert [r.split("\t")[0] for r in got] == [r.split("\t")[0] for r in want]
    assert len(got) == 4 and got[-1].startswith("Average")
    for g_row, w_row in zip(got[1:], want[1:]):
        g = [float(x) for x in g_row.split("\t")[1:]]
        w = [float(x) for x in w_row.split("\t")[1:]]
        assert max(abs(g[0] - w[0]), abs(g[2] - w[2])) <= 1e-3, (g, w)
        assert max(abs(g[1] - w[1]), abs(g[3] - w[3])) <= 1e-4, (g, w)
    assert gpng.keys() == wpng.keys() == {"f0.png", "f1.png"}
    for name, img in gpng.items():
        assert img.shape == wpng[name].shape == (X23_LR[0] * scale,
                                                 X23_LR[1] * scale, 3)
        assert int(np.abs(img.astype(int) - wpng[name]).max()) <= 1


@pytest.mark.parametrize("model", ["sr", "srgan", "sftgan", "predictor",
                                   "corrector", "sftmd", "sftmd_depth",
                                   "sftmd_depthSegNet"])
def test_create_model_builds_every_model(model):
    """Every model is ported: ``create_model`` builds each (a small
    generator, serving); an unknown name raises by name."""
    net, cls = PORTED_SMALL[model]
    m = create_model({"model": model, "scale": 4, "is_train": False,
                      "network_G": net, "datasets": {}, "path": {}},
                     device="cpu")
    assert type(m).__name__ == cls
    with pytest.raises(NotImplementedError, match="Model \\[nope\\]"):
        create_model({"model": "nope"}, device="cpu")


# a small generator of each model
PORTED_SMALL = {
    "sr": ({"which_model_G": "MSRResNet", "nf": 8, "nb": 1}, "SRModel"),
    "predictor": ({"which_model_G": "Predictor"}, "PModel"),
    "corrector": ({"which_model_G": "Corrector"}, "CModel"),
    "sftmd": ({"which_model_G": "SFTMD", "nb": 1}, "FModel"),
    "sftmd_depth": ({"which_model_G": "SFTMD_upsacle_after_ResBlk_depth",
                     "nb": 4, "n_depthResBlk": 1}, "FModelDepth"),
    "sftmd_depthSegNet": ({"which_model_G": "DepthNet", "nb": 4,
                           "depth_latent_ch": 16, "which_ResBlk_depth": [0]},
                          "FModelDepthSeg"),
    "srgan": ({"which_model_G": "MSRResNet", "nf": 8, "nb": 1},
              "SRGANModel"),
    "sftgan": ({"which_model_G": "sft_arch"}, "SFTGANACDModel"),
}


def test_pretrain_orbax_directory_loads_and_others_refused(tmp_path):
    """A flax ``.ckpt`` file is read now (``tests/test_torch_checkpoint.py``)
    and so is an orbax checkpoint, a directory (``tests/test_torch_orbax
    .py``): one the port wrote loads as ``pretrain_model_G``; a directory
    that is not one is refused naming the ``_METADATA`` it lacks."""
    from endosr_torch.models.base import params_tree_of
    from endosr_torch.utils import checkpoint as ckpt

    y = yaml.safe_load(TEST_YAML.read_text())
    (tmp_path / "5_G.ckpt").mkdir()
    opt = copy.deepcopy({"model": y["model"], "scale": 8,
                         "network_G": {**y["network_G"], **NET},
                         "path": {"pretrain_model_G": str(tmp_path / "5_G.ckpt")}})
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        create_model(copy.deepcopy(opt), device="cpu")
    src = create_model({**copy.deepcopy(opt), "path": {}}, device="cpu")
    ckpt.save_pytree(params_tree_of(src.netG), str(tmp_path / "6_G.ckpt"),
                     "orbax")
    opt["path"]["pretrain_model_G"] = str(tmp_path / "6_G.ckpt")
    got = create_model(opt, device="cpu").netG.state_dict()
    for k, v in src.netG.state_dict().items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("tensorboard", [True, False],
                         ids=["tensorboardX", "no_tensorboardX"])
def test_profiler_trace_and_optional_tensorboard(tmp_path, data, monkeypatch,
                                                 tensorboard):
    """``logger.profile_iter`` traces three steps with ``torch.profiler``;
    ``use_tb_logger`` writes scalars through tensorboardX, and without it
    logs that it is unavailable and trains on."""
    if tensorboard:
        pytest.importorskip("tensorboardX")
    else:
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
    path = _train_yaml(tmp_path, data, "prof", 4)
    y = yaml.safe_load(Path(path).read_text())
    y["use_tb_logger"] = True
    y["logger"]["profile_iter"] = 2
    Path(path).write_text(yaml.safe_dump(y))
    model = ttrain.main(["-opt_F", path, "--device", "cpu"])
    assert model.step == 4
    exp = tmp_path / "prof/experiments/DepthNet_ResBlk_depthMask_x8"
    trace = json.loads((exp / "profile/trace_2.json").read_text())
    assert trace["traceEvents"]
    (log,) = exp.glob("train_*.log")
    events = list((tmp_path / "prof/tb_logger").rglob("events.*"))
    if tensorboard:
        assert events
    else:
        assert not events
        assert "tensorboardX unavailable" in log.read_text()
