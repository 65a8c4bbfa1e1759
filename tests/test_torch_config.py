"""The port's options and entry-point helpers against the JAX package's.

``endosr_torch.config.options`` parses every YAML under ``options/`` into
the same dict as ``endosr.config.options`` (with ``root`` given and with
the default root, the repository root, in training and in test mode),
prints it the same (``dict2str``), resolves ``resume_state: auto`` to the
same file and rewrites the resume paths the same, but for the weight
file's suffix (``.pth``, the port's, where JAX reads ``.ckpt``). The
experiment tree and its archiving on a name collision are the same.
``utils/misc.py``'s ``tensor2img`` equals JAX's on arrays, and on tensors.
"""

import logging
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from endosr.config import options as jopt
from endosr.utils import misc as jmisc
from endosr_torch.config import options as topt
from endosr_torch.utils import misc as tmisc

REPO = Path(__file__).resolve().parent.parent
YAMLS = sorted((REPO / "options").rglob("*.yml"))


def _ids(p):
    return str(p.relative_to(REPO / "options"))


@pytest.mark.parametrize("root", ["given", "default"])
@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("path", YAMLS, ids=_ids)
def test_parse_and_dict2str_match_jax(path, is_train, root, tmp_path):
    r = str(tmp_path) if root == "given" else None
    got = topt.parse(str(path), is_train=is_train, root=r)
    want = jopt.parse(str(path), is_train=is_train, root=r)
    assert got == want
    assert topt.dict2str(got) == jopt.dict2str(want)
    if root == "default":
        assert got["path"]["root"] == str(REPO)


@pytest.mark.parametrize("model", ["sftmd_depthCond", "srgan"])
@pytest.mark.parametrize("path", [p for p in YAMLS if "train" in p.parts],
                         ids=_ids)
def test_check_resume_matches_jax_but_for_the_suffix(path, model, tmp_path):
    opts = []
    for mod in (topt, jopt):
        opt = mod.parse(str(path), is_train=True, root=str(tmp_path))
        opt["model"] = model
        opt["path"]["resume_state"] = str(tmp_path / "40.state")
        opt["path"]["pretrain_model_G"] = "ignored.pth"
        mod.check_resume(opt, 40)
        opts.append(opt)
    got, want = opts
    assert got["path"]["pretrain_model_G"] == os.path.join(
        got["path"]["models"], "40_G.pth")
    for key in ("pretrain_model_G", "pretrain_model_D"):
        if key in want["path"]:
            want["path"][key] = want["path"][key].replace(".ckpt", ".pth")
    assert got == want
    assert ("pretrain_model_D" in got["path"]) == (model == "srgan")


@pytest.mark.parametrize("states", [[], ["2.state", "10.state", "3.state",
                                         "latest.state", "7.state.tmp"]])
def test_resolve_resume_state_auto_matches_jax(states, tmp_path):
    path = YAMLS[-1]
    opts = [mod.parse(str(path), is_train=True, root=str(tmp_path))
            for mod in (topt, jopt)]
    if states:
        d = Path(opts[0]["path"]["training_state"])
        d.mkdir(parents=True)
        for s in states:
            (d / s).write_bytes(b"")
    for opt in opts:
        opt["path"]["resume_state"] = "auto"
    got = topt.resolve_resume_state(opts[0])
    want = jopt.resolve_resume_state(opts[1])
    assert got == want
    assert got == (os.path.join(opts[0]["path"]["training_state"], "10.state")
                   if states else None)
    assert opts[0] == opts[1]


def test_debug_name_overrides_and_nonedict(tmp_path):
    y = yaml.safe_load((REPO / "options/train/train_depthNet_SEAN_depthMask_x8.yml")
                       .read_text())
    y["name"] = "debug_x8"
    p = tmp_path / "debug.yml"
    p.write_text(yaml.safe_dump(y))
    got = topt.parse(str(p), root=str(tmp_path))
    assert got == jopt.parse(str(p), root=str(tmp_path))
    assert (got["train"]["val_freq"], got["logger"]["print_freq"],
            got["logger"]["save_checkpoint_freq"]) == (8, 1, 8)
    nd = topt.dict_to_nonedict({"a": {"b": [{"c": 1}]}})
    assert nd["missing"] is None and nd["a"]["b"][0]["missing"] is None
    assert nd == jopt.dict_to_nonedict({"a": {"b": [{"c": 1}]}})


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*"))


@pytest.mark.parametrize("is_train", [True, False])
def test_experiment_dirs_match_jax_and_archive(is_train, tmp_path, monkeypatch):
    path = str(REPO / "options/train/train_depthNet_SEAN_depthMask_x8.yml")
    stamps = iter(["a", "b", "c", "d"])
    monkeypatch.setattr(tmisc, "get_timestamp", lambda: next(stamps))
    monkeypatch.setattr(jmisc, "get_timestamp", lambda: "j")
    roots = {}
    for name, mod in (("port", topt), ("jax", jopt)):
        root = tmp_path / name
        opt = mod.parse(path, is_train=is_train, root=str(root))
        mod.setup_experiment_dirs(opt)
        roots[name] = root
    assert _tree(roots["port"]) == _tree(roots["jax"])
    opt = topt.parse(path, is_train=is_train, root=str(roots["port"]))
    top = Path(opt["path"]["experiments_root" if is_train else "results_root"])
    (top / "keep.txt").write_text("x")
    topt.setup_experiment_dirs(opt)           # a second run archives the first
    assert (top.parent / (top.name + "_archived_a") / "keep.txt").exists()
    assert not (top / "keep.txt").exists()
    opt["path"]["resume_state"] = "1.state"   # resuming keeps the tree
    (top / "keep.txt").write_text("x")
    if is_train:
        topt.setup_experiment_dirs(opt)
        assert (top / "keep.txt").exists()


@pytest.mark.parametrize("shape", [(1, 6, 5, 3), (6, 5, 3), (6, 5), (6, 5, 1)])
def test_tensor2img_matches_jax(shape):
    rng = np.random.default_rng(3)
    x = (rng.random(shape) * 1.4 - 0.2).astype(np.float32)
    want = jmisc.tensor2img(x)
    np.testing.assert_array_equal(tmisc.tensor2img(x), want)
    np.testing.assert_array_equal(tmisc.tensor2img(torch.from_numpy(x)), want)
    np.testing.assert_array_equal(
        tmisc.tensor2img(x, np.float32, (-1, 1)),
        jmisc.tensor2img(x, np.float32, (-1, 1)))


def test_loggers_close_what_they_open(tmp_path):
    lg = logging.getLogger("port_test_logger")
    before = list(lg.handlers)
    added = tmisc.setup_logger("port_test_logger", str(tmp_path), "phase",
                               screen=True, tofile=True)
    assert len(added) == 2 and lg.handlers == before + added
    lg.info("one line")
    tmisc.close_logger("port_test_logger", added)
    assert lg.handlers == before
    (log,) = tmp_path.glob("phase_*.log")
    assert log.read_text().rstrip().endswith("INFO: one line")


def test_set_random_seed_seeds_every_generator():
    import random

    tmisc.set_random_seed(7)
    first = (random.random(), np.random.random(), float(torch.rand(())))
    tmisc.set_random_seed(7)
    assert (random.random(), np.random.random(), float(torch.rand(()))) == first
    jmisc.set_random_seed(7)
    assert random.random() == first[0] and np.random.random() == first[1]

