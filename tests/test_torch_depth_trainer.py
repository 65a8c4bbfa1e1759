"""The port's depth trainer (``endosr_torch/depth/{trainer,train}.py``)
against the JAX trainer, on the CPU in fp32 at feed 64×96, batch 2.

- Two ``run_epoch`` steps of both trainers (``scheduler_step_size`` 1 on
  a three-frame set, so one step an epoch and the LR decays ×0.1 at the
  second step) from the JAX trainer's variables carried across
  (``from_flax_depth_trainer``), the same batches (the global
  ``np.random`` seeded as the port's ``RandomState``, equal dataset
  ``rng`` seeds) and JAX's noise draws: the losses of both steps ≤ 1e-5
  relative; the LR schedule; Adam's step count; and the encoders'
  BatchNorm running statistics unchanged, bit for bit, in both packages
  (``ROADMAP.md`` C8). JAX's state after step 1 is carried into the port
  before step 2, so each step starts from equal numbers: Adam's first
  step moves a component by ±lr whatever the size of its gradient, and a
  gradient within rounding of 0 takes either sign (as the SR trainer's
  tests found).
  Each parameter tensor after each step is within 2e-4 of its max |ref|
  (most are: 116 of 156 after step 1, 151 after step 2), or else every
  component within 2·lr and each component whose gradient the two
  packages agree on to 10 % (JAX's read from its first moment) within
  twice the first-order bound of Adam's response to a 10 % change,
  0.1·(1 − β₁)/(1 − β₁ᵗ)·lr at step t (reached: 0.025 and 0.0525 lr).
- ``val`` on one batch in eval mode.
- ``save_model`` → a fresh trainer's ``load_model``: every tensor, the
  optimizer state and the step bit-equal; ``load_monodepth`` and
  ``run_folder`` read the folder; a ``.ckpt`` that is no flax msgpack file
  raises naming it.
- ``python -m endosr_torch.depth.train`` through ``main(["--no_cuda",
  …])`` on a tiny tree; without ``--no_cuda`` and no CUDA device it
  raises.
- ``--use_stereo`` through the CLI (``ROADMAP.md`` C9): both packages'
  ``main`` give the dataset frames without ``'s'`` and fail on the
  missing ``stereo_T`` at the first step.
"""

import copy
import os
import random
import sys
import types

import jax
import numpy as np
import pytest
import torch

from endosr.depth import datasets as JD
from endosr.depth import options as JO
from endosr_torch.data import collate
from endosr_torch.depth import datasets as TD
from endosr_torch.depth import options as TO
from endosr_torch.depth import train as TT
from endosr_torch.depth.trainer import Trainer
from endosr_torch.utils.port_params import (from_flax_depth_trainer,
                                            load_monodepth)
from tests.torch_depth_common import (H, W, fast_flax_init, jax_noise,
                                      jax_trainer, nrel, write_sequence)
from tests.torch_threads import one_torch_thread  # noqa: F401

SEED = 4
LOSS_REL = 1e-5
PARAM_REL = 2e-4


def _argv(root, *extra):
    return ["--data_path", str(root), "--log_dir", str(root / "logs"),
            "--height", str(H), "--width", str(W), "--batch_size", "2",
            "--num_epochs", "1", "--log_frequency", "1",
            "--scheduler_step_size", "1", "--num_workers", "0", *extra]


def _stats(named):
    return {k: v.detach().clone() for k, v in named
            if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory):
    """Both trainers after two steps (one an epoch), with their losses."""
    root = tmp_path_factory.mktemp("depth_train")
    write_sequence(str(root), n=5, h=70, w=110)
    lines = ["1", "2", "3"]
    jds = JD.SequenceFolderDataset(str(root), lines, H, W, [0, -1, 1],
                                   num_scales=4, is_train=True)
    tds = TD.SequenceFolderDataset(str(root), lines, H, W, [0, -1, 1],
                                   num_scales=4, is_train=True)
    jds.rng, tds.rng = random.Random(9), random.Random(9)
    jt = jax_trainer(JO.MonodepthOptions().parse(_argv(root)), seed=SEED,
                     dataset=jds)
    jt.opt = types.SimpleNamespace(**vars(jt.opt))
    tt = Trainer(TO.MonodepthOptions().parse(_argv(root, "--no_cuda")),
                 dataset=tds, seed=SEED)
    for name, sd in from_flax_depth_trainer(jt.variables).items():
        tt.models[name].load_state_dict(sd)
    tt.noise = jax_noise
    stats0 = {n: _stats(m.named_buffers()) for n, m in tt.models.items()}
    jstats0 = {k: v.get("batch_stats") for k, v in jt.variables.items()}

    jlosses, tlosses = [], []
    jt._train_step = jt._build_train_step()
    step_fn = jt._train_step

    def recorded(*a):
        out = step_fn(*a)
        jlosses.append(jax.device_get(out[2]))
        return out

    jt._train_step = recorded
    train_step = tt.train_step
    tt.train_step = lambda *a, **k: tlosses.append(train_step(*a, **k)) \
        or tlosses[-1]
    np.random.seed(SEED)
    params = []
    for epoch in range(2):
        if epoch:
            _carry_jax_state(jt, tt)
        mu0 = _jax_adam(jt, "mu")
        jt.run_epoch()
        tt.run_epoch()
        mu1 = _jax_adam(jt, "mu")
        params.append({
            "jax": _jax_params(jt),
            # the step's gradient from Adam's first moment: mu = 0.9·mu₀ +
            # 0.1·g in both packages
            "jax_grad": {n: {k: (mu1[n][k] - 0.9 * mu0[n][k]) / 0.1
                             for k in mu1[n]} for n in mu1},
            "port": {n: {k: p.detach().clone() for k, p in
                         m.named_parameters()} for n, m in tt.models.items()},
            "port_grad": {n: {k: p.grad.clone() for k, p in
                              m.named_parameters()}
                          for n, m in tt.models.items()},
            "lr": tt.lr(tt.step - 1)})
    return dict(jt=jt, tt=tt, jlosses=jlosses, tlosses=tlosses, stats0=stats0,
                jstats0=jstats0, root=root, params=params)


def _jax_params(jt):
    return from_flax_depth_trainer(jax.tree_util.tree_map(
        np.asarray, {k: {"params": v["params"]}
                     for k, v in jt.variables.items()}))


def _jax_adam(jt, moment):
    """JAX's Adam moment ("mu" or "nu") under the port's names."""
    tree = getattr(jt.opt_state[0], moment)
    return from_flax_depth_trainer({k: {"params": v} for k, v in
                                    jax.tree_util.tree_map(np.asarray,
                                                           tree).items()})


def _carry_jax_state(jt, tt):
    """JAX's parameters and Adam state into the port trainer: the next
    step starts from the same numbers in both."""
    adam = jt.opt_state[0]
    mu, nu = _jax_adam(jt, "mu"), _jax_adam(jt, "nu")
    params = _jax_params(jt)
    with torch.no_grad():
        for n, m in tt.models.items():
            for k, p in m.named_parameters():
                p.copy_(params[n][k])
                st = tt.optimizer.state[p]
                st["exp_avg"].copy_(mu[n][k])
                st["exp_avg_sq"].copy_(nu[n][k])
                st["step"].fill_(int(adam.count))


def test_two_steps_match_jax(two_steps):
    jt, tt = two_steps["jt"], two_steps["tt"]
    assert jt.step == tt.step == 2
    assert len(two_steps["jlosses"]) == len(two_steps["tlosses"]) == 2
    for want, got in zip(two_steps["jlosses"], two_steps["tlosses"]):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert abs(got[k].item() - float(w)) <= LOSS_REL * abs(float(w)), k
    # the schedule: ×0.1 every epoch of one step
    for step in range(5):
        assert tt.lr(step) == pytest.approx(float(jt._lr_fn(step)), rel=1e-6)
    assert [s["lr"] for s in two_steps["params"]] == pytest.approx([1e-4, 1e-5])
    count = jt.opt_state[0].count
    for p in tt.parameters:
        assert tt.optimizer.state[p]["step"].item() == int(count) == 2
    # each step from equal states: the parameters after it
    over, fails = 0, []
    for t, st in enumerate(two_steps["params"], start=1):
        lr = st["lr"]
        det_tol = 2 * 0.1 * (1 - 0.9) / (1 - 0.9 ** t) * lr
        n_over, worst = 0, 0.0
        for n, ps in st["port"].items():
            for k, p in ps.items():
                p, w = p.numpy(), st["jax"][n][k].numpy()
                if nrel(p, w) <= PARAM_REL:
                    continue
                n_over += 1
                gj = st["jax_grad"][n][k].numpy()
                det = np.abs(gj) > 10 * np.abs(st["port_grad"][n][k].numpy() - gj)
                d = np.abs(p - w)
                worst = max(worst, d[det].max(initial=0.0) / lr)
                if not (d.max() <= 2 * lr * (1 + 1e-3)
                        and d[det].max(initial=0.0) <= det_tol):
                    fails.append(f"step {t} {n}.{k}: {d.max() / lr:.3g} lr, "
                                 f"{d[det].max(initial=0.0) / lr:.3g} lr "
                                 "where determined")
        print(f"step {t}: {n_over} of {len(tt.parameters)} tensors over "
              f"{PARAM_REL:g} of max |ref|; where the gradient is "
              f"determined, ≤ {worst:.3g} lr apart (bound "
              f"{det_tol / lr:.3g})")
        over += n_over
    assert not fails, fails
    assert over < 0.2 * 2 * len(tt.parameters)


def test_batchnorm_statistics_stay_as_they_were(two_steps):
    """C8: both trainers normalise by batch statistics in training and
    leave the running statistics as they were."""
    tt, jt = two_steps["tt"], two_steps["jt"]
    for name, m in tt.models.items():
        now = _stats(m.named_buffers())
        assert sorted(now) == sorted(two_steps["stats0"][name])
        for k, v in now.items():
            assert torch.equal(v, two_steps["stats0"][name][k]), f"{name}.{k}"
    for name, stats in two_steps["jstats0"].items():
        if stats:
            jax.tree_util.tree_map(np.testing.assert_array_equal,
                                   jax.tree_util.tree_map(
                                       np.asarray,
                                       jt.variables[name]["batch_stats"]),
                                   stats)
    assert sum(len(s) for s in two_steps["stats0"].values()) > 0
    # what the kept statistics cost: one update at flax's momentum (torch's
    # 0.1) moves them this far, and the encoder in eval mode gives other
    # features than the training forward
    enc = copy.deepcopy(tt.models["encoder"])
    x = tt.to_device(collate([tt.dataset[i] for i in range(2)]))[
        ("color_aug", 0, 0)]
    bns = [m for m in enc.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 0.1
    with torch.no_grad():
        feats = enc.train()(x)[-1]
        moved = max(float((m.running_mean - two_steps["stats0"]["encoder"][
            f"{n}.running_mean"]).abs().max())
            for n, m in enc.named_modules() if m in bns)
        ev = tt.models["encoder"].eval()(x)[-1]
    apart = float((ev - feats).abs().max() / feats.abs().max())
    print(f"C8: one update would move a running mean by {moved:.3g}; the "
          f"eval-mode layer4 features are {apart:.3g} of max |ref| from "
          "the training forward's")
    assert moved > 0 and apart > 0


def test_val_runs_in_eval_mode(two_steps):
    """``val`` (one batch of the validation set, without ``depth_gt``):
    finite losses of every scale, the networks left in eval mode."""
    tt = two_steps["tt"]
    tt.val_dataset = tt.dataset
    try:
        losses = tt.val()
    finally:
        tt.val_dataset = None
    assert sorted(losses) == ["loss", *(f"loss/{s}" for s in range(4))]
    assert all(np.isfinite(v) for v in losses.values())
    assert not any(m.training for m in tt.models.values())
    assert tt.val() is None


def test_save_and_load_round_trip(two_steps, tmp_path):
    tt = two_steps["tt"]
    tt.log_path = str(tmp_path)
    folder = tt.save_model()
    assert sorted(os.listdir(folder)) == ["adam.pth", "depth.pth",
                                          "encoder.pth", "pose.pth",
                                          "pose_encoder.pth"]
    enc = torch.load(os.path.join(folder, "encoder.pth"), weights_only=True)
    assert (enc["height"], enc["width"], enc["use_stereo"]) == (H, W, False)
    opts = TO.MonodepthOptions().parse(
        _argv(two_steps["root"], "--no_cuda", "--load_weights_folder", folder))
    fresh = Trainer(opts, seed=SEED + 1)
    assert fresh.step == tt.step == 2
    for name, m in tt.models.items():
        got = fresh.models[name].state_dict()
        for k, v in m.state_dict().items():
            assert torch.equal(got[k], v), f"{name}.{k}"
    for p, q in zip(tt.parameters, fresh.parameters):
        for k, v in tt.optimizer.state[p].items():
            assert torch.equal(fresh.optimizer.state[q][k], v)
    # the producer's readers take the trainer's files as they are
    t_enc, t_dec, h, w = load_monodepth(folder)
    assert (h, w) == (H, W)
    for k, v in t_enc.state_dict().items():
        assert torch.equal(v, tt.models["encoder"].state_dict()[k])
    from endosr_torch.depth.infer import run_folder

    frames = tmp_path / "frames"
    write_sequence(str(frames), n=2, h=50, w=70, names="f{}.png")
    written = run_folder(str(frames), folder, str(tmp_path / "disp"),
                         ext="png", device="cpu")
    assert [np.load(p).shape for p in written] == [(1, 1, H, W)] * 2
    # a .ckpt is read as JAX's flax msgpack file: one that is not raises
    # naming it (JAX's files load in tests/test_torch_checkpoint.py)
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    (jax_dir / "encoder.ckpt").write_bytes(b"flax")
    with pytest.raises(ValueError, match="encoder.ckpt"):
        Trainer(TO.MonodepthOptions().parse(_argv(
            two_steps["root"], "--no_cuda", "--load_weights_folder",
            str(jax_dir))))


def test_main_trains_on_the_cpu(tmp_path, capsys):
    write_sequence(str(tmp_path), n=6, h=70, w=110)
    tr = TT.main(_argv(tmp_path, "--no_cuda", "--num_layers", "18"))
    assert tr.step == 2 and tr.device.type == "cpu"
    assert "epoch 0 | step 2 | loss" in capsys.readouterr().out
    folder = tmp_path / "logs" / "mdp" / "models" / "weights_0"
    assert sorted(os.listdir(folder)) == ["adam.pth", "depth.pth",
                                          "encoder.pth", "pose.pth",
                                          "pose_encoder.pth"]


def test_main_takes_cuda_unless_asked(tmp_path, monkeypatch):
    write_sequence(str(tmp_path), n=4, h=70, w=110)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.main(_argv(tmp_path))


def test_cli_use_stereo_fails_in_both_packages(tmp_path, monkeypatch):
    """C9: ``--use_stereo`` through the CLI appends 's' to the trainer's
    frames, not to the dataset's, so the first step asks for a
    ``stereo_T`` no item has."""
    from endosr.depth import train as jax_train
    from endosr.depth import trainer as jax_trainer_module

    class FastInit(jax_trainer_module.Trainer):
        def __init__(self, *a, **kw):
            with fast_flax_init(0):
                super().__init__(*a, **kw)

    write_sequence(str(tmp_path), n=5, h=70, w=110)
    argv = _argv(tmp_path, "--use_stereo")
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    monkeypatch.setattr(jax_trainer_module, "Trainer", FastInit)
    with pytest.raises(KeyError, match="stereo_T"):
        jax_train.main()
    with pytest.raises(KeyError, match="stereo_T"):
        TT.main([*argv, "--no_cuda"])
    ds = TT.build_dataset(TO.MonodepthOptions().parse(argv))
    assert ds.frame_idxs == [0, -1, 1] and "stereo_T" not in ds[0]
