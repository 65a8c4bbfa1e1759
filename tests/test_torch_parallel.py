"""Data-parallel training of the port (``endosr_torch/parallel/mesh.py``)
against the JAX package's global-batch step, on the CPU over gloo.

Each port run at world 2 is two processes started as ``torchrun`` starts
its ranks (``tests/torch_dist_common.py``), each on its half of the
global batch (``shard_batch``); the JAX model runs the whole batch as one
program over the virtual 8-device CPU mesh (batch 8 sharded 1 a device).

- **Loader.** The port's shards (``EpochBatchSampler``: padded index
  space, rank-strided slices) equal JAX's ``ShardedLoader._indices()``
  for world 1, 2 and 3, with and without a ``dataset_enlarge_ratio``,
  batch by batch; under ``opt["dist"]`` ``create_dataloader`` takes
  ``batch_size // world`` and the ratio 200 when unset, as JAX's.
- **Flagship step** (``FModelDepthCond``, the ×8 smoke net of
  ``tests/test_torch_train.py``, its flagship recipe: L1 + dynamic
  SmoothL1, global batch 8 whose halves' mask areas differ ~30×): the
  logs, gradients and the parameters after 1 and 3 updates of each rank
  with ``tests/test_torch_train.py``'s bars against the port's world-1
  step on the whole batch and against JAX's train step run as one
  program (``jax``); against JAX's step on the mesh (``jax_mesh``) with
  those bars + the distance between JAX's two runs of its own step. On
  this batch that distance is large: the mesh's 8-way sums give some
  gradient components of ~1e-9 that are 20 % off the one-program value
  (``encoder.layer4.weight_v``: 3.141e-9 against 3.985e-9, the port's
  3.985e-9; ``tests/jax_mesh_gradient_probe.py`` prints these), and
  Adam's first step, ``lr·g / (|g| + 1e-8)``, turns that into 1.7·lr
  between JAX's own two updates. Both ranks' parameters bit-equal. The control: the mask
  losses' ratios of each rank's own sums (a per-rank-mean dynamic loss)
  miss the log bar by more than 10×.
- **BatchNorm model** (SRGAN ``ragan``, ``tests/test_torch_gan.py``'s
  MSRResNet and Discriminator_VGG_128 at batch 4): the logs at the GAN
  test's bars, D's running statistics ≤ 1e-6 and D's first update
  against JAX's; every step's logs, statistics and parameters against the
  port's world-1 run. The control: D's statistics of each rank's own half
  are far from them.
- **torchrun.** ``python -m torch.distributed.run --nproc_per_node 2 -m
  endosr_torch.train ... --device cpu`` trains over gloo; rank 0 alone
  writes the experiment tree and its log file.
"""

import copy
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from endosr.data import ShardedLoader
from endosr.data import create_dataloader as jax_create_dataloader
from endosr.models import create_model as jax_create
from endosr.models.f_depthcond import FModelDepthCond as JaxModel
from endosr.parallel.mesh import make_mesh, replicate
from endosr_torch.data import EpochBatchSampler, create_dataloader
from endosr_torch.models import create_model
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.utils.port_params import from_flax_train
from tests.test_torch_entry import N_TRAIN, _train_yaml, data  # noqa: F401
from tests.test_torch_gan import (LOGIT_LOGS, _gan_state, _load, _srgan_opt,
                                  _weights)
from tests.test_torch_train import FLAGSHIP, K, LR, SCALE, _jax_loss_fn, _opt
from tests.torch_dist_common import _run_steps, run_ranks
from tests.torch_models_common import quick_flax_init, tree_np
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --------------------------------------------------------------- loader


@pytest.mark.parametrize("ratio", [1, 3])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_shards_match_jax_sharded_loader(world, ratio):
    n, bs = 11, 2
    for rank in range(world):
        for epoch in (0, 1):
            jl = ShardedLoader(list(range(n)), bs, shuffle=True, seed=7,
                               ratio=ratio, num_shards=world,
                               shard_index=rank, prefetch=0)
            jl.set_epoch(epoch)
            s = EpochBatchSampler(n, bs, shuffle=True, seed=7, ratio=ratio,
                                  num_shards=world, shard_index=rank)
            s.set_epoch(epoch)
            np.testing.assert_array_equal(s.indices(), jl._indices())
            assert len(s) == len(jl)
            want = [list(jl._indices()[i * bs:(i + 1) * bs])
                    for i in range(len(jl))]
            assert list(s) == want


@pytest.mark.parametrize("ratio", [None, 4])
def test_create_dataloader_under_dist_matches_jax(monkeypatch, ratio):
    """``opt["dist"]`` at world 2, rank 1: a batch of ``batch_size // 2``,
    the ratio 200 when unset, rank 1's shard."""
    import endosr_torch.data as tdata

    monkeypatch.setattr(tdata, "_shard", lambda: (2, 1))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    ds_opt = {"phase": "train", "batch_size": 4, "n_workers": 0}
    if ratio:
        ds_opt["dataset_enlarge_ratio"] = ratio
    opt = {"dist": True, "train": {"manual_seed": 3}}
    got = create_dataloader(list(range(9)), ds_opt, opt).batch_sampler
    want = jax_create_dataloader(list(range(9)), ds_opt, opt)
    assert got.batch_size == want.batch_size == 2
    assert got.ratio == want.ratio == (ratio or 200)
    np.testing.assert_array_equal(got.indices(), want._indices())

# ------------------------------------------------------- flagship step


B = 8
STEPS = 3


def _unequal_batch(seed=11):
    """The global batch: the first half's masks nearly full, the second's
    nearly empty (each rank's mask area ~30× the other's)."""
    rng = np.random.default_rng(seed)
    masks = np.concatenate([rng.random((B // 2, LR, LR, K)) > 0.1,
                            rng.random((B // 2, LR, LR, K)) > 0.97])
    return {"LQ": rng.random((B, LR, LR, 3), dtype=np.float32),
            "GT": rng.random((B, LR * SCALE, LR * SCALE, 3), dtype=np.float32),
            "Depth": rng.random((B, LR, LR, 1), dtype=np.float32),
            "DepthMaskList": masks.astype(np.float32)}


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    opt = _opt(FLAGSHIP)
    batch = _unequal_batch()
    mesh = make_mesh(jax.devices()[:8])
    with quick_flax_init(0):
        jm = JaxModel(copy.deepcopy(opt), mesh=mesh)
    state0 = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.state))
    jm.state = jm.state.replace(step=replicate(jm.state.step, mesh))
    rng = np.random.default_rng(FLAGSHIP["manual_seed"])
    bins = [np.int32(rng.integers(0, K)) for _ in range(STEPS)]
    grads, _ = jax.jit(jax.grad(_jax_loss_fn(jm), has_aux=True))(
        state0.params, dict(batch, mask_bin=bins[0]))
    start = from_flax_train(tree_np(state0.params))
    out = {"start": start}
    for ref in ("jax", "jax_mesh"):
        out[ref] = {"grads": from_flax_train(tree_np(grads)), "logs": [],
                    "params": {}}
    # JAX's train step as one program on one device, the mask bins its
    # host RNG draws
    one_program, state = jax.jit(jm._train_step.__wrapped__), state0
    for n in range(1, STEPS + 1):
        state, logs = one_program(state, dict(batch, mask_bin=bins[n - 1]))
        out["jax"]["logs"].append(_flat_logs(jax.device_get(logs)))
        out["jax"]["params"][n] = from_flax_train(tree_np(state.params))
    jm.feed_data(batch)
    for n in range(1, STEPS + 1):
        jm.optimize_parameters(n)
        out["jax_mesh"]["logs"].append(dict(jm.log_dict))
        out["jax_mesh"]["params"][n] = from_flax_train(
            tree_np(jm.state.params))

    def world1(flags=None):
        m = FModelDepthCond(copy.deepcopy(opt), device="cpu")
        with torch.no_grad():
            for name, p in m.named_train_parameters():
                p.copy_(start[name])
        if flags is None:
            return _run_steps(m, batch, STEPS)
        with flags:
            return _run_steps(m, batch, 1)

    out["world1"] = world1()
    again = world1(torch.backends.mkldnn.flags(enabled=False))
    out["noise"] = {k: float((g - out["world1"]["grads"][k]).abs().max())
                    for k, g in again["grads"].items()}
    payload = {"opt": copy.deepcopy(opt), "start": start, "batch": batch,
               "steps": STEPS}
    out["ranks"] = run_ranks("flagship_step", 2, payload,
                             tmp_path_factory.mktemp("dp"))
    out["control"] = run_ranks(
        "flagship_step", 2, dict(payload, steps=1, local_ratios=True),
        tmp_path_factory.mktemp("dp_control"))
    out["lr"] = FLAGSHIP["lr_G"]
    return out


def _flat_logs(logs):
    """JAX's step logs as ``FModelDepthCond.log_dict`` reads them."""
    out = {}
    for k, v in logs.items():
        if k in ("dyn_w", "dyn_l"):
            out.update({f"{k}_{i}": float(x) for i, x in enumerate(v)})
        else:
            out[k] = float(v)
    return out


def _log_errors(got, want):
    """{key: |Δ| / |want|} of one step's logs (the same keys)."""
    assert sorted(got) == sorted(want)
    return {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()}


@pytest.mark.parametrize("ref", ["jax", "jax_mesh", "world1"])
def test_flagship_logs_match(flagship, ref):
    """Step 1 ≤ 1e-5 relative, steps 2–3 ≤ 2e-4 (``tests/test_torch_train.py``'s
    bars); against JAX's mesh step, + each log's distance between JAX's
    two runs of its step (|a − c| ≤ |a − b| + |b − c|)."""
    want = flagship[ref]["logs"]
    for rank in flagship["ranks"]:
        for n, (got, w) in enumerate(zip(rank["logs"], want)):
            tol = 1e-5 if n == 0 else 2e-4
            jax_apart = _log_errors(flagship["jax"]["logs"][n], w)
            for k, e in _log_errors(got, w).items():
                bar = tol + (jax_apart[k] if ref == "jax_mesh" else 0)
                assert e <= bar, f"{ref} step {n + 1} {k}: {e:.3g} > {bar:.3g}"
    assert {"l_dynamic", "dyn_l_0", "dyn_w_0"} <= set(want[0])


@pytest.mark.parametrize("ref", ["jax", "world1"])
def test_flagship_gradients_match(flagship, ref):
    want, noise = flagship[ref]["grads"], flagship["noise"]
    top = max(float(g.abs().max()) for g in want.values())
    for rank in flagship["ranks"]:
        got = rank["grads"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            err = float((got[k] - w).abs().max())
            tol = 2e-4 * float(w.abs().max()) + 4 * noise[k] + 1e-7 * top
            assert err <= tol, f"{ref} {k}: {err:.3g} > {tol:.3g}"


def _param_errors(got, want, start, grads, grads_ref, lr):
    """``tests/test_torch_train.py``'s readings: (well-determined
    components' max |Δ| / lr, max |Δ| / lr, ‖Δ‖ / ‖movement‖)."""
    well_worst = worst = num = den = 0.0
    for k, w in want.items():
        d = (got[k] - w).abs()
        worst = max(worst, float(d.max()) / lr)
        err_g = float((grads[k] - grads_ref[k]).abs().max())
        well = grads_ref[k].abs() > 10 * err_g
        if well.any():
            well_worst = max(well_worst, float(d[well].max()) / lr)
        num += float(d.square().sum())
        den += float((w - start[k]).square().sum())
    return well_worst, worst, (num / den) ** 0.5


@pytest.mark.parametrize("updates", [1, STEPS])
@pytest.mark.parametrize("ref", ["jax", "jax_mesh", "world1"])
def test_flagship_parameters_match(flagship, ref, updates):
    """``tests/test_torch_train.py``'s bars; against JAX's mesh step, +
    the same reading between JAX's two runs of its step (over the same
    components: max |Δ| and ‖Δ‖ obey the triangle inequality)."""
    r0, r1 = flagship["ranks"]
    assert all(torch.equal(r0["params"][updates][k], v)
               for k, v in r1["params"][updates].items())
    want, start = flagship[ref]["params"][updates], flagship["start"]
    lr, grads_ref = flagship["lr"], flagship[ref]["grads"]
    got = _param_errors(r0["params"][updates], want, start, r0["grads"],
                        grads_ref, lr)
    jax_apart = (0.0, 0.0, 0.0)
    if ref == "jax_mesh":
        jax_apart = _param_errors(flagship["jax"]["params"][updates], want,
                                  start, r0["grads"], grads_ref, lr)
    (well_worst, worst, rel), (a_well, a_worst, a_rel) = got, jax_apart
    assert worst <= 2 * updates + a_worst, (worst, a_worst)
    if updates == 1:
        assert well_worst <= 1e-2 + a_well, (well_worst, a_well)
        assert rel <= 1e-2 + a_rel, (rel, a_rel)
    else:
        assert rel <= 5e-2 + a_rel, (rel, a_rel)


def test_per_rank_dynamic_loss_misses_the_bar(flagship):
    """The teeth: ratios of each rank's own sums (the mean of per-rank
    dynamic losses) are ≫ 10× the step-1 log bar off JAX's."""
    err = _log_errors(flagship["control"][0]["logs"][0],
                      flagship["jax"]["logs"][0])
    assert err["l_dynamic"] > 10 * 1e-5, err["l_dynamic"]
    assert max(err[f"dyn_l_{i}"] for i in range(K)) > 10 * 1e-5
    # the pixel loss, a mean of per-sample terms, holds either way
    assert err["l_pix"] <= 1e-5

# ------------------------------------------------------ BatchNorm model


GAN_B, GAN_STEPS, GAN_LR = 4, 4, 1e-4


@pytest.fixture(scope="module")
def srgan(tmp_path_factory):
    from tests.test_torch_gan import GAN_SIDE, _u
    from tests.torch_models_common import jax_model

    opt = _srgan_opt("ragan")
    batch = {"LQ": _u(GAN_B, GAN_SIDE, GAN_SIDE, 3, seed=12),
             "GT": _u(GAN_B, 4 * GAN_SIDE, 4 * GAN_SIDE, 3, seed=13)}
    jm = jax_model(jax_create, copy.deepcopy(opt))
    out = {"jax_states": [_gan_state(jm)], "jax_logs": []}
    jm.feed_data(batch)
    for n in range(1, 3):
        jm.optimize_parameters(n)
        out["jax_logs"].append(dict(jm.log_dict))
        out["jax_states"].append(_gan_state(jm))
    g0, d0 = out["jax_states"][0]

    def run(steps):
        tm = create_model(copy.deepcopy(opt), device="cpu")
        _load(tm, (g0, d0))
        tm.feed_data(batch)
        res = {"logs": [], "G": {}, "D": {}}
        for n in range(1, steps + 1):
            res["logs"].append(dict(tm.optimize_parameters(n)))
            res["G"][n] = {k: v.clone() for k, v in tm.netG.state_dict().items()}
            res["D"][n] = {k: v.clone() for k, v in tm.netD.state_dict().items()}
        return res

    out["world1"] = run(GAN_STEPS)
    payload = {"opt": copy.deepcopy(opt), "netG": g0, "netD": d0,
               "batch": batch, "steps": GAN_STEPS}
    out["ranks"] = run_ranks("srgan_step", 2, payload,
                             tmp_path_factory.mktemp("srgan"))
    out["start"] = (g0, d0)

    # the control: one rank's half alone, D's statistics of its own batch
    half = create_model(copy.deepcopy(opt), device="cpu")
    _load(half, (g0, d0))
    half.feed_data({k: v[:GAN_B // 2] for k, v in batch.items()})
    half.optimize_parameters(1)
    out["half_stats"] = {k: v.clone() for k, v in half.netD.state_dict().items()
                         if "running" in k}
    return out


def _stats(sd):
    return {k: v for k, v in sd.items() if "running" in k}


def _logs_within(got, want, tol, label):
    for k, e in _log_errors(got, want).items():
        assert e <= LOGIT_LOGS.get(k, tol), f"{label} {k}: {e:.3g}"


def test_srgan_batchnorm_step_matches_jax(srgan):
    for rank in srgan["ranks"]:
        _logs_within(rank["logs"][0], srgan["jax_logs"][0], 1e-5, "step 1")
        want = _stats(srgan["jax_states"][1][1])
        for k, v in _stats(rank["D"][1]).items():
            assert float((v - want[k]).abs().max()) <= 1e-6, k
        # D's first update: within Adam's ±lr, 1 % of its move in norm
        _, d0 = srgan["start"]
        got, want_w = _weights(rank["D"][1]), _weights(srgan["jax_states"][1][1])
        num = sum(float((got[k] - w).square().sum()) for k, w in want_w.items())
        den = sum(float((w - d0[k]).square().sum()) for k, w in want_w.items())
        assert max(float((got[k] - w).abs().max())
                   for k, w in want_w.items()) <= 2 * GAN_LR
        assert (num / den) ** 0.5 <= 1e-2


def test_srgan_batchnorm_steps_match_world1(srgan):
    ref = srgan["world1"]
    r0, r1 = srgan["ranks"]
    for n in range(1, GAN_STEPS + 1):
        _logs_within(r0["logs"][n - 1], ref["logs"][n - 1], 1e-5, f"step {n}")
        for net in ("G", "D"):
            assert all(torch.equal(r0[net][n][k], v)
                       for k, v in r1[net][n].items()), (net, n)
        for k, v in _stats(r0["D"][n]).items():
            assert float((v - ref["D"][n][k]).abs().max()) <= 1e-6, (n, k)
        for net, updates in (("D", n), ("G", n // 2)):
            if not updates:
                continue
            got, want = _weights(r0[net][n]), _weights(ref[net][n])
            worst = max(float((got[k] - w).abs().max()) for k, w in want.items())
            assert worst <= 2 * GAN_LR * updates, (net, n, worst)


def test_srgan_local_batchnorm_statistics_differ(srgan):
    """The control: one rank's half alone moves D's statistics away from
    the global batch's (by far more than the 1e-6 bar)."""
    want = _stats(srgan["world1"]["D"][1])
    worst = max(float((v - want[k]).abs().max())
                for k, v in srgan["half_stats"].items())
    assert worst > 1e-3, worst

# ------------------------------------------------------------- torchrun


def test_torchrun_trains_over_gloo(tmp_path, data):  # noqa: F811
    path = _train_yaml(tmp_path, data, "dp", niter=2, save_freq=2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port", str(port), "-m",
         "endosr_torch.train", "-opt_F", path, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    root = tmp_path / "dp" / "experiments" / yaml.safe_load(
        open(path))["name"]
    assert sorted(p.name for p in (root / "models").iterdir()) == [
        "2_G.pth", "latest_G.pth"]
    assert (root / "training_state" / "2.state").is_file()
    logs = [p for p in root.iterdir() if p.name.startswith("train_")]
    assert len(logs) == 1                  # rank 0's alone
    text = logs[0].read_text()
    # world 2: 1 sample a rank, the ratio 200 of an unset
    # dataset_enlarge_ratio (as JAX's), N_TRAIN·200/2 iterations an epoch
    assert f"iters per epoch: {N_TRAIN * 200 // 2}" in text, text[-2000:]
    steps = [ln for ln in text.splitlines() if "l_all:" in ln]
    assert len(steps) == 2 and all("nan" not in ln for ln in steps)
