"""Spatial (H) sharding of DepthNet serving (``endosr_torch/parallel/
spatial.py``) and the profiling hooks (``endosr_torch/utils/prof.py``), on
the CPU.

The sharded runs are two gloo ranks started as ``torchrun`` starts them
(``tests/torch_dist_common.py``), every rank on the same whole inputs,
each computing its slab of rows with the halo, statistics and pooling
exchanges; every rank ends with the whole SR.

- ``spatial_forward`` of a ×2 DepthNet (JAX's own spatial test's fields:
  depth blocks 0, 1, 14, 15, latent 32, K 10) at world 2 on a 32×32 frame
  equals the port's single forward and JAX's single-device forward on the
  same weights (≤ 2e-4, JAX's bar); each rank holds the whole SR.
- ``spatial_shard: 2`` through ``FModelDepthCond.test`` on the 30×18
  frame of ``tests/test_spatial_parallel.py`` (``eval_bucket_multiple:
  4``, raised to lcm(4, 8) = 8 on H) equals the unsharded ``test()`` to
  ≤ 1e-4.
- JAX's guards with JAX's messages: an H that does not divide the mesh
  (``shard_spatial``), slabs of < 4 rows (``shard_spatial``,
  ``spatial_forward``); ``spatial_shard`` ignored with a warning where
  bucketing is off; ``spatial_shard: N`` without N ranks raises;
  ``spatial_jit`` raises by name.
- ``utils/prof.py``: ``trace`` writes a Chrome trace holding an
  ``annotate``d name, ``timed`` returns a median and the output.
"""

import copy
import json
import logging

import jax
import numpy as np
import pytest
import torch

from endosr.nn.depthnet import DepthNet as JaxDepthNet
from endosr.parallel.mesh import make_mesh
from endosr.parallel.spatial import _check_min_rows as jax_check_min_rows
from endosr.parallel.spatial import shard_spatial as jax_shard_spatial
from endosr_torch.config.options import dict_to_nonedict
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.nn.depthnet import DepthNet
from endosr_torch.parallel.spatial import spatial_jit
from endosr_torch.utils.port_params import from_flax, seeded_init
from endosr_torch.utils.prof import annotate, timed, trace
from tests.torch_dist_common import run_ranks
from tests.torch_models_common import quick_flax_init, tree_np
from tests.torch_threads import one_torch_thread  # noqa: F401

K = 10
NET = dict(which_resblk_depth=(0, 1, 14, 15), scale=2, depth_latent_ch=32,
           depth_range_num=K)


def _inputs(b=1, h=32, w=32, seed=11):
    rng = np.random.default_rng(seed)
    lq = rng.random((b, h, w, 3), dtype=np.float32)
    dep = rng.random((b, h, w, 1), dtype=np.float32)
    bins = rng.integers(0, K, (b, h, w))
    mk = (bins[..., None] == np.arange(K)).astype(np.float32)
    return lq, dep, mk


def test_spatial_forward_matches_single_and_jax(tmp_path):
    lq, dep, mk = _inputs()
    jnet = JaxDepthNet(**NET)
    with quick_flax_init(0):
        params = jnet.init(jax.random.PRNGKey(0), lq, dep, mk)["params"]
    want_jax = np.asarray(jnet.apply({"params": params}, lq, dep, mk))
    net = DepthNet(**NET, device="cpu")
    net.load_state_dict(from_flax(tree_np(params)), strict=True)
    net.eval()
    with torch.inference_mode():
        want = net(*(torch.from_numpy(a) for a in (lq, dep, mk)))
    payload = {"net": NET, "state": net.state_dict(),
               "inputs": {"lq": lq, "dep": dep, "mk": mk}}
    for r in run_ranks("spatial_forward_job", 2, payload, tmp_path):
        got = r["sr"]
        assert got.shape == want.shape == (1, 64, 64, 3)
        assert float((got - want).abs().max()) <= 2e-4
        np.testing.assert_allclose(got.numpy(), want_jax, rtol=2e-4,
                                   atol=2e-4)


def _serving_opt(spatial_shard=2, bucket=4):
    return dict_to_nonedict({
        "is_train": False, "model": "sftmd_depthCond", "scale": 2,
        "datasets": {"test": {"phase": "test", "depthMaskNum": K,
                              "LR_size": 16}},
        "network_G": {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3,
                      "nf": 64, "nb": 16, "depth_latent_ch": 32,
                      "use_trainable_params": True, "norm_gamma": 0,
                      "norm_beta": 0, "which_ResBlk_depth": [0, 1]},
        "path": {}, "spatial_shard": spatial_shard,
        "eval_bucket_multiple": bucket})


def _serving_batch(h=30, w=18):
    rng = np.random.default_rng(3)
    return {"LQ": rng.random((1, h, w, 3)).astype(np.float32),
            "Depth": rng.random((1, h, w, 1)).astype(np.float32),
            "DepthMaskList": (rng.random((1, h, w, K)) > 0.9).astype(
                np.float32)}


def test_spatial_shard_serving_surface(tmp_path):
    """30×18 (bucket- and mesh-misaligned), as JAX's serving test."""
    batch = _serving_batch()
    model = FModelDepthCond(_serving_opt(spatial_shard=0), device="cpu")
    seeded_init(model.netG, 5)
    model.feed_data(batch)
    single = model.test().clone()
    ranks = run_ranks("spatial_serving", 2,
                      {"opt": copy.deepcopy(_serving_opt()),
                       "state": model.netG.state_dict(), "batch": batch},
                      tmp_path)
    mesh = make_mesh(jax.devices()[:2])
    with pytest.raises(AssertionError) as indivisible:
        jax_shard_spatial((np.zeros((1, 7, 8, 3), np.float32),), mesh)
    with pytest.raises(ValueError) as degenerate:
        jax_check_min_rows(6, 2)
    for r in ranks:
        assert r["sr"].shape == single.shape == (1, 60, 36, 3)
        assert float((r["sr"] - single).abs().max()) <= 1e-4
        assert r["errors"]["indivisible"] == ("AssertionError",
                                              str(indivisible.value))
        assert r["errors"]["degenerate"] == ("ValueError",
                                             str(degenerate.value))
        assert r["errors"]["forward"] == ("ValueError", str(degenerate.value))
        assert "H ≥ 4·mesh" in r["errors"]["degenerate"][1]


def test_spatial_shard_ignored_without_bucketing(caplog):
    """As JAX: the unbucketed path cannot shard (the fused epilogue, the
    ablations, the centered precisions), so ``spatial_shard`` is ignored
    with a warning there; bucketed without the ranks it raises."""
    batch = _serving_batch(16, 12)
    model = FModelDepthCond(_serving_opt(bucket=0), device="cpu")
    model.feed_data(batch)
    with caplog.at_level(logging.WARNING, logger="base"):
        sr = model.test()
    assert sr.shape == (1, 32, 24, 3)
    assert "spatial_shard ignored" in caplog.text
    bucketed = FModelDepthCond(_serving_opt(), device="cpu")
    bucketed.feed_data(batch)
    with pytest.raises(ValueError, match="spatial_shard: 2 needs 2 ranks"):
        bucketed.test()


def test_spatial_jit_is_not_ported():
    with pytest.raises(NotImplementedError, match="spatial_jit"):
        spatial_jit(lambda p, x: x)


def test_trace_writes_an_annotated_chrome_trace(tmp_path):
    with trace(str(tmp_path), "t", cuda=False):
        with annotate("endosr_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert any(e.get("name") == "endosr_region" for e in events)


def test_timed_returns_a_median():
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2, {"n": len(calls)})

    secs, out = timed(fn, torch.ones(3), iters=5)
    assert isinstance(secs, float) and secs >= 0.0
    assert len(calls) == 6 and torch.equal(out[0], torch.full((3,), 2.0))
