"""The port's FModelDepthCond serving against the JAX FModelDepthCond.

Both serve the same batch of 10 (chunked as 8 + 2) on the unbucketed path
(``eval_bucket_multiple: 0``) with the JAX model's parameters carried
across by ``from_flax``; CPU, fp32, ≤ 2e-4 max abs (the repo's parity
bar). Also: without CUDA, building the serving model with no device raises,
and the options the port does not serve yet raise.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from endosr.models.f_depthcond import FModelDepthCond as JaxModel
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.utils.port_params import from_flax

OPT = {
    "is_train": False, "model": "sftmd_depthCond", "scale": 8,
    "precision": None, "eval_bucket_multiple": 0,
    "datasets": {"test": {"depthMaskNum": 4, "LR_size": 8}},
    "network_G": {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3,
                  "nf": 64, "nb": 6, "depth_latent_ch": 16,
                  "which_ResBlk_depth": [0, 1, 2],
                  "use_trainable_params": True},
    "path": {},
}


def _batch(b=10, lr=8):
    rng = np.random.default_rng(21)
    return {"LQ": rng.random((b, lr, lr, 3), dtype=np.float32),
            "Depth": rng.random((b, lr, lr, 1), dtype=np.float32),
            "DepthMaskList": (rng.random((b, lr, lr, 4)) > 0.6).astype(np.float32)}


def test_serving_batch_of_10_matches_jax():
    batch = _batch()
    jm = JaxModel(copy.deepcopy(OPT))
    jm.feed_data(batch)
    jm.test()
    want = np.asarray(jm.fake_SR)

    tm = FModelDepthCond(copy.deepcopy(OPT), device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jm.state.params["netG"])
    tm.netG.load_state_dict(from_flax(params))
    tm.feed_data(batch)
    got = tm.test().numpy()
    assert got.shape == want.shape == (10, 64, 64, 3)
    err = float(np.abs(got - want).max())
    assert err <= 2e-4, f"max |Δ| {err:.3g}"


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FModelDepthCond(copy.deepcopy(OPT))


@pytest.mark.parametrize("change", [
    {"eval_bucket_multiple": 32}, {"eval_bucket_multiple": None},
    {"precision": "bf16c3"}, {"scale": 4}, {"is_train": True},
], ids=["bucketed", "bucketed_default", "bf16c3", "x4", "train"])
def test_unported_options_raise(change):
    opt = {**copy.deepcopy(OPT), **change}
    with pytest.raises(NotImplementedError):
        FModelDepthCond(opt, device="cpu")


def test_test_x8_raises():
    with pytest.raises(NotImplementedError):
        FModelDepthCond(copy.deepcopy(OPT), device="cpu").test_x8()
