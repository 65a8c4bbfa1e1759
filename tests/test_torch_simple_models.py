"""The one-network trainers of the port (``sr``, ``sftmd``, ``predictor``,
``corrector``, ``sftmd_depth``) against the JAX package's models, fp32 on
the CPU, each from the JAX model's own initial weights (``from_flax``):

- the first step's logs (keys and values) to ≤ 1e-5 relative, the next
  two steps' to ≤ 2e-4;
- every gradient of the first step to ≤ 2e-4 of its tensor's largest
  magnitude, plus four times the difference between two fp32 gradients
  of the port itself (oneDNN's convolutions on and off), as
  ``tests/test_torch_train.py`` holds DepthNet's (measured ≤ 1.5e-5 of
  the largest). A conv bias right before an
  InstanceNorm (the SPADE depth blocks' ``conv1.0`` / ``conv2.0``) has a
  zero true gradient: both sides must be ≤ 1e-7 of the largest gradient
  of the step;
- the parameters after 1 and 3 updates by ``check_updates``: Adam's
  first updates are ≈ ±lr for any gradient, so where two gradients that
  agree to their rounding straddle zero (the zero-gradient biases above,
  the Corrector's last bias, a sum of ±1/20 L1 terms that cancel) the
  components move apart by up to 2·lr an update; the others hold to
  1e-2·lr after one update, and within 1 % of the distance moved in norm
  (measured ≤ 6.3e-4). After three updates, within 5 % in norm (measured
  ≤ 3.1e-5), but the depth model 10 % (measured up to 5.6 %, growing
  0.06 % → 1.3 % → 5.6 % over the three updates): at its random init
  one update of lr 1e-4 moves its output by 0.31 (the InstanceNorms
  before the SPADE blocks amplify), and Adam turns the rounding-level
  differences of its near-zero gradients into ±lr steps, which the next
  gradients carry on. (At nb 4, where the first SPADE block follows the
  head directly, the conditioning is worse still: one gradient 2.09e-4
  from JAX's, within its oneDNN-off noise, and a bias 11.4 % after three
  updates; this module holds nb 5.)
- serving: ``test`` (and ``SRModel.test_x8``, ``FModel``'s too) to ≤ 2e-4
  of the largest output, the positional ``feed_data`` forms of the
  Predictor and Corrector models as the JAX models take them.

Sizes: MSRResNet nf 16 nb 2 ×4; SFTMD (kernel-free) nb 2 ×4; Predictor
and Corrector at their defaults (nf 64, code 10) on 16² inputs;
``SFTMD_upsacle_after_ResBlk_depth`` nb 5 ×8 with the three SPADE blocks
and the learned depth upsamplers; batch 2, LR 8². The SFT networks' nf is
64: their SFT convs are 64 wide whatever nf says, in both packages.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from endosr.models import create_model as jax_create
from endosr.parallel.mesh import make_mesh
from endosr_torch.models import create_model
from endosr_torch.utils.port_params import from_flax
from tests.torch_models_common import (check_updates, grad_rel, jax_loss_fn,
                                       jax_model, model_opt, quick_flax_init,
                                       tree_np)
from tests.torch_threads import one_torch_thread  # noqa: F401

STEPS = 3
LR = 1e-4
FRAC3 = {"sftmd_depth": 0.1}    # see the module's docstring
RNG = np.random.default_rng(3)


def _u(*shape):
    return RNG.random(shape).astype(np.float32)


CASES = {
    "sr": (model_opt("sr", {"which_model_G": "MSRResNet", "nf": 16,
                            "nb": 2}),
           {"LQ": _u(2, 8, 8, 3), "GT": _u(2, 32, 32, 3)}),
    "sftmd": (model_opt("sftmd", {"which_model_G": "SFTMD", "nb": 2}),
              {"LQ": _u(2, 8, 8, 3), "GT": _u(2, 32, 32, 3)}),
    "predictor": (model_opt("predictor", {"which_model_G": "Predictor"}),
                  {"LQ": _u(2, 16, 16, 3), "real_ker": _u(2, 10)}),
    "corrector": (model_opt("corrector", {"which_model_G": "Corrector"}),
                  {"SR": _u(2, 16, 16, 3), "est_ker_map": _u(2, 10),
                   "real_ker": _u(2, 10)}),
    "sftmd_depth": (
        model_opt("sftmd_depth",
                  {"which_model_G": "SFTMD_upsacle_after_ResBlk_depth",
                   "nb": 5, "n_depthResBlk": 3, "predict_depth_map": True},
                  train_over={"depth_l1_weight": 0.5,
                              "depth_ssim_weight": 2.0}, scale=8),
        {"LQ": _u(2, 8, 8, 3), "GT": _u(2, 64, 64, 3),
         "Depth_x8": _u(2, 8, 8, 1), "Depth_x4": _u(2, 16, 16, 1),
         "Depth_x2": _u(2, 32, 32, 1)}),
}


def _run(opt, batch):
    jm = jax_model(jax_create, copy.deepcopy(opt))
    p0 = tree_np(jm.state.params)
    grads, _ = jax.jit(jax.grad(jax_loss_fn(jm), has_aux=True))(
        jm.state.params, batch)
    out = {"grads_jax": from_flax(tree_np(grads["netG"])), "logs_jax": [],
           "params_jax": {}, "logs": [], "params": {}, "jm": jm}
    jm.feed_data(batch)
    for n in range(1, STEPS + 1):
        jm.optimize_parameters(n)
        out["logs_jax"].append(dict(jm.log_dict))
        out["params_jax"][n] = from_flax(tree_np(jm.state.params["netG"]))
    tm = create_model(copy.deepcopy(opt), device="cpu")
    out["start"] = from_flax(p0["netG"])
    tm.netG.load_state_dict(out["start"], strict=True)
    tm.feed_data(batch)
    for n in range(1, STEPS + 1):
        out["logs"].append(dict(tm.optimize_parameters(n)))
        if n == 1:
            out["grads"] = {k: p.grad.clone()
                            for k, p in tm.netG.named_parameters()}
        out["params"][n] = {k: p.detach().clone()
                            for k, p in tm.netG.named_parameters()}
    out["model"] = tm
    # the rounding scale of each gradient: the port's own first gradient
    # once more with oneDNN's convolutions off (other summation orders)
    again = create_model(copy.deepcopy(opt), device="cpu")
    again.netG.load_state_dict(out["start"], strict=True)
    again.feed_data(batch)
    with torch.backends.mkldnn.flags(enabled=False):
        again.optimize_parameters()
    out["noise"] = {k: float((p.grad - out["grads"][k]).abs().max())
                    for k, p in again.netG.named_parameters()}
    return out


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run(*CASES[name])
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_logs_match_jax(runs, name):
    r = runs(name)
    for n, (got, want) in enumerate(zip(r["logs"], r["logs_jax"])):
        assert sorted(got) == sorted(want)
        tol = 1e-5 if n == 0 else 2e-4
        for k, v in want.items():
            assert abs(got[k] - v) <= tol * max(abs(v), 1e-12), \
                f"step {n + 1} {k}: {got[k]} vs {v}"


def _before_instance_norm(key):
    return key.startswith("depth-residual") and key.endswith(
        (".conv1.0.bias", ".conv2.0.bias"))


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(runs, name):
    r = runs(name)
    got, want = r["grads"], r["grads_jax"]
    assert sorted(got) == sorted(want)
    top = max(float(torch.as_tensor(g).abs().max()) for g in want.values())
    for k, w in want.items():
        if _before_instance_norm(k):
            assert max(float(w.abs().max()), float(got[k].abs().max())) \
                <= 1e-7 * top, k
            continue
        top_k = float(torch.as_tensor(w).abs().max())
        err = float((got[k] - torch.as_tensor(w)).abs().max())
        assert err <= 2e-4 * top_k + 4 * r["noise"][k], (k, err, top_k)


@pytest.mark.parametrize("n", [1, STEPS])
@pytest.mark.parametrize("name", list(CASES))
def test_parameters_after_updates_match_jax(runs, name, n):
    r = runs(name)
    check_updates(r["params"][n], r["params_jax"][n], r["start"], LR, n,
                  r["grads"], r["grads_jax"], name, FRAC3.get(name, 5e-2))


def _serve_pair(r, batch, jax_call, port_call):
    jm, tm = r["jm"], r["model"]
    # both models from the same (updated) weights
    tm.netG.load_state_dict(from_flax(tree_np(jm.state.params["netG"])))
    jm.feed_data(batch)
    tm.feed_data(batch)
    return np.asarray(jax_call(jm)), port_call(tm)


def _close(got, want):
    got = [got] if torch.is_tensor(got) else got
    want = [want] if isinstance(want, np.ndarray) else want
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        err = float(np.abs(g.detach().cpu().numpy() - w).max())
        assert err <= 2e-4 * max(float(np.abs(w).max()), 1e-12), err


@pytest.mark.parametrize("name", ["sr", "sftmd"])
def test_test_and_test_x8_match_jax(runs, name):
    r = runs(name)
    batch = {"LQ": _u(2, 7, 9, 3)}
    for method in ("test", "test_x8"):
        want, got = _serve_pair(
            r, batch, lambda m: (getattr(m, method)(), m.fake_H)[1],
            lambda m: getattr(m, method)())
        _close(got, want)
    vis = r["model"].get_current_visuals()
    assert vis["SR"].shape == (28, 36, 3) and "LQ" in vis


def test_positional_feed_data_forms_match_jax(runs):
    lq, ker = _u(2, 16, 16, 3), _u(2, 10)
    r = runs("predictor")
    r["jm"].feed_data(lq, ker)
    r["model"].feed_data(lq, ker)
    assert torch.equal(r["model"].batch["real_ker"], torch.from_numpy(ker))
    r["model"].netG.load_state_dict(
        from_flax(tree_np(r["jm"].state.params["netG"])))
    r["jm"].test()
    _close(r["model"].test(), r["jm"].fake_ker)
    assert set(r["model"].get_current_visuals()) == {"est_ker_map", "LQ",
                                                     "Batch_ker"}

    r = runs("corrector")
    est = _u(2, 10)
    r["jm"].feed_data(lq, est, ker)
    r["model"].feed_data(lq, est, ker)
    r["model"].netG.load_state_dict(
        from_flax(tree_np(r["jm"].state.params["netG"])))
    r["jm"].test()
    _close(r["model"].test(), r["jm"].fake_ker)
    r["model"].feed_data(lq, est)
    assert "real_ker" not in r["model"].batch


def test_depth_outputs_of_the_depth_model_match_jax(runs):
    r = runs("sftmd_depth")
    batch = {"LQ": _u(2, 8, 8, 3), "Depth": _u(2, 8, 8, 1)}
    want, got = _serve_pair(
        r, batch, lambda m: (m.test(), m.fake_SR)[1], lambda m: m.test())
    _close(got, want)
    jm, tm = r["jm"], r["model"]
    _close([tm.depth_x4, tm.depth_x2], [jm.depth_x4, jm.depth_x2])
    assert tm.depth_x2.shape == (2, 32, 32, 1)


def test_fmodel_feeds_kernel_codes_to_coded_generators():
    """C13: the JAX ``FModel`` feeds the LR image alone, so it cannot build
    the kernel-conditioned SFTMD; the port's feeds the batch's code
    ``ker_map`` as the reference ``F_model`` does (dict or positional
    ``feed_data(LR, GT, ker_map)``), in training, ``test`` and
    ``test_x8``."""
    opt = model_opt("sftmd", {"which_model_G": "SFTMD_kernel", "nb": 1})
    with pytest.raises(TypeError):
        with quick_flax_init(0):
            jax_create(copy.deepcopy(opt), mesh=make_mesh(jax.devices()[:1]))
    tm = create_model(copy.deepcopy(opt), device="cpu")
    lq, gt, code = _u(2, 8, 8, 3), _u(2, 32, 32, 3), _u(2, 10)
    start = {k: v.clone() for k, v in tm.netG.state_dict().items()}
    with torch.no_grad():
        want = float((tm.netG(torch.from_numpy(lq), torch.from_numpy(code))
                      - torch.from_numpy(gt)).abs().mean())
    tm.feed_data(lq, gt, code)
    logs = tm.optimize_parameters(1)
    assert logs["l_pix"] == pytest.approx(want, rel=1e-6)
    tm.netG.load_state_dict(start)
    tm.feed_data({"LQ": lq, "ker_map": code})
    sr = tm.test()
    x8 = tm.test_x8()
    assert sr.shape == x8.shape == (2, 32, 32, 3)
    with torch.no_grad():
        direct = tm.netG(torch.from_numpy(lq), torch.from_numpy(code))
    assert torch.equal(sr, direct)
