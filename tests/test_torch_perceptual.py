"""The port's VGG features and its VGG and depth losses against the JAX
package's, on the CPU, in fp32.

- ``VGGFeatures`` (vgg19, taps ``[4, 9, 18, 27]``: pool1–pool4, input
  32×32, the ImageNet normalization on and off) from a seeded
  torchvision-layout file that both packages read: every tap ≤ 1e-4 of
  max |ref|; the same from flax-initialised params carried across by
  ``from_flax_vgg``, and the ``max_layer`` walk (a conv's ReLU cut off).
- ``VGGDepthLoss`` (each criterion), ``PerceptualLoss`` (tap 34, L1) and
  ``DepthEstimatorLoss`` (each criterion, all four scales weighted, SR
  28×36 resized up to the 64×96 feed) on the same files: each value
  ≤ 1e-5 relative to JAX's and its gradient with respect to SR ≤ 1e-4 of
  its max against ``jax.grad``; no gradient reaches the HR image or the
  frozen networks.
- Missing weight files raise ``FileNotFoundError`` with JAX's message; the
  port's own seeded VGG init (no file) is deterministic in the seed.
"""

import jax
import numpy as np
import pytest
import torch

from endosr.losses.depth import DepthEstimatorLoss as JaxDepthLoss
from endosr.losses.perceptual import PerceptualLoss as JaxPerceptual
from endosr.losses.perceptual import VGGDepthLoss as JaxVGGLoss
from endosr.nn.vgg import VGGFeatures as JaxVGG
from endosr.nn.vgg import load_vgg_params
from endosr_torch.losses import DepthEstimatorLoss, PerceptualLoss, VGGDepthLoss
from endosr_torch.nn.vgg import VGG_CFGS, VGGFeatures, load_vgg_state
from endosr_torch.utils.port_params import (from_flax_vgg,
                                            write_seeded_monodepth,
                                            write_seeded_vgg)
from tests.torch_threads import one_torch_thread  # noqa: F401

TAPS = [4, 9, 18, 27]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    return {"vgg": write_seeded_vgg(str(root / "vgg19.pth"), seed=3),
            "depth": write_seeded_monodepth(str(root / "md"), seed=4,
                                            height=64, width=96)}


def _imgs(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _rel_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("norm", [True, False])
def test_vgg_features_from_a_file_match_jax(files, norm):
    x = _imgs(0, 2, 32, 32, 3)
    jm = JaxVGG(cfg="vgg19", taps=tuple(TAPS), max_layer=27,
                use_input_norm=norm)
    params = load_vgg_params(files["vgg"], jax.jit(jm.init)(
        jax.random.PRNGKey(0), x)["params"])
    want = jax.jit(jm.apply)({"params": params}, x)
    tm = load_vgg_state(VGGFeatures("vgg19", TAPS, 27, norm), files["vgg"])
    with torch.no_grad():
        got = tm(_nchw(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape == (2, 32 >> (i + 1), 32 >> (i + 1),
                                      (64, 128, 256, 512)[i])
        assert _rel_max(g, np.asarray(w)) <= 1e-4, f"tap {TAPS[i]}"


@pytest.mark.parametrize("taps, max_layer", [((2, 7, 16), 16), ((), 12)])
def test_from_flax_vgg_matches_jax(taps, max_layer):
    """flax's own init carried across; ``max_layer`` 12 ends on a conv
    (its ReLU cut off), no taps return the last activation alone."""
    x = _imgs(1, 1, 24, 28, 3)
    jm = JaxVGG(cfg="vgg16", taps=taps, max_layer=max_layer,
                use_input_norm=True)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(2), x)
    want = jax.jit(jm.apply)(variables, x)
    tm = VGGFeatures("vgg16", taps, max_layer, True)
    tm.load_state_dict(from_flax_vgg(jax.tree_util.tree_map(
        np.asarray, variables["params"])))
    with torch.no_grad():
        got = tm(_nchw(x))
    if not taps:
        got, want = [got], [want]
        assert float(got[0].min()) < 0          # no ReLU after conv 12
    for g, w in zip(got, want):
        assert _rel_max(g.permute(0, 2, 3, 1).numpy(), np.asarray(w)) <= 1e-4


def test_vgg_state_dict_is_torchvision_layout():
    n_conv = sum(v != "M" for v in VGG_CFGS["vgg19"])
    keys = list(VGGFeatures("vgg19").state_dict())
    assert len(keys) == 2 * n_conv
    assert keys[:4] == ["features.0.weight", "features.0.bias",
                        "features.2.weight", "features.2.bias"]
    assert keys[-1] == "features.34.bias"


CRITERIA = ("l1", "l2", "cb")


def _check_losses(jax_loss, port_loss, sr, hr, criteria=CRITERIA):
    """Each criterion in turn on the same two loss objects (their ``cri``
    swapped; JAX's in one jitted program): the value (the first output)
    ≤ 1e-5 relative to JAX's and its gradient w.r.t. SR ≤ 1e-4 of max
    against ``jax.grad``. Returns {criterion: (JAX's outputs, the
    port's)}."""
    from endosr.losses.basic import charbonnier_loss, l1_loss, l2_loss
    from endosr_torch.losses.basic import pixel_loss

    jax_cri = {"l1": l1_loss, "l2": l2_loss, "cb": charbonnier_loss}

    def all_criteria(sr, hr):
        out = {}
        for c in criteria:
            jax_loss.cri = jax_cri[c]
            out[c] = (jax_loss(sr, hr),
                      jax.grad(lambda s: jax_loss(s, hr)[0])(sr))
        return out

    want = jax.jit(all_criteria)(sr, hr)
    got = {}
    for c in criteria:
        port_loss.cri = pixel_loss(c)
        s = torch.from_numpy(sr).requires_grad_(True)
        h = torch.from_numpy(hr).requires_grad_(True)
        out = port_loss(s, h)
        out[0].backward()
        want_v, got_v = float(want[c][0][0]), float(out[0].detach())
        assert abs(got_v - want_v) <= 1e-5 * abs(want_v), (c, got_v, want_v)
        assert h.grad is None                     # the target is no_grad
        err = _rel_max(s.grad.numpy(), np.asarray(want[c][1]))
        assert err <= 1e-4, (c, err)
        got[c] = (want[c][0], out)
    return got


def test_vgg_depth_loss_matches_jax(files):
    opt = {"vgg_layers": TAPS, "vgg_weight": [1.0, 0.5, 0.25, 2.0],
           "vgg_criterion": "l1", "vgg_type": "vgg19",
           "vgg_weights_path": files["vgg"]}
    sr, hr = _imgs(2, 2, 32, 32, 3), _imgs(3, 2, 32, 32, 3)
    port = VGGDepthLoss(opt, device="cpu")
    assert not port.model.training
    assert not any(p.requires_grad for p in port.model.parameters())
    for c, (want, got) in _check_losses(JaxVGGLoss(opt), port, sr,
                                        hr).items():
        assert len(got[1]) == 4
        for g, w in zip(got[1], want[1]):
            assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w)), c


def test_perceptual_loss_matches_jax(files):
    sr, hr = _imgs(4, 2, 32, 32, 3), _imgs(5, 2, 32, 32, 3)
    jl = JaxPerceptual("l1", 0.7, files["vgg"])
    tl = PerceptualLoss("l1", 0.7, files["vgg"], device="cpu")

    class Pair:                     # the (value,) protocol of _check_losses
        def __init__(self, loss):
            self.loss = loss

        def __call__(self, s, h):
            self.loss.cri = self.cri
            return (self.loss(s, h),)

    _check_losses(Pair(jl), Pair(tl), sr, hr, ("l1",))


def test_depth_estimator_loss_matches_jax(files):
    opt = {"depth_criterion": "l1", "depth_weight": [0.1, 0.2, 0.3, 0.4],
           "pretrained_model_path": files["depth"]}
    sr, hr = _imgs(6, 2, 28, 36, 3), _imgs(7, 2, 28, 36, 3)
    port = DepthEstimatorLoss(opt, device="cpu")
    assert (port.feed_height, port.feed_width) == (64, 96)
    for net in (port.encoder, port.decoder):
        assert not net.training
        assert not any(p.requires_grad for p in net.parameters())
    for c, (want, got) in _check_losses(JaxDepthLoss(opt), port, sr,
                                        hr).items():
        for g, w in zip(got[1], want[1]):
            assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w)), c
        for g, w in zip(got[2] + got[3], want[2] + want[3]):  # the pyramids
            assert g.shape == (2, 1, *w.shape[1:3])
            assert np.abs(g.detach().permute(0, 2, 3, 1).numpy()
                          - np.asarray(w)).max() <= 1e-5


def test_missing_weights_raise_as_in_jax(tmp_path):
    missing = str(tmp_path / "nowhere")
    depth = {"depth_criterion": "l1", "depth_weight": [1, 0, 0, 0],
             "pretrained_model_path": missing}
    vgg = {"vgg_layers": TAPS, "vgg_weight": [1] * 4, "vgg_criterion": "l1",
           "vgg_weights_path": missing + ".pth"}
    for jax_cls, port_cls, opt in ((JaxDepthLoss, DepthEstimatorLoss, depth),
                                   (JaxVGGLoss, VGGDepthLoss, vgg)):
        with pytest.raises(FileNotFoundError) as want:
            jax_cls(opt)
        with pytest.raises(FileNotFoundError) as got:
            port_cls(opt, device="cpu")
        assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


def test_seeded_vgg_init_without_a_file():
    opt = {"vgg_layers": [4], "vgg_weight": [1.0], "vgg_criterion": "l1"}
    a, b, c = (VGGDepthLoss(opt, device="cpu", seed=s) for s in (0, 0, 1))
    sa, sb, sc = (m.model.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["features.0.weight"], sc["features.0.weight"])
    bound = 1 / np.sqrt(27)
    assert float(sa["features.0.weight"].abs().max()) <= bound
