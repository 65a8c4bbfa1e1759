"""The port's monodepth2 networks and depth-map producer against the JAX
package's, on the CPU.

Seeded ``encoder.pth`` / ``depth.pth`` in monodepth2's layouts
(``port_params.write_seeded_monodepth``: the torchvision ResNet keys under
``encoder.`` with its classifier, ``height``, ``width`` and
``use_stereo``; ``decoder.N.conv(.conv).*``; BatchNorm statistics far from
0 / 1) are read by both packages: JAX through ``port_resnet_encoder`` /
``port_depth_decoder``, the port through ``load_monodepth``. Feed 64×96
(the decoder's skips need sides that are multiples of 32), batch 2, fp32:

- the five encoder features ≤ 1e-4 of max |ref|, the four disparities
  ≤ 1e-5 abs, for ResNet-18 (``BasicBlock``) and ResNet-50
  (``Bottleneck``);
- the same forward from flax-initialised ResNet-18 variables carried
  across by ``from_flax_monodepth`` (the batch statistics drawn away from
  0 / 1);
- ``disp_to_depth``, ``compute_depth_errors`` and ``evaluate_against_gt``
  against JAX's;
- ``run_folder`` against JAX's on three ``cv2``-written frames: the same
  file names in the same order, the ``.npy`` arrays (shape [1, 1, H, W],
  float32) ≤ 1e-5 abs, the ``.jpeg`` previews written.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosr.depth import infer as jax_infer
from endosr.depth.layers import disp_to_depth as jax_disp_to_depth
from endosr.metrics.depth import compute_depth_errors as jax_depth_errors
from endosr.nn.monodepth import (DepthDecoder, ResnetEncoder,
                                 port_depth_decoder, port_resnet_encoder)
from endosr_torch.depth import infer as t_infer
from endosr_torch.depth.layers import disp_to_depth
from endosr_torch.metrics.depth import compute_depth_errors
from endosr_torch.nn import monodepth as t_md
from endosr_torch.utils.port_params import (from_flax_monodepth,
                                            load_monodepth,
                                            write_seeded_monodepth)
from tests.torch_threads import one_torch_thread  # noqa: F401

FEED_H, FEED_W, B = 64, 96, 2


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{num_layers: a folder holding seeded encoder.pth / depth.pth}."""
    root = tmp_path_factory.mktemp("monodepth")
    return {n: write_seeded_monodepth(str(root / f"r{n}"), seed=n,
                                      num_layers=n, height=FEED_H,
                                      width=FEED_W)
            for n in (18, 50)}


def _jax_nets(model_path, num_layers):
    """The JAX encoder / decoder with their variables, read from the files
    as ``endosr/depth/infer.py`` reads them."""
    enc_raw = torch.load(os.path.join(model_path, "encoder.pth"),
                         map_location="cpu", weights_only=False)
    enc_sd = {k: v.numpy() for k, v in enc_raw.items() if torch.is_tensor(v)}
    dec_sd = {k: v.numpy() for k, v in torch.load(
        os.path.join(model_path, "depth.pth"), weights_only=False).items()}
    enc = ResnetEncoder(num_layers=num_layers)
    dec = DepthDecoder(num_ch_enc=tuple(enc.num_ch_enc))
    dummy = jnp.zeros((1, FEED_H, FEED_W, 3), jnp.float32)
    ev = port_resnet_encoder(enc_sd, jax.eval_shape(
        enc.init, jax.random.PRNGKey(0), dummy))
    dv = port_depth_decoder(dec_sd, jax.eval_shape(
        dec.init, jax.random.PRNGKey(0),
        jax.eval_shape(enc.apply, ev, dummy)))
    return enc, ev, dec, dv


def _images(seed=0):
    return np.random.default_rng(seed).random(
        (B, FEED_H, FEED_W, 3), dtype=np.float32)


def _forward_both(enc, ev, dec, dv, t_enc, t_dec, x):
    feats, outs = jax.jit(lambda ev, dv, x: (
        f := enc.apply(ev, x), dec.apply(dv, f)))(ev, dv, x)
    with torch.no_grad():
        tf = t_enc(torch.from_numpy(x).permute(0, 3, 1, 2))
        to = t_dec(tf)
    return ([np.asarray(f) for f in feats],
            [f.permute(0, 2, 3, 1).numpy() for f in tf],
            [np.asarray(outs[("disp", s)]) for s in range(4)],
            [to[("disp", s)].permute(0, 2, 3, 1).numpy() for s in range(4)])


def _assert_close(jf, tf, jd, td):
    assert len(tf) == 5 and len(td) == 4
    for i, (a, b) in enumerate(zip(jf, tf)):
        assert a.shape == b.shape, i
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= 1e-4, f"feature {i}: {err:.3g} of max |ref|"
    for s, (a, b) in enumerate(zip(jd, td)):
        assert a.shape == b.shape == (B, FEED_H >> s, FEED_W >> s, 1)
        assert b.dtype == np.float32
        err = np.abs(a - b).max()
        assert err <= 1e-5, f"disp scale {s}: max |Δ| {err:.3g}"


@pytest.mark.parametrize("num_layers", [18, 50])
def test_networks_from_the_files_match_jax(weights, num_layers):
    enc, ev, dec, dv = _jax_nets(weights[num_layers], num_layers)
    t_enc, t_dec, h, w = load_monodepth(weights[num_layers], num_layers)
    assert (h, w) == (FEED_H, FEED_W)
    assert not t_enc.training and not t_dec.training
    assert t_enc.num_ch_enc == tuple(enc.num_ch_enc)
    _assert_close(*_forward_both(enc, ev, dec, dv, t_enc, t_dec,
                                 _images(num_layers)))


def test_file_keys_load_as_they_are(weights):
    """Every key of depth.pth and every key of encoder.pth but the feed
    size, the stereo flag and torchvision's classifier is a key of the
    port's networks, and every parameter and statistic comes from the
    files."""
    enc_raw = torch.load(os.path.join(weights[18], "encoder.pth"),
                         weights_only=True)
    dec_raw = torch.load(os.path.join(weights[18], "depth.pth"),
                         weights_only=True)
    t_enc, t_dec, _, _ = load_monodepth(weights[18])
    extra = set(enc_raw) - set(t_enc.state_dict())
    assert extra == {"height", "width", "use_stereo", "encoder.fc.weight",
                     "encoder.fc.bias"}
    assert set(dec_raw) == set(t_dec.state_dict())
    for k, v in t_enc.state_dict().items():
        assert torch.equal(v, enc_raw[k]), k
    for k, v in t_dec.state_dict().items():
        assert torch.equal(v, dec_raw[k]), k


def test_from_flax_monodepth_matches_jax():
    num_layers = 18
    enc = ResnetEncoder(num_layers=num_layers)
    dec = DepthDecoder(num_ch_enc=tuple(enc.num_ch_enc))
    x = _images(3)
    ev = jax.jit(enc.init)(jax.random.PRNGKey(num_layers), x)
    rng = np.random.default_rng(num_layers)
    ev = {"params": ev["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: (rng.uniform(-0.1, 0.1, a.shape) if np.all(np.asarray(a) == 0)
                   else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        ev["batch_stats"])}
    feats = [jnp.zeros(f.shape) for f in jax.eval_shape(enc.apply, ev, x)]
    dv = jax.jit(dec.init)(jax.random.PRNGKey(1), feats)
    t_enc = t_md.ResnetEncoder(num_layers).eval()
    t_enc.load_state_dict(from_flax_monodepth(jax.tree_util.tree_map(
        np.asarray, ev)))
    t_dec = t_md.DepthDecoder(t_enc.num_ch_enc).eval()
    t_dec.load_state_dict(from_flax_monodepth(jax.tree_util.tree_map(
        np.asarray, dv)))
    _assert_close(*_forward_both(enc, ev, dec, dv, t_enc, t_dec, x))


def test_disp_to_depth_and_depth_errors_match_jax():
    rng = np.random.default_rng(5)
    disp = rng.random((2, 1, 8, 8)).astype(np.float32)
    for a, b in zip(jax_disp_to_depth(jnp.asarray(disp), 0.2, 80.0),
                    disp_to_depth(torch.from_numpy(disp), 0.2, 80.0)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for a, b in zip(jax_disp_to_depth(disp), disp_to_depth(disp)):
        np.testing.assert_array_equal(b, a)
    gt = (rng.random((16, 20)) * 10 + 0.5).astype(np.float32)
    pred = (gt * rng.uniform(0.7, 1.4, gt.shape)).astype(np.float32)
    assert compute_depth_errors(gt, pred) == jax_depth_errors(gt, pred)


def test_evaluate_against_gt_matches_jax():
    rng = np.random.default_rng(6)
    gts = [(rng.random((12, 16)) * 20).astype(np.float32) for _ in range(3)]
    for g in gts:
        g[rng.random(g.shape) < 0.2] = 0          # no GT there
    preds = [(rng.random((12, 16)) * 5 + 0.1).astype(np.float32)
             for _ in range(3)]
    for median in (True, False):
        want = jax_infer.evaluate_against_gt(preds, gts, median)
        got = t_infer.evaluate_against_gt(preds, gts, median)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-12), k


def test_run_folder_matches_jax(weights, tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(8)
    for name, hw in (("b", (50, 70)), ("a", (64, 96)), ("c", (81, 77))):
        cv2.imwrite(str(frames / f"{name}.png"),
                    (rng.random((*hw, 3)) * 255).astype(np.uint8))
    want = jax_infer.run_folder(str(frames), weights[18],
                                str(tmp_path / "jax"))
    got = t_infer.run_folder(str(frames), weights[18], str(tmp_path / "port"),
                             device="cpu")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        ["a_disp.npy", "b_disp.npy", "c_disp.npy"]
    for g, w in zip(got, want):
        a, b = np.load(w), np.load(g)
        assert b.shape == a.shape == (1, 1, FEED_H, FEED_W)
        assert b.dtype == a.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-5, g
        assert os.path.exists(g[:-len(".npy")] + ".jpeg")
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_entry_points_take_cuda_unless_asked(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_infer.DepthPredictor(weights[18])
    pred = t_infer.DepthPredictor(weights[18], device="cpu")
    disp = pred.predict_disp(_images()[0])
    assert disp.shape == (FEED_H, FEED_W) and disp.dtype == np.float32
