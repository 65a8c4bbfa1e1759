"""The port's pose networks (``endosr_torch/nn/monodepth.py``: ``PoseDecoder``,
``PoseCNN``, the two-image ``ResnetEncoder``) and their weight carriers
(``utils/port_params.py``) against the JAX package's, on the CPU in fp32.

- The pose decoder, the PoseCNN and the six-channel pose encoder (in
  training mode, BatchNorm by batch statistics, and in eval mode) on
  seeded flax variables carried across by ``from_flax_pose`` /
  ``from_flax_monodepth``: axis-angles, translations and features
  ≤ 1e-5 of max |ref| (feed 64×96, batch 2).
- ``from_flax_depth_trainer`` gives the four ``state_dict``s that load,
  strictly, into the port's networks.
- JAX's ``port_pose_decoder`` and ``port_resnet_encoder`` read the port's
  ``pose.pth`` and ``pose_encoder.pth`` (the seeded writer's, with
  torchvision's classifier, and a trainer's ``save_model``), and their
  forwards match the port's on those files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosr.nn.monodepth import (PoseCNN, PoseDecoder, ResnetEncoder,
                                 port_pose_decoder, port_resnet_encoder)
from endosr_torch.nn import monodepth as t_md
from endosr_torch.utils.port_params import (from_flax_depth_trainer,
                                            from_flax_monodepth,
                                            from_flax_pose,
                                            load_monodepth_file,
                                            write_seeded_monodepth)
from tests.torch_depth_common import B, H, W, nrel, seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _pair(seed):
    return np.random.default_rng(seed).random((B, H, W, 6), dtype=np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _enc_vars(seed):
    enc = ResnetEncoder(num_layers=18, num_input_images=2)
    x = jnp.zeros((1, H, W, 6))
    return enc, seeded_variables(jax.eval_shape(
        lambda k: enc.init(k, x, train=True), jax.random.PRNGKey(0)), seed)


def _dec_vars(enc, seed):
    dec = PoseDecoder(num_ch_enc=tuple(enc.num_ch_enc), num_input_features=1,
                      num_frames_to_predict_for=2)
    feats = [jax.ShapeDtypeStruct((1, H >> s, W >> s, c), jnp.float32)
             for s, c in zip(range(1, 6), enc.num_ch_enc)]
    return dec, seeded_variables(jax.eval_shape(
        lambda k, f: dec.init(k, [f]), jax.random.PRNGKey(0), feats), seed)


def _port_pose_net():
    enc = t_md.ResnetEncoder(18, num_input_images=2)
    dec = t_md.PoseDecoder(enc.num_ch_enc, num_input_features=1,
                           num_frames_to_predict_for=2)
    return enc, dec


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_pose_encoder_and_decoder_match_jax(train):
    enc, ev = _enc_vars(1)
    dec, dv = _dec_vars(enc, 2)
    x = _pair(3)

    @jax.jit
    def fwd(ev, dv, x):
        if train:
            feats, _ = enc.apply(ev, x, train=True, mutable=["batch_stats"])
        else:
            feats = enc.apply(ev, x, train=False)
        return feats, dec.apply(dv, [feats])

    feats, (aa, tr) = fwd(ev, dv, jnp.asarray(x))
    t_enc, t_dec = _port_pose_net()
    t_enc.load_state_dict(from_flax_monodepth(ev))
    t_dec.load_state_dict(from_flax_pose(dv))
    t_enc.train(train)
    with torch.no_grad():
        tf = t_enc(_nchw(x))
        taa, ttr = t_dec([tf])
    for a, b in zip(feats, tf):
        assert nrel(b.permute(0, 2, 3, 1).numpy(), a) <= TOL
    assert taa.shape == ttr.shape == (B, 2, 1, 3)
    assert taa.dtype == torch.float32
    assert nrel(taa.numpy(), aa) <= TOL
    assert nrel(ttr.numpy(), tr) <= TOL


def test_posecnn_matches_jax():
    net = PoseCNN(num_input_frames=2)
    v = seeded_variables(jax.eval_shape(
        lambda k: net.init(k, jnp.zeros((1, H, W, 6))), jax.random.PRNGKey(0)), 4)
    x = _pair(5)
    aa, tr = jax.jit(net.apply)(v, jnp.asarray(x))
    t_net = t_md.PoseCNN(2)
    sd = from_flax_pose(v)
    assert set(sd) == set(t_net.state_dict())
    assert {k.rsplit(".", 1)[0] for k in sd} == {
        *(f"net.{i}" for i in range(7)), "pose_conv"}
    t_net.load_state_dict(sd)
    with torch.no_grad():
        taa, ttr = t_net(_nchw(x))
    assert taa.shape == (B, 1, 1, 3)
    assert nrel(taa.numpy(), aa) <= TOL
    assert nrel(ttr.numpy(), tr) <= TOL


def test_from_flax_depth_trainer_loads_every_network():
    enc = ResnetEncoder(num_layers=18)
    x = jnp.zeros((1, H, W, 3))
    variables = {"encoder": seeded_variables(jax.eval_shape(
        lambda k: enc.init(k, x, train=True), jax.random.PRNGKey(0)), 6)}
    pose_enc, variables["pose_encoder"] = _enc_vars(7)
    _, variables["pose"] = _dec_vars(pose_enc, 8)
    sds = from_flax_depth_trainer(variables)
    assert sorted(sds) == ["encoder", "pose", "pose_encoder"]
    t_enc = t_md.ResnetEncoder(18)
    t_pe, t_pd = _port_pose_net()
    for name, m in (("encoder", t_enc), ("pose_encoder", t_pe),
                    ("pose", t_pd)):
        m.load_state_dict(sds[name])
    bn = t_pe.encoder.layer3[0].downsample[1]
    np.testing.assert_array_equal(
        bn.running_var.numpy(),
        variables["pose_encoder"]["batch_stats"]["layer3_0"]["downsample_1"]["var"])
    np.testing.assert_array_equal(
        t_pe.encoder.conv1.weight.detach().numpy(),
        variables["pose_encoder"]["params"]["conv1"]["kernel"].transpose(3, 2, 0, 1))


def _jax_reads(folder):
    """JAX's porters on the folder's pose files → (encoder, variables,
    decoder, variables)."""
    sd = {k: v.numpy() for k, v in torch.load(
        os.path.join(folder, "pose_encoder.pth"), weights_only=True).items()
        if torch.is_tensor(v)}
    pd = {k: v.numpy() for k, v in torch.load(
        os.path.join(folder, "pose.pth"), weights_only=True).items()}
    enc, shapes = _enc_vars(0)
    ev = port_resnet_encoder(sd, shapes)
    dec, dshapes = _dec_vars(enc, 0)
    return enc, ev, dec, port_pose_decoder(pd, dshapes)


def _both_read(folder, seed):
    enc, ev, dec, dv = _jax_reads(folder)
    x = _pair(seed)
    aa, tr = jax.jit(lambda ev, dv, x: dec.apply(dv, [enc.apply(ev, x)]))(
        ev, dv, jnp.asarray(x))
    t_enc, t_dec = _port_pose_net()
    extra = load_monodepth_file(t_enc, os.path.join(folder, "pose_encoder.pth"))
    load_monodepth_file(t_dec, os.path.join(folder, "pose.pth"))
    t_enc.eval()
    with torch.no_grad():
        taa, ttr = t_dec([t_enc(_nchw(x))])
    assert nrel(taa.numpy(), aa) <= TOL
    assert nrel(ttr.numpy(), tr) <= TOL
    return extra


def test_jax_porters_read_the_seeded_pose_files(tmp_path):
    folder = write_seeded_monodepth(str(tmp_path), seed=9, height=H, width=W,
                                    pose=True)
    assert sorted(os.listdir(folder)) == ["depth.pth", "encoder.pth",
                                          "pose.pth", "pose_encoder.pth"]
    extra = _both_read(folder, 10)
    assert sorted(extra) == ["encoder.fc.bias", "encoder.fc.weight"]
    pd = torch.load(os.path.join(folder, "pose.pth"), weights_only=True)
    assert sorted(pd) == sorted(f"net.{i}.{p}" for i in range(4)
                                for p in ("weight", "bias"))


def test_jax_porters_read_a_trainer_save(tmp_path):
    from endosr_torch.depth.options import MonodepthOptions
    from endosr_torch.depth.trainer import Trainer

    opts = MonodepthOptions().parse([
        "--no_cuda", "--log_dir", str(tmp_path), "--height", str(H),
        "--width", str(W)])
    tr = Trainer(opts, seed=11)
    folder = tr.save_model()
    assert _both_read(folder, 12) == {}
