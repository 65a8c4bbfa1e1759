"""JAX's checkpoint files in the port, against the JAX package on the CPU.

- ``utils/msgpack_io.py``: ``packb`` equals ``flax.serialization.to_bytes``
  byte for byte on trees with fp32, bf16, int and scalar leaves, lists,
  ``None``, a complex, and arrays chunked under a lowered
  ``MAX_CHUNK_SIZE`` (flax's module attribute and the port's); ``unpackb``
  reads what ``msgpack_restore`` reads (a bf16 array as a
  ``torch.bfloat16`` tensor).
- ``utils/port_params.py``'s ``to_flax*`` invert ``from_flax*`` exactly
  (paths, shapes, layouts, values) for every network ``define_G``,
  ``define_D``, ``define_F`` and ``define_SegNet`` build, SFT-GAN's, and
  monodepth2's encoder, decoder and pose networks.
- Files across packages: a ``.ckpt`` that JAX's ``save_network`` writes
  loads in the port (``models/base.py::load_weights``) to weights
  bit-equal to ``from_flax`` of the same tree, and the forward is within
  2e-4 of the largest of JAX's ``apply`` (the repo's parity bar); JAX's
  ``load_network`` reads the port's ``.ckpt`` to bit-equal weights.
- Resume across packages, both ways: each package trains two steps from
  one start and saves, and the other resumes its ``.state`` for steps 3–4,
  whose logs stay within the bar of that model's parity test of the first
  package's own uninterrupted steps 3–4: the ×8 flagship model (the ×8
  YAML, cut as ``tests/make_jax_ckpt_fixture.py`` cuts it; 1e-5 relative,
  ``test_torch_entry.py::test_resumed_run_matches_jax``), SRGAN (1e-5, D's
  logits 2e-4, ``test_torch_gan.py``), SFT-GAN (the same), the
  co-training model (1e-5, ``test_torch_depthseg.py``) and the depth
  trainer through ``load_model`` (1e-5, ``test_torch_depth_trainer.py``).
- ``orbax`` (ported since; ``tests/test_torch_orbax.py``): a directory
  that is not an orbax checkpoint is refused naming its missing
  ``_METADATA``; ``checkpoint_backend: orbax`` and
  ``ENDOSR_CKPT_BACKEND=orbax`` write directories JAX restores.
- The committed fixture ``tests/data/jax_ckpt/`` equals, value by value,
  what ``tests/make_jax_ckpt_fixture.py`` makes now.
"""

import copy
import functools
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import endosr.models as jmodels
import endosr.utils.checkpoint as jckpt
from endosr.depth import options as JO
from endosr.nn import monodepth as jmd
from endosr.nn import networks as jnets
from endosr.nn import sft_arch as jsft
from endosr.nn import vgg as jvgg
from endosr_torch.depth import options as TO
from endosr_torch.depth.trainer import Trainer
from endosr_torch.models import create_model
from endosr_torch.models.base import params_tree_of, load_weights
from endosr_torch.nn import monodepth as tmd
from endosr_torch.nn import networks as tnets
from endosr_torch.nn import sft_arch as tsft
from endosr_torch.utils import checkpoint as ckpt
from endosr_torch.utils import msgpack_io
from endosr_torch.utils import port_params as pp
from tests import make_jax_ckpt_fixture as fx
from tests.torch_depth_common import (jax_noise, jax_trainer, make_batch,
                                      to_jax, to_port)
from tests.torch_models_common import jax_model, model_opt, seeded_leaves
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "jax_ckpt"
RNG = np.random.default_rng(31)


def _f(*shape, dtype=np.float32):
    return RNG.standard_normal(shape).astype(dtype)


def _equal(got, want, path=""):
    """Trees equal key for key and value for value (dtype, shape, bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got) if isinstance(got, dict) else got, sorted(want))
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
        return
    if torch.is_tensor(got):
        assert got.dtype == torch.bfloat16, path
        got = np.asarray(jnp.asarray(got.float().numpy(), jnp.bfloat16))
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
    assert g.tobytes() == w.tobytes(), path


# ------------------------------------------------------------ msgpack_io

TREES = {
    "params": lambda: {"conv": {"kernel": _f(3, 3, 4, 8), "bias": _f(8)},
                       "dense": {"kernel": _f(5, 2)}},
    "bf16_and_ints": lambda: {
        "w": np.asarray(jnp.asarray(_f(4, 6), jnp.bfloat16)),
        "count": np.asarray(7, np.int32), "idx": np.arange(300, dtype=np.int64),
        "u8": (np.arange(70000) % 251).astype(np.uint8)},
    "scalars": lambda: {"epoch": np.int64(3), "iter": np.asarray(12, np.int64),
                        "lr": 1e-3, "n": -40000, "big": 2 ** 40, "small": -3,
                        "flag": True, "none": None, "name": "x" * 40,
                        "z": complex(1.5, -2.0), "f32": np.float32(0.25)},
    "optax_chain": lambda: {"0": {}, "1": {"count": np.asarray(2, np.int32),
                                           "mu": {"a": _f(3)},
                                           "nu": {"a": _f(3)}},
                            "2": [np.asarray(2, np.int32), (1, 2.5)]},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_packb_is_flax_to_bytes_and_unpackb_reads_it(name):
    tree = TREES[name]()
    want = serialization.to_bytes(tree)
    assert msgpack_io.packb(tree) == want
    _equal(msgpack_io.unpackb(want), serialization.msgpack_restore(want))


def test_chunked_arrays_as_flax_writes_and_joins_them(monkeypatch):
    """Above ``MAX_CHUNK_SIZE`` bytes an array is a map of flat pieces (12
    of them here, so the maps' key order shows)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    tree = {"w": _f(13, 14), "small": _f(4), "nested": {"i": np.arange(
        50, dtype=np.int16)}, "bf": np.asarray(jnp.asarray(_f(9, 9),
                                                         jnp.bfloat16))}
    want = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in want
    assert msgpack_io.packb(tree) == want
    got = msgpack_io.unpackb(want)
    _equal(got, serialization.msgpack_restore(want))
    # a torch tensor is written as the array it holds
    t_tree = {**tree, "w": torch.from_numpy(tree["w"]),
              "bf": torch.from_numpy(np.asarray(tree["bf"], np.float32)
                                     ).bfloat16()}
    assert msgpack_io.packb(t_tree) == want


# --------------------------------------------------- to_flax ∘ from_flax

X = np.zeros((1, 10, 12, 3), np.float32)
D1 = np.zeros((1, 10, 12, 1), np.float32)
CODE = np.zeros((1, 10), np.float32)
DN_IN = (np.zeros((1, 16, 16, 3), np.float32),
         np.zeros((1, 16, 16, 1), np.float32),
         np.zeros((1, 16, 16, 10), np.float32))
DN_NET = {"nb": 4, "depth_latent_ch": 16, "which_ResBlk_depth": [0]}
# which_model_G: (network_G, scale, inputs)
GENERATORS = {
    "DepthNet": (DN_NET, 8, DN_IN),
    "MSRResNet": ({"nf": 16, "nb": 2}, 4, (X,)),
    "RRDBNet": ({"nf": 16, "nb": 1}, 4, (X,)),
    "SFTMD": ({"nb": 2}, 4, (X,)),
    "SFTMD_kernel": ({"nb": 2}, 4, (X, CODE)),
    "SFTMD_DEMO": ({"nb": 2}, 4, (X, CODE)),
    "SFTMD_upsacle_after_ResBlk": ({"nb": 4}, 8, (X,)),
    "SFTMD_upsacle_after_ResBlk_depth_condition": (
        {"nb": 5, "which_ResBlk_depth": [0, 3, 4]}, 8, (X, D1)),
    "SFTMD_upsacle_after_ResBlk_depth": (
        {"nb": 5, "n_depthResBlk": 3, "predict_depth_map": True,
         "use_attention": True}, 8, (X, D1)),
    "Predictor": ({}, 4, (X,)),
    "Corrector": ({}, 4, (X, CODE)),
}
SEG = np.zeros((1, 32, 32, 8), np.float32)


def _variables(module, *inputs, seed=0, **kw):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *inputs, **kw))
    return seeded_leaves(dict(shapes), seed)


def _g_opt(name):
    net, scale, _ = GENERATORS[name]
    return {"scale": scale, "network_G": {"which_model_G": name, **net}}


@functools.lru_cache(maxsize=None)
def _monodepth():
    enc = jmd.ResnetEncoder(18)
    x = np.zeros((1, 64, 64, 3), np.float32)
    ev = _variables(enc, x, train=True)
    feats = enc.apply(ev, x)
    dec = jmd.DepthDecoder(num_ch_enc=tuple(enc.num_ch_enc))
    pose = jmd.PoseDecoder(num_ch_enc=tuple(enc.num_ch_enc),
                           num_input_features=1, num_frames_to_predict_for=2)
    return ev, _variables(dec, feats), _variables(pose, [feats])


# name: (the JAX variables or params, to_flax ∘ from_flax of them)
ROUND_TRIPS = {
    **{f"G {n}": (lambda n=n: (
        p := _variables(jnets.define_G(_g_opt(n)), *GENERATORS[n][2])[
            "params"], pp.to_flax(pp.from_flax(p)))) for n in GENERATORS},
    "D discriminator_vgg_128": lambda: (
        v := _variables(jnets.define_D({"network_D": {
            "which_model_D": "discriminator_vgg_128", "nf": 8}}),
            np.zeros((1, 128, 128, 3), np.float32), train=True),
        pp.to_flax_gan(pp.from_flax_gan(v, "DiscriminatorVGG128"),
                       "DiscriminatorVGG128")),
    "F vgg19": lambda: (
        v := _variables(jvgg.VGGFeatures(), np.zeros((1, 32, 32, 3),
                                                     np.float32))["params"],
        pp.to_flax_vgg(pp.from_flax_vgg(v))),
    "SegNet FCN8s": lambda: (
        v := _variables(jnets.define_SegNet({"network_SegNet": {
            "num_classes": 2}}), np.zeros((1, 64, 64, 3), np.float32),
            train=True),
        pp.to_flax_variables(pp.from_flax_variables(v))),
    **{f"SFT-GAN {c.__name__}": (lambda c=c: (
        v := _variables(c(), X[:, :8, :8], SEG),
        pp.to_flax_gan(pp.from_flax_gan(v, c.__name__), c.__name__)))
       for c in (jsft.SFTNet, jsft.SFTNetTorch)},
    "SFT-GAN ACDVGGBN96": lambda: (
        v := _variables(jsft.ACDVGGBN96(), np.zeros((1, 96, 96, 3),
                                                    np.float32), train=True),
        pp.to_flax_gan(pp.from_flax_gan(v, "ACDVGGBN96"), "ACDVGGBN96")),
    "monodepth2 encoder, decoder": lambda: (
        v := _monodepth()[:2],
        tuple(pp.to_flax_monodepth(pp.from_flax_monodepth(t)) for t in v)),
    "monodepth2 pose": lambda: (
        v := _monodepth()[2], pp.to_flax_pose(pp.from_flax_pose(v))),
    "PoseCNN": lambda: (
        v := _variables(jmd.PoseCNN(num_input_frames=2),
                        np.zeros((1, 64, 64, 6), np.float32)),
        pp.to_flax_pose(pp.from_flax_pose(v))),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_to_flax_inverts_from_flax(name):
    want, got = ROUND_TRIPS[name]()
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        _equal(got, want)


# ------------------------------------------- .ckpt files across packages

def _sd_equal(net, want):
    sd = net.state_dict()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def _close(got, want, tol=2e-4):
    w = np.asarray(want)
    g = got.detach().numpy()
    assert g.shape == w.shape
    assert float(np.abs(g - w).max()) <= tol * float(np.abs(w).max())


def _read_params(path, net):
    """A model's read of a weights file (``models/base.py::load_weights``)."""
    load_weights(path, net)


def _read_variables(path, net):
    """The depth trainer's read of a network's ``.ckpt`` (its flax
    variables, ``depth/trainer.py::load_model``)."""
    tree = ckpt.load_pytree(path)
    conv = pp.from_flax_pose if "pose_0" in tree["params"] or \
        "pose_conv" in tree["params"] else pp.from_flax_monodepth
    net.load_state_dict(conv(tree))


def _mono_case(which):
    def make():
        enc = jmd.ResnetEncoder(18)
        if which == "encoder":
            return enc
        kw = dict(num_ch_enc=tuple(enc.num_ch_enc))
        if which == "decoder":
            return jmd.DepthDecoder(**kw)
        return jmd.PoseDecoder(**kw, num_input_features=1,
                               num_frames_to_predict_for=2)

    def make_t():
        enc = tmd.ResnetEncoder(18)
        if which == "encoder":
            return enc
        if which == "decoder":
            return tmd.DepthDecoder(enc.num_ch_enc)
        return tmd.PoseDecoder(enc.num_ch_enc, num_input_features=1,
                               num_frames_to_predict_for=2)

    x = np.random.default_rng(5).random((1, 64, 64, 3), np.float32)
    feats = jmd.ResnetEncoder(18).apply(_monodepth()[0], x)
    feats = [np.asarray(f) for f in feats]
    if which == "encoder":
        return (make, (x,), {"train": True}, make_t, (x,), None, _read_variables,
                {"train": False})
    if which == "decoder":
        return (make, (feats,), {}, make_t, (feats,), None, _read_variables,
                {})
    return (make, ([feats],), {}, make_t, ([feats],), None, _read_variables,
            {})


FILE_NETS = dict(GENERATORS, SFTMD_upsacle_after_ResBlk_depth=(
    {"nb": 5, "n_depthResBlk": 2, "predict_depth_map": True}, 8, (X, D1)))
R1 = np.random.default_rng(1)
# name: (the JAX module, its init's inputs and kw, the port module, the
# forward's inputs, the GAN network name (None: from_flax's names), how the
# port reads the file, the JAX apply's kw)
FILE_CASES = {
    **{n: (lambda n=n: jnets.define_G({"scale": FILE_NETS[n][1],
                                       "network_G": {"which_model_G": n,
                                                     **FILE_NETS[n][0]}}),
           FILE_NETS[n][2], {},
           lambda n=n: tnets.define_G({"scale": FILE_NETS[n][1],
                                       "network_G": {"which_model_G": n,
                                                     **FILE_NETS[n][0]}},
                                      device="cpu"),
           tuple(R1.random(a.shape, np.float32) for a in FILE_NETS[n][2]),
           None, _read_params, {})
       for n in ("DepthNet", "MSRResNet", "RRDBNet", "SFTMD", "SFTMD_kernel",
                 "SFTMD_upsacle_after_ResBlk_depth_condition",
                 "SFTMD_upsacle_after_ResBlk_depth")},
    "FCN8s": (lambda: jnets.define_SegNet({"network_SegNet": {
        "num_classes": 2}}), (np.zeros((1, 32, 32, 3), np.float32),),
        {"train": True},
        lambda: tnets.define_SegNet({"network_SegNet": {"num_classes": 2}},
                                    device="cpu"),
        (R1.random((1, 32, 32, 3), np.float32),), "", _read_params,
        {"train": False}),
    "Discriminator_VGG_128": (lambda: jnets.define_D({"network_D": {
        "which_model_D": "discriminator_vgg_128", "nf": 8}}),
        (np.zeros((1, 128, 128, 3), np.float32),), {"train": True},
        lambda: tnets.define_D({"network_D": {
            "which_model_D": "discriminator_vgg_128", "nf": 8}},
            device="cpu"),
        (R1.random((2, 128, 128, 3), np.float32),), "DiscriminatorVGG128",
        _read_params, {"train": False}),
    "SFTNet": (jsft.SFTNet, (X[:, :8, :8], SEG), {}, tsft.SFTNet,
               (R1.random((1, 8, 8, 3), np.float32),
                R1.random((1, 32, 32, 8), np.float32)), "SFTNet",
               _read_params, {}),
    "monodepth2 encoder": lambda: _mono_case("encoder"),
    "monodepth2 depth decoder": lambda: _mono_case("decoder"),
    "monodepth2 pose": lambda: _mono_case("pose"),
}


def _to_port(gan, tree):
    """``from_flax`` (or the GAN rule ``gan``) of a params tree."""
    return pp.from_flax_gan(tree, gan) if gan else pp.from_flax(tree)


def _port_out(name, net, inputs):
    net.eval()
    with torch.no_grad():
        if name == "monodepth2 encoder":
            return [f.permute(0, 2, 3, 1) for f in net(_nchw(inputs[0]))]
        if name == "monodepth2 depth decoder":
            out = net([_nchw(f) for f in inputs[0]])
            return [out[("disp", s)].permute(0, 2, 3, 1) for s in range(4)]
        if name == "monodepth2 pose":
            return list(net([[_nchw(f) for f in inputs[0][0]]]))
        out = net(*(torch.from_numpy(a) for a in inputs))
    return out[0] if isinstance(out, tuple) else out


def _jax_out(name, jm, variables, inputs, kw):
    out = jax.jit(lambda v, *a: jm.apply(v, *a, **kw))(variables, *inputs)
    if name == "monodepth2 depth decoder":
        return [out[("disp", s)] for s in range(4)]
    if isinstance(out, tuple) and not name.startswith("monodepth2"):
        return out[0]
    return list(out) if isinstance(out, (tuple, list)) else out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
        0, 3, 1, 2)))


@pytest.mark.parametrize("name", sorted(FILE_CASES))
def test_jax_ckpt_loads_in_the_port_and_jax_reads_the_ports(name, tmp_path):
    """JAX's ``save_network`` writes what its models save (a ``params``
    tree; the depth trainer a network's variables), the port reads it as
    its models (or the depth trainer) do: the parameters are bit-equal to
    ``from_flax*`` of the tree, the forward (BatchNorm statistics carried
    by ``from_flax*`` where the network has them) within 2e-4 of JAX's.
    Then the port writes its parameters and JAX's ``load_network`` reads
    them back bit for bit."""
    case = FILE_CASES[name]
    case = case() if callable(case) else case
    make_j, init_in, init_kw, make_t, fwd_in, gan, read, apply_kw = case
    jm = make_j()
    variables = _variables(jm, *init_in, **init_kw)
    net = make_t()
    if read is _read_variables:
        path = jckpt.save_network(variables, str(tmp_path / "jax"), "G", 1)
        read(path, net)
        conv = pp.from_flax_pose if name.endswith("pose") else \
            pp.from_flax_monodepth
        want = conv(variables)
    else:
        path = jckpt.save_network(variables["params"], str(tmp_path / "jax"),
                                  "G", 1)
        read(path, net)
        want = (pp.from_flax_gan(variables, gan) if gan
                else pp.from_flax_variables(variables))
        params = {k for k, _ in net.named_parameters()}
        _sd_equal(net, {k: v for k, v in want.items() if k in params})
        net.load_state_dict({**net.state_dict(), **want})   # the statistics
    _sd_equal(net, want)
    got = _port_out(name, net, fwd_in)
    ref = _jax_out(name, jm, variables, fwd_in, apply_kw)
    for g, w in (zip(got, ref) if isinstance(ref, list) else [(got, ref)]):
        _close(g, w)
    # port → JAX
    if read is _read_variables:
        to = pp.to_flax_pose if name.endswith("pose") else pp.to_flax_monodepth
        out = ckpt.save_network(to(net.state_dict()), str(tmp_path / "port"),
                                "G", 2)
        back_sd = conv(jckpt.load_network(out, variables))
    else:
        out = ckpt.save_network(params_tree_of(net), str(tmp_path / "port"),
                                "G", 2)
        back_sd = _to_port(gan, jckpt.load_network(out, variables["params"]))
    sd = net.state_dict()
    for k, v in back_sd.items():
        assert torch.equal(v, sd[k]), k


# ------------------------------------------------------------ refusals

def test_non_orbax_directory_is_refused_naming_metadata(tmp_path):
    """A directory that is not an orbax checkpoint is refused naming the
    ``_METADATA`` it lacks."""
    (tmp_path / "7_G.ckpt").mkdir()
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        ckpt.load_pytree(str(tmp_path / "7_G.ckpt"))


def test_orbax_backend_saves_directories_jax_restores(tmp_path, monkeypatch):
    """``checkpoint_backend: orbax`` and ``ENDOSR_CKPT_BACKEND=orbax``
    build models whose saves are directories JAX's ``load_pytree``
    restores to the port's own reading (``tests/test_torch_orbax.py``
    holds the backend itself)."""
    d = tmp_path / "run"
    opt = model_opt("sr", {"which_model_G": "MSRResNet", "nf": 8, "nb": 1},
                    path={"checkpoint_backend": "orbax", "models": str(d),
                          "training_state": str(d)})
    tm = create_model(copy.deepcopy(opt), device="cpu")
    for path in (tm.save(3), tm.save_training_state(0, 3)):
        assert Path(path).is_dir()
        mine = ckpt.load_pytree(path)
        _equal(mine, jax.tree_util.tree_map(
            np.asarray, jckpt.load_pytree(path, None)))
    monkeypatch.setattr(ckpt, "_BACKEND", "orbax")
    opt["path"] = {"models": str(d / "env")}
    assert Path(create_model(copy.deepcopy(opt), device="cpu").save(
        4)).is_dir()
    assert Path(ckpt.save_pytree({"a": np.ones(2, np.float32)},
                                 str(tmp_path / "x.ckpt"))).is_dir()


def test_unset_backend_writes_pth_and_msgpack_writes_jax_files(tmp_path):
    for backend, suffix in ((None, ".pth"), ("msgpack", ".ckpt")):
        d = tmp_path / str(backend)
        opt = model_opt("sr", {"which_model_G": "MSRResNet", "nf": 8,
                               "nb": 1},
                        path={"models": str(d), "training_state": str(d),
                              "checkpoint_backend": backend})
        tm = create_model(copy.deepcopy(opt), device="cpu")
        assert tm.save(3).endswith("3_G" + suffix)
        head = Path(tm.save_training_state(0, 3)).read_bytes()[:4]
        assert ckpt.is_torch_file(head) == (backend is None)


# ------------------------------------------------ resume across packages

def _jax_steps(jm, batches, first):
    logs = []
    for n, b in enumerate(batches, first):
        jm.feed_data(b)
        jm.optimize_parameters(n)
        logs.append(dict(jm.log_dict))
    return logs


def _port_steps(tm, batches, first):
    logs = []
    for n, b in enumerate(batches, first):
        tm.feed_data(b)
        logs.append(dict(tm.optimize_parameters(n)))
    return logs


def _jax_resume(jm, path):
    """JAX's ``resume_training`` of ``path``, its leaves put back where
    the state's were, so the train step does not compile again."""
    shard = jax.tree_util.tree_map(lambda x: x.sharding, jm.state)
    out = jm.resume_training(path)
    jm.state = jax.tree_util.tree_map(jax.device_put, jm.state, shard)
    return out


def _logs_close(got, want, tol, label, wide=None):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), label
        for k, v in w.items():
            t = (wide or {}).get(k, tol)
            assert abs(g[k] - v) <= t * max(abs(v), 1e-12), \
                f"{label} {k}: {g[k]} vs {v}"


def _cross_resume(jm, tm, batches, tmp_path, rng_seed=None):
    """Both packages' runs of ``batches`` (four) from one start, each
    saving at step 2; then each resumes the other's save for steps 3–4.
    Returns {"jax", "port", "port_from_jax", "jax_from_port"}: logs of
    steps 3–4."""
    out = {}
    _jax_steps(jm, batches[:2], 1)
    jax_state = jm.save_training_state(0, 2)
    out["jax"] = _jax_steps(jm, batches[2:], 3)
    _port_steps(tm, batches[:2], 1)
    port_state = tm.save_training_state(0, 2)
    out["port"] = _port_steps(tm, batches[2:], 3)
    assert tm.resume_training(jax_state) == (0, 2)
    if rng_seed is not None:                 # the mask bins of steps 3–4
        tm._np_rng = np.random.default_rng(rng_seed)
        tm._np_rng.integers(0, tm.mask_num, 2)
    out["port_from_jax"] = _port_steps(tm, batches[2:], 3)
    assert _jax_resume(jm, port_state) == (0, 2)
    if rng_seed is not None:
        jm._np_rng = np.random.default_rng(rng_seed)
        jm._np_rng.integers(0, jm.mask_num, 2)
    out["jax_from_port"] = _jax_steps(jm, batches[2:], 3)
    return out


def _check_cross(r, tol, wide=None):
    _logs_close(r["port_from_jax"], r["jax"], tol, "port from JAX's", wide)
    _logs_close(r["jax_from_port"], r["port"], tol, "JAX from the port's",
                wide)


def _paths(opt, tmp_path, side):
    d = tmp_path / side
    opt["path"] = {**(opt.get("path") or {}), "models": str(d / "models"),
                   "training_state": str(d / "state"),
                   "checkpoint_backend": "msgpack"}
    return opt


@pytest.fixture(scope="module")
def x8(tmp_path_factory):
    """The fixture script's own JAX run (two steps, saved: its
    ``2.state``) carried on to step 4, and the port's run from the same
    start; each then resumes the other's step-2 state."""
    from endosr.config.options import dict_to_nonedict
    from tests.torch_models_common import quick_flax_init

    tmp = tmp_path_factory.mktemp("x8")
    jm, ev, y = fx.train_jax(str(tmp / "fixture"))
    batches = [fx.batch(n) for n in range(1, 5)]
    r = {"jax": _jax_steps(jm, batches[2:], 3)}
    tm = create_model(_paths(dict_to_nonedict(fx.fixture_opt(".")), tmp,
                             "port"), device="cpu")
    # the start: the seeded leaves the JAX model was built with
    lr = fx.LR
    with quick_flax_init(0):
        start = jm.netG.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, lr, lr, 3)), jnp.zeros((1, lr, lr, 1)),
                             jnp.zeros((1, lr, lr, fx.K)))["params"]
    tm.netG.load_state_dict(pp.from_flax(start))
    _port_steps(tm, batches[:2], 1)
    port_state = tm.save_training_state(0, 2)
    r["port"] = _port_steps(tm, batches[2:], 3)
    assert tm.resume_training(str(tmp / "fixture" / "2.state")) == (0, 2)
    r["port_from_jax"] = _port_steps(tm, batches[2:], 3)
    assert _jax_resume(jm, port_state) == (0, 2)
    r["jax_from_port"] = _jax_steps(jm, batches[2:], 3)
    return {"run": r, "tmp": tmp, "ev": ev, "y": y}


def test_x8_flagship_resumes_across_packages(x8):
    _check_cross(x8["run"], 1e-5)


def test_committed_fixture_is_what_the_script_makes(x8):
    tmp = x8["tmp"] / "fixture"
    for name in ("2_G.ckpt", "2.state"):
        _equal(msgpack_io.unpackb((tmp / name).read_bytes()),
               msgpack_io.unpackb((FIXTURE / name).read_bytes()))
    with np.load(FIXTURE / "input.npz") as z:
        for k, v in x8["ev"].items():
            assert np.array_equal(z[k], v), k
    assert np.array_equal(np.load(FIXTURE / "output.npy"), x8["y"])
    opt = fx.fixture_opt(".")
    del opt["path"]
    assert json.loads((FIXTURE / "opt.json").read_text()) == json.loads(
        json.dumps(opt))


def test_committed_fixture_loads_and_resumes_in_the_port(x8):
    """The JAX-written files (``chip_smoke.py`` phase 15d reads them on the
    card): the forward of ``2_G.ckpt`` within 2e-4 of JAX's stored output;
    ``2.state`` resumes to JAX's weights and steps."""
    opt = json.loads((FIXTURE / "opt.json").read_text())
    opt["path"] = {"pretrain_model_G": str(FIXTURE / "2_G.ckpt")}
    tm = create_model(copy.deepcopy(opt), device="cpu")
    with np.load(FIXTURE / "input.npz") as z:
        with torch.no_grad():
            got = tm.netG(*(torch.from_numpy(z[k]) for k in
                            ("LQ", "Depth", "DepthMaskList")))
    _close(got, np.load(FIXTURE / "output.npy"))
    opt["path"] = {}
    tm2 = create_model(copy.deepcopy(opt), device="cpu")
    assert tm2.resume_training(str(FIXTURE / "2.state")) == (0, 2)
    for k, v in tm.netG.state_dict().items():
        assert torch.equal(tm2.netG.state_dict()[k], v), k
    assert tm2.step == 2
    assert all(int(s["step"]) == 2 for s in tm2.optimizer_G.state.values())


SRGAN_TRAIN = {"gan_type": "gan", "gan_weight": 5e-3, "pixel_weight": 1e-2,
               "feature_weight": 0, "D_update_ratio": 1, "D_init_iters": 0,
               "lr_G": 1e-4, "lr_D": 1e-4, "beta1_D": 0.9, "beta2_D": 0.99,
               "weight_decay_D": 1e-4, "weight_decay_G": 1e-4}
D_LOGITS = {k: 2e-4 for k in ("D_real", "D_fake", "l_d_real", "l_d_fake",
                              "l_g_gan", "l_g_cls", "l_d_cls_real",
                              "l_d_cls_fake")}


def _u(rng, *shape):
    return rng.random(shape, dtype=np.float32)


def _gan_start(jm, tm, g_net, d_net):
    p = jax.tree_util.tree_map(np.asarray, jm.state.params)
    g = pp.from_flax(p["netG"]) if g_net == "MSRResNet" else \
        pp.from_flax_gan(p["netG"], g_net)
    tm.netG.load_state_dict(g)
    tm.netD.load_state_dict(pp.from_flax_gan(
        {"params": p["netD"], "batch_stats": p["netD_stats"]}, d_net))


def test_srgan_resumes_across_packages(tmp_path):
    opt = model_opt("srgan", {"which_model_G": "MSRResNet", "nf": 16,
                              "nb": 1}, dict(SRGAN_TRAIN),
                    network_D={"which_model_D": "discriminator_vgg_128",
                               "nf": 8})
    opt["datasets"]["train"]["LR_size"] = 16
    jm = jax_model(jmodels.create_model, _paths(copy.deepcopy(opt), tmp_path,
                                                "jax"))
    tm = create_model(_paths(copy.deepcopy(opt), tmp_path, "port"),
                      device="cpu")
    _gan_start(jm, tm, "MSRResNet", "DiscriminatorVGG128")
    rng = np.random.default_rng(40)
    batches = [{"LQ": _u(rng, 2, 16, 16, 3), "GT": _u(rng, 2, 64, 64, 3)}
               for _ in range(4)]
    _check_cross(_cross_resume(jm, tm, batches, tmp_path), 1e-5, D_LOGITS)


def test_sftgan_resumes_across_packages(tmp_path):
    t = {"gan_type": "gan", "gan_weight": 5e-3, "pixel_weight": 1.0,
         "feature_weight": 0, "D_update_ratio": 1, "D_init_iters": 0,
         "lr_G": 1e-4, "lr_D": 1e-4, "beta1_G": 0.9, "beta1_D": 0.9}
    opt = model_opt("sftgan", {"which_model_G": "sft_arch"}, t)
    opt["datasets"]["train"]["LR_size"] = 8
    jm = jax_model(jmodels.create_model, _paths(copy.deepcopy(opt), tmp_path,
                                                "jax"))
    tm = create_model(_paths(copy.deepcopy(opt), tmp_path, "port"),
                      device="cpu")
    _gan_start(jm, tm, "SFTNet", "ACDVGGBN96")
    rng = np.random.default_rng(41)
    batches = [{"LR": _u(rng, 2, 8, 8, 3), "GT": _u(rng, 2, 32, 32, 3),
                "seg": _u(rng, 2, 32, 32, 8),
                "category": np.array([3, 0], np.int64)} for _ in range(4)]
    _check_cross(_cross_resume(jm, tm, batches, tmp_path), 1e-5, D_LOGITS)


def test_depthseg_resumes_across_packages(tmp_path):
    from tests.test_torch_depthseg import NET, TRAIN, _batch, _opt

    opt = _opt()
    jm = jax_model(jmodels.create_model, _paths(copy.deepcopy(opt), tmp_path,
                                                "jax"))
    tm = create_model(_paths(copy.deepcopy(opt), tmp_path, "port"),
                      device="cpu")
    p = jax.tree_util.tree_map(np.asarray, jm.state.params)
    named = pp.from_flax_seg_train(p)
    with torch.no_grad():
        for k, v in tm.named_train_parameters():
            v.copy_(named[k])
    tm.segNet.load_state_dict({k[len("segNet."):]: v for k, v in
                               named.items() if k.startswith("segNet.")})
    assert NET["use_trainable_params"] and TRAIN["segNet"]["momentum"]
    batches = [_batch(seed) for seed in (11, 12, 13, 14)]
    r = _cross_resume(jm, tm, batches, tmp_path, rng_seed=0)
    _check_cross(r, 1e-5)


DH, DW = 64, 64          # the smallest frame the decoder's padding takes


def test_depth_trainer_resumes_across_packages(tmp_path, monkeypatch):
    """Two steps in each trainer from one start, ``save_model``, then the
    other's ``load_model`` of that folder (JAX's: ``.ckpt`` files,
    ``meta.json``, ``adam.ckpt``) and steps 3–4: losses within 1e-5."""
    argv = ["--data_path", str(tmp_path), "--height", str(DH), "--width",
            str(DW), "--batch_size", "2", "--num_layers", "18",
            "--scheduler_step_size", "1", "--num_workers", "0",
            "--scales", "0", "--frame_ids", "0", "-1"]
    jt = jax_trainer(JO.MonodepthOptions().parse(
        argv + ["--log_dir", str(tmp_path / "jax")]), seed=5)
    jt.opt = types.SimpleNamespace(**vars(jt.opt))
    tt = Trainer(TO.MonodepthOptions().parse(
        argv + ["--log_dir", str(tmp_path / "port"), "--no_cuda"]), seed=5)
    tt.opt = types.SimpleNamespace(**vars(tt.opt))
    for name, sd in pp.from_flax_depth_trainer(jt.variables).items():
        tt.models[name].load_state_dict(sd)
    batches = [make_batch(seed, (0, -1), 1, DH, DW) for seed in (1, 2, 3, 4)]
    step = jt._build_train_step()

    def jax_step(b):
        params = {k: v["params"] for k, v in jt.variables.items()}
        params, jt.opt_state, losses = step(
            params, jt.opt_state, to_jax(b), jax.random.PRNGKey(jt.step))
        for k in jt.variables:
            jt.variables[k]["params"] = jax.tree_util.tree_map(np.asarray,
                                                               params[k])
        jt.step += 1
        return float(losses["loss"])

    def port_step(b):
        return float(tt.train_step(to_port(b), noise=jax_noise(tt.step))["loss"])

    out = {}
    for side, run, tr in (("jax", jax_step, jt), ("port", port_step, tt)):
        [run(b) for b in batches[:2]]
        if side == "port":
            monkeypatch.setattr(ckpt, "_BACKEND", "msgpack")
        folder = str(Path(tr.log_path) / "models" / "weights_0")
        tr.save_model()
        monkeypatch.setattr(ckpt, "_BACKEND", None)
        out[side] = ([run(b) for b in batches[2:]], folder)
    assert sorted(p.name for p in Path(out["port"][1]).iterdir()) == [
        "adam.ckpt", "depth.ckpt", "encoder.ckpt", "meta.json", "pose.ckpt",
        "pose_encoder.ckpt"]
    tt.opt.load_weights_folder = out["jax"][1]
    tt.load_model()
    assert tt.step == 2
    jt.opt.load_weights_folder = out["port"][1]
    jt.load_model()
    jt.step = 2              # JAX's load_model leaves its step (meta.json)
    got = {"port": [port_step(b) for b in batches[2:]],
           "jax": [jax_step(b) for b in batches[2:]]}
    for side, other in (("port", "jax"), ("jax", "port")):
        for g, w in zip(got[side], out[other][0]):
            assert abs(g - w) <= 1e-5 * abs(w), (side, g, w)
