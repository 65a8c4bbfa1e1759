"""``python -m endosr_torch.tools.port_checkpoint`` against the JAX
package's ``tools/port_torch_checkpoint.py`` on the same seeded ``.pth``.

A ``.pth`` of a seeded port generator (plus a reference file's dead
``depth-residual14`` tensors, which both porters drop) goes through both
CLIs with the same YAML: the two ``.ckpt`` trees are equal leaf for leaf
(paths, dtypes, shapes and bits). The JAX tool's template comes from
``tests/torch_models_common.py::quick_flax_init`` (its values are all
replaced by the ``.pth``'s). Cases: the test YAML's DepthNet cut to nb 4,
latent 16, one depth block (×8 and, through ``scale``, ×4), and an SR
YAML with MSRResNet. A ``.pth`` that lacks a key of the network fails in
both (the strict fit, C10's rule).
"""

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from endosr_torch.nn.networks import define_G
from endosr_torch.tools import port_checkpoint
from endosr_torch.utils.port_params import seeded_init
from tests.torch_models_common import quick_flax_init
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TEST_YAML = REPO / "options/test/test_depthNet.yml"
DN = {"nb": 4, "depth_latent_ch": 16, "which_ResBlk_depth": [0]}

CASES = {
    "DepthNet x8": (8, DN),
    "DepthNet x4": (4, DN),
    "MSRResNet x4": (4, {"which_model_G": "MSRResNet", "nf": 16, "nb": 2}),
}


def _yaml(tmp_path, scale, net):
    y = yaml.safe_load(TEST_YAML.read_text())
    y["scale"] = scale
    y["network_G"].update(net, upscale=scale)
    for ds in y["datasets"].values():
        ds.update(LR_size=8)
    path = tmp_path / "opt.yml"
    path.write_text(yaml.safe_dump(y))
    return str(path), y


def _pth(tmp_path, y, dead=True):
    net = seeded_init(define_G(y, device="cpu"), 7)
    sd = dict(net.state_dict())
    if dead and y["network_G"]["which_model_G"] == "DepthNet":
        sd["depth-residual14.conv1.0.weight_v"] = torch.zeros(64, 64, 3, 3)
    path = tmp_path / "gen.pth"
    torch.save(sd, path)
    return str(path), sd


def _run_jax(monkeypatch, pth, opt, out):
    monkeypatch.setattr(sys, "argv", ["port_torch_checkpoint.py", "--pth",
                                      pth, "--opt", opt, "--out", out])
    with quick_flax_init(0):
        runpy.run_path(str(REPO / "tools/port_torch_checkpoint.py"),
                       run_name="__main__")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_cli_matches_jax_tool(case, tmp_path, monkeypatch):
    scale, net = CASES[case]
    opt, y = _yaml(tmp_path, scale, net)
    pth, _ = _pth(tmp_path, y)
    _run_jax(monkeypatch, pth, opt, str(tmp_path / "jax.ckpt"))
    n = port_checkpoint.main(["--pth", pth, "--opt", opt, "--out",
                              str(tmp_path / "port.ckpt")])
    want = dict(_leaves(serialization.msgpack_restore(
        (tmp_path / "jax.ckpt").read_bytes())))
    got = dict(_leaves(serialization.msgpack_restore(
        (tmp_path / "port.ckpt").read_bytes())))
    assert sorted(got) == sorted(want)
    assert n == len(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_a_missing_key_fails_in_both(tmp_path, monkeypatch):
    opt, y = _yaml(tmp_path, 8, DN)
    pth, sd = _pth(tmp_path, y, dead=False)
    del sd["conv_output.weight"]
    torch.save(sd, pth)
    with pytest.raises(KeyError, match="conv_output"):
        port_checkpoint.main(["--pth", pth, "--opt", opt, "--out",
                              str(tmp_path / "port.ckpt")])
    with pytest.raises(KeyError):
        _run_jax(monkeypatch, pth, opt, str(tmp_path / "jax.ckpt"))
    assert not (tmp_path / "port.ckpt").exists()
