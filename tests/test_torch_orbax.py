"""The orbax checkpoint backend in the port (``endosr_torch/utils/
{zstd,orbax_io,checkpoint}.py``), against orbax, tensorstore and the JAX
package on the CPU (``zstandard`` only as a reference here; the port
imports none of them).

- ``utils/zstd.py`` decodes every zstd frame of the JAX-written orbax
  fixture (tensorstore's OCDBT nodes and zarr chunks) and frames of the
  ``zstandard`` package at levels −5 to 19, with and without the content
  checksum, to its bytes; many frames at once (their Huffman streams
  side by side) and one alone by that route, and a stream read past its
  end raises.
- ``read_ocdbt`` reads a tensorstore OCDBT store with interior B+tree
  nodes and values in data files key for key, value for value.
- Trees across packages: what JAX's ``save_pytree`` writes with the orbax
  backend (fp32, fp64, bf16, int32/64, bool, 0-d, empty dicts) reads in
  the port bit-equal, and JAX's ``load_pytree`` restores what the port's
  writes bit-equal; a second save to a path replaces the first and leaves
  no ``.tmp`` or ``.old`` behind.
- The ×8 flagship model resumes across packages with orbax directories
  both ways (``tests/test_torch_checkpoint.py``'s msgpack case, the same
  1e-5 relative bar on the logs of steps 3–4).
- The committed fixture ``tests/data/jax_orbax/`` equals, value by value,
  what ``tests/make_jax_ckpt_fixture.py --backend orbax`` makes now and
  the msgpack fixture of the same run; its ``2_G.ckpt/`` forward lies
  within 2e-4 of JAX's stored output and its ``2.state/`` resumes.
- ``python -m endosr_torch.tools.port_checkpoint`` takes an orbax
  directory in and writes one out (``--backend orbax``).
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

import endosr.utils.checkpoint as jckpt
from endosr_torch.models import create_model
from endosr_torch.tools import port_checkpoint as cli
from endosr_torch.utils import checkpoint as ckpt
from endosr_torch.utils import orbax_io, zstd
from endosr_torch.utils import port_params as pp
from tests import make_jax_ckpt_fixture as fx
from tests.test_torch_checkpoint import (_check_cross, _close, _equal,
                                         _jax_resume, _jax_steps,
                                         _port_steps)
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "jax_orbax"
MSGPACK = REPO / "tests" / "data" / "jax_ckpt"


def _samples():
    rng = np.random.default_rng(5)
    return {
        "empty": b"",
        "text": b"the quick brown fox jumps over the lazy dog " * 300,
        "fp32": rng.standard_normal(40000).astype(np.float32).tobytes(),
        "bf16": (rng.standard_normal(60000).astype(np.float32).view(
            np.uint32) >> 16).astype(np.uint16).tobytes(),
        "ints": np.arange(70000, dtype=np.int32).tobytes(),
        "runs": b"\x00" * 200000 + b"\x01" * 5,
        "small_alphabet": bytes(rng.integers(0, 4, 150000, dtype=np.uint8)),
    }


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
def test_zstd_reads_zstandard_frames(level):
    for name, data in _samples().items():
        for checksum in (False, True):
            frame = zstandard.ZstdCompressor(
                level=level, write_checksum=checksum).compress(data)
            assert zstd.decompress(frame) == data, (name, checksum)
    # two frames, the first streamed (no content size), then a skippable one
    c = zstandard.ZstdCompressor(level=level).compressobj()
    text = _samples()["text"]
    streamed = c.compress(text) + c.flush()
    skip = (0x184D2A50).to_bytes(4, "little") + (3).to_bytes(4, "little") \
        + b"abc"
    assert zstd.decompress(streamed + skip + streamed) == text * 2


@pytest.mark.parametrize("level", [-5, 1, 19])
def test_zstd_decodes_many_frames_side_by_side(level, monkeypatch):
    """``decompress_many`` decodes the Huffman streams of all the frames it
    is given side by side (``_huffman_lockstep``), also when one frame is
    all there is; a stream read past or short of its end raises."""
    datas = [d for d in _samples().values() for _ in (0, 1)]
    frames = [zstandard.ZstdCompressor(
        level=level, write_checksum=bool(i % 2)).compress(d)
        for i, d in enumerate(datas)]
    assert zstd.decompress_many(frames) == datas
    monkeypatch.setattr(zstd, "_LOCKSTEP_STREAMS", 1)
    for frame, data in zip(frames, datas):
        assert zstd.decompress(frame) == data
    huffman = zstandard.ZstdCompressor(level=3).compress(_samples()["fp32"])
    fr, _ = zstd._frame(memoryview(huffman).cast("B"), 0)
    (stream, table, n), *_ = fr.jobs()
    for decode in (lambda j: zstd._huffman_lockstep([j]),
                   lambda j: zstd._huffman_stream(*j)):
        with pytest.raises(ValueError, match="end"):
            decode((stream, table, n + 1))


def test_zstd_reads_the_fixtures_frames():
    for name in ("2_G.ckpt", "2.state"):
        kv = orbax_io.read_ocdbt(str(FIXTURE / name))
        chunks = [orbax_io._value(str(FIXTURE / name), v)
                  for k, v in kv.items() if not k.endswith(".zarray")]
        assert chunks
        for frame in chunks:
            assert zstd.decompress(frame) == \
                zstandard.ZstdDecompressor().decompressobj().decompress(frame)
        nodes = sorted((FIXTURE / name).rglob("d/*"))
        for p in nodes:
            raw = p.read_bytes()
            if raw[:4] == bytes.fromhex("0cdb20de"):
                body = raw[14:-4]
                assert zstd.decompress(body) == \
                    zstandard.ZstdDecompressor().decompressobj().decompress(
                        body)


def test_ocdbt_interior_nodes_and_data_file_values(tmp_path):
    import tensorstore as ts

    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}",
        "config": {"max_decoded_node_bytes": 300,
                   "max_inline_value_bytes": 8,
                   "compression": {"id": "zstd"}}}).result()
    want = {}
    for i in range(60):
        key = f"k{i % 7}/{i:03d}/.zarray"
        want[key] = bytes([i]) * (i % 23)
        kv.write(key, want[key]).result()
    got = orbax_io.read_ocdbt(str(tmp_path))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert orbax_io._value(str(tmp_path), got[k]) == v, k


def _tree():
    rng = np.random.default_rng(7)
    return {"params": {"conv": {"kernel": rng.standard_normal(
        (3, 3, 4, 5)).astype(np.float32), "bias": np.zeros(5, np.float32)},
        "half": jnp.asarray(rng.standard_normal((6, 7)), jnp.bfloat16),
        "f64": rng.standard_normal(3), "flag": np.array([True, False])},
        "opt_state": {"0": {"count": np.asarray(3, np.int32)}, "1": {},
                      "2": {"mu": {"w": rng.standard_normal(4).astype(
                          np.float32)}}},
        "epoch": np.asarray(2, np.int64), "iter": np.asarray(9, np.int64)}


def _port_leaf(v):
    return np.asarray(v.float()).astype(jnp.bfloat16) if torch.is_tensor(v) \
        else np.asarray(v)


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
        return
    g, w = _port_leaf(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, path
    assert g.tobytes() == w.tobytes(), path


def test_jax_written_tree_reads_in_the_port(tmp_path):
    tree = _tree()
    jckpt.save_pytree(tree, str(tmp_path / "t.ckpt"), "orbax")
    got = ckpt.load_pytree(str(tmp_path / "t.ckpt"))
    assert torch.is_tensor(got["params"]["half"])
    assert got["params"]["half"].dtype == torch.bfloat16
    _same(got, jax.tree_util.tree_map(np.asarray, tree))


def test_port_written_tree_restores_in_jax(tmp_path):
    tree = _tree()
    port_tree = copy.deepcopy(jax.tree_util.tree_map(np.asarray, tree))
    port_tree["params"]["half"] = torch.from_numpy(
        np.asarray(tree["params"]["half"]).view(np.int16)).view(torch.bfloat16)
    path = str(tmp_path / "t.ckpt")
    ckpt.save_pytree(port_tree, path, "orbax")
    first = json.loads((tmp_path / "t.ckpt" / "_METADATA").read_text())
    port_tree["iter"] = np.asarray(10, np.int64)
    ckpt.save_pytree(port_tree, path, "orbax")    # replaces the first
    assert sorted(p.name for p in tmp_path.iterdir()) == ["t.ckpt"]
    assert first["use_ocdbt"] is False
    back = jckpt.load_pytree(path, None)
    want = jax.tree_util.tree_map(np.asarray, tree)
    want["iter"] = np.asarray(10, np.int64)
    _same(back, want)
    _same(ckpt.load_pytree(path), want)


@pytest.fixture(scope="module")
def x8o(tmp_path_factory):
    """``tests/test_torch_checkpoint.py``'s ×8 cross resume with the orbax
    backend on both sides: the fixture script's JAX run saves orbax
    directories at step 2 and goes on to step 4, the port's run from the
    same start does the same, and each resumes the other's ``2.state/``."""
    from endosr.config.options import dict_to_nonedict
    from tests.torch_models_common import quick_flax_init

    tmp = tmp_path_factory.mktemp("x8o")
    jm, _, _ = fx.train_jax(str(tmp / "fixture"), "orbax")
    batches = [fx.batch(n) for n in range(1, 5)]
    r = {"jax": _jax_steps(jm, batches[2:], 3)}
    opt = dict_to_nonedict(fx.fixture_opt(".", "orbax"))
    opt["path"] = {"models": str(tmp / "port"),
                   "training_state": str(tmp / "port" / "state"),
                   "checkpoint_backend": "orbax"}
    tm = create_model(opt, device="cpu")
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
    return {"run": r, "tmp": tmp, "port_state": port_state}


def test_x8_flagship_resumes_across_packages_with_orbax(x8o):
    assert Path(x8o["port_state"]).is_dir()
    _check_cross(x8o["run"], 1e-5)


def test_committed_orbax_fixture_is_what_the_script_makes(x8o):
    for name in ("2_G.ckpt", "2.state"):
        committed = ckpt.load_pytree(str(FIXTURE / name))
        _equal(ckpt.load_pytree(str(x8o["tmp"] / "fixture" / name)),
               committed)
        _equal(committed, ckpt.load_pytree(str(MSGPACK / name)))


def test_committed_orbax_fixture_loads_and_resumes_in_the_port():
    opt = json.loads((MSGPACK / "opt.json").read_text())
    opt["path"] = {"pretrain_model_G": str(FIXTURE / "2_G.ckpt")}
    tm = create_model(copy.deepcopy(opt), device="cpu")
    with np.load(MSGPACK / "input.npz") as z:
        with torch.no_grad():
            got = tm.netG(*(torch.from_numpy(z[k]) for k in
                            ("LQ", "Depth", "DepthMaskList")))
    _close(got, np.load(MSGPACK / "output.npy"))
    opt["path"] = {}
    tm2 = create_model(copy.deepcopy(opt), device="cpu")
    assert tm2.resume_training(str(FIXTURE / "2.state")) == (0, 2)
    for k, v in tm.netG.state_dict().items():
        assert torch.equal(tm2.netG.state_dict()[k], v), k
    assert all(int(s["step"]) == 2 for s in tm2.optimizer_G.state.values())


def test_port_checkpoint_cli_takes_and_writes_orbax_directories(tmp_path):
    import yaml

    fixture = json.loads((MSGPACK / "opt.json").read_text())
    y = yaml.safe_load((REPO / "options/test/test_depthNet.yml").read_text())
    y["scale"] = fixture["scale"]
    y["network_G"] = {**fixture["network_G"], "upscale": fixture["scale"]}
    for ds in y["datasets"].values():
        ds.update(LR_size=8, depthMaskNum=fx.K)
    yml = tmp_path / "opt.yml"
    yml.write_text(yaml.safe_dump(y))
    out = tmp_path / "G.ckpt"
    n = cli.main(["--pth", str(FIXTURE / "2_G.ckpt"), "--opt", str(yml),
                  "--out", str(out), "--backend", "orbax"])
    assert n > 0 and out.is_dir()
    want = ckpt.load_pytree(str(MSGPACK / "2_G.ckpt"))
    _equal(ckpt.load_pytree(str(out)), want)
    back = jckpt.load_pytree(str(out), None)
    _same(back, jax.tree_util.tree_map(
        lambda v: np.asarray(v.float()) if torch.is_tensor(v)
        else np.asarray(v), want))
