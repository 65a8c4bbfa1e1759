"""The port's four kernel modules against the JAX package's twins (CPU, fp32).

On the CPU each wrapper runs its plain PyTorch version, and so does the
JAX function (its Pallas kernel falls back to the jnp twin off the TPU).
Same numpy inputs into both; tolerance 1e-5 max abs, and exact for the
pure data movement of ``output_stage_x8``. The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``.

Also here: a wrapper given a tensor that lies on a CUDA device launches
the kernel or raises — it never falls back to the plain version — and the
launch counters stay 0 on the CPU.
"""

import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# modules by name: a package may export a function under a module's name
jax_hd = importlib.import_module("endosr.kernels.head_dot")
jax_os = importlib.import_module("endosr.kernels.output_stage")
jax_pc = importlib.import_module("endosr.kernels.packed_chain")
jax_sd = importlib.import_module("endosr.kernels.style_dot")
t_hd = importlib.import_module("endosr_torch.kernels.head_dot")
t_os = importlib.import_module("endosr_torch.kernels.output_stage")
t_pc = importlib.import_module("endosr_torch.kernels.packed_chain")
t_sd = importlib.import_module("endosr_torch.kernels.style_dot")

TOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _cmp(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max |Δ| {err:.3g} > {tol}"


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- packed_g123

@pytest.mark.parametrize("mode", ["phases+pre_act+pre_bias", "pre_act"])
def test_packed_g123_matches_jax_twin(mode):
    rng = _rng(3)
    nx, mx, b, cin4, c4 = 8, 10, 2, 16, 16
    k1 = _f32(rng, 2, 2, cin4, c4, s=0.2)
    k2, k3 = _f32(rng, 2, 2, c4, c4, s=0.2), _f32(rng, 2, 2, c4, c4, s=0.2)
    b1, b2, b3 = (_f32(rng, c4, s=0.1) for _ in range(3))
    if mode == "pre_act":
        x = _f32(rng, nx, mx, b, cin4, s=0.5)
        want = jax_pc.packed_g123_reference(
            jnp.asarray(x), k1, b1, k2, b2, k3, b3, pre_act=True)
        got = t_pc.packed_g123(_t(x), *map(_t, (k1, b1, k2, b2, k3, b3)),
                               pre_act=True)
    else:
        hg, wg = nx // 2 + 1, mx // 2 + 1
        g4 = _f32(rng, hg, wg, b, 4 * cin4, s=0.5)
        g4[hg - 1] = 9.0      # the dead row and column the interleave drops
        g4[:, wg - 1] = -9.0
        pb = _f32(rng, cin4, s=0.1)
        want = jax_pc.packed_g123_reference(
            jax_pc.unfold_g4_phases(jnp.asarray(g4)), k1, b1, k2, b2, k3, b3,
            pre_act=True, pre_bias=jnp.asarray(pb))
        got = t_pc.packed_g123(_t(g4), *map(_t, (k1, b1, k2, b2, k3, b3)),
                               pre_act=True, pre_bias=_t(pb), phases=True)
    assert got.shape == (nx + 1, mx + 1, b, c4)
    _cmp(got.numpy(), want)


def test_unfold_g4_phases_matches_jax():
    g4 = _f32(_rng(4), 5, 6, 2, 12)
    _cmp(t_pc.unfold_g4_phases(_t(g4)).numpy(),
         jax_pc.unfold_g4_phases(jnp.asarray(g4)), 0.0)


# ----------------------------------------------------------- style_blend_dot

@pytest.mark.parametrize("blocks", [2, 1], ids=["group_of_2", "group_of_1"])
def test_style_blend_dot_matches_jax_twin(blocks):
    """Two style groups of uneven size, as the flagship's 7 + 6."""
    rng = _rng(5 + blocks)
    b, h, w, j, c2 = 2, 8, 8, 36, 16
    n = 2 * blocks
    sh = (rng.random((b, h, w, j)) > 0.7).astype(np.float32)
    v = _f32(rng, b, j, n * c2, s=0.3)
    convs = [_f32(rng, h, w, b, c2) for _ in range(n)]
    bias = _f32(rng, n * c2, s=0.1)
    want = jax_sd.style_blend_reference(jnp.asarray(sh), jnp.asarray(v),
                                        tuple(map(jnp.asarray, convs)),
                                        jnp.asarray(bias))
    got = t_sd.style_blend_dot(_t(sh), _t(v), tuple(map(_t, convs)), _t(bias))
    _cmp(got.numpy(), want)


# ------------------------------------------------------------------ head_dot

@pytest.mark.parametrize("pre_bias", [True, False], ids=["pre_bias", "raw"])
def test_head_dot_matches_jax_twin(pre_bias):
    """``wout`` smaller than the padded width: the dead column and the pad
    columns are gated."""
    rng = _rng(7)
    hp, wc, b, c4, cout, wout = 9, 16, 2, 32, 64, 12
    g4 = _f32(rng, hp, wc, b, c4)
    w64 = _f32(rng, 3, 3, c4, cout, s=0.1)
    b64 = _f32(rng, cout, s=0.1)
    pb = _f32(rng, c4, s=0.1) if pre_bias else None
    want = jax_hd.head_dot_reference(jnp.asarray(g4), jnp.asarray(w64),
                                     jnp.asarray(b64), wout,
                                     None if pb is None else jnp.asarray(pb))
    got = t_hd.head_dot(_t(g4), _t(w64), _t(b64), wout,
                        None if pb is None else _t(pb))
    assert got.shape == (hp - 1, b, wout, cout)
    _cmp(got.numpy(), want)


# ----------------------------------------------------------- output_stage_x8

@pytest.mark.parametrize("order", ["bhwc", "hbwc"])
def test_output_stage_x8_matches_jax_twin_exactly(order):
    pre = (_rng(8).standard_normal((2, 4, 8, 64)) * 0.7 + 0.5).astype(np.float32)
    if order == "hbwc":
        pre = np.ascontiguousarray(pre.transpose(1, 0, 2, 3))
    want = jax_os.output_stage_x8_reference(jnp.asarray(pre), 0.0, 1.0, order)
    got = t_os.output_stage_x8(_t(pre), 0.0, 1.0, order)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_embed_head_channels_matches_jax_exactly():
    rng = _rng(9)
    w, b = _f32(rng, 3, 3, 8, 48), _f32(rng, 48)
    wj, bj = jax_os.embed_head_channels(jnp.asarray(w), jnp.asarray(b))
    wt, bt = t_os.embed_head_channels(_t(w), _t(b))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


# ------------------------------------------------------ no silent CPU fallback

class _CudaClaim:
    """Stands in for a tensor on a CUDA device (there is none here)."""

    device = torch.device("cuda")
    dtype = torch.bfloat16

    def __init__(self, shape):
        self.shape = torch.Size(shape)

    def stride(self, dim=None):
        st = torch.empty(self.shape, device="meta").stride()
        return st if dim is None else st[dim]


def _wrapper_calls():
    c = _CudaClaim
    return {
        "output_stage_x8": lambda: t_os.output_stage_x8(c((4, 2, 8, 64)),
                                                        order="hbwc"),
        "head_dot": lambda: t_hd.head_dot(
            c((9, 16, 2, 32)), torch.zeros(3, 3, 32, 64), torch.zeros(64), 8),
        "packed_g123": lambda: t_pc.packed_g123(
            c((8, 8, 2, 16)), *(torch.zeros(2, 2, 16, 16), torch.zeros(16)) * 3,
            pre_act=True),
        "style_blend_dot": lambda: t_sd.style_blend_dot(
            c((2, 4, 4, 9)), c((2, 9, 32)), (c((4, 4, 2, 16)),) * 2,
            torch.zeros(32)),
    }


@pytest.mark.parametrize("name", ["output_stage_x8", "head_dot",
                                  "packed_g123", "style_blend_dot"])
def test_wrapper_on_cuda_tensor_raises_without_kernel(name, monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr("endosr_torch.kernels._build.os.path.exists",
                        lambda p: False)
    # no nvcc here: the wrapper must fail to build, not run the plain version
    with pytest.raises(RuntimeError, match="nvcc"):
        _wrapper_calls()[name]()


def test_cpu_calls_leave_launch_counters_at_zero():
    fns = (t_os.output_stage_x8, t_hd.head_dot, t_pc.packed_g123,
           t_sd.style_blend_dot)
    before = [f.launches for f in fns]
    t_os.output_stage_x8(torch.zeros(1, 8, 8, 64))
    t_hd.head_dot(torch.zeros(9, 9, 1, 16), torch.zeros(3, 3, 16, 64),
                  torch.zeros(64))
    t_pc.packed_g123(torch.zeros(4, 4, 1, 16),
                     *(torch.zeros(2, 2, 16, 16), torch.zeros(16)) * 3)
    t_sd.style_blend_dot(torch.zeros(1, 4, 4, 9), torch.zeros(1, 9, 32),
                         (torch.zeros(4, 4, 1, 16),) * 2, torch.zeros(32))
    assert [f.launches for f in fns] == before == [0, 0, 0, 0]


# -------------------------------------------------------------- import rule

_FORBIDDEN = ("jax", "flax", "optax", "endosr")


def _port_files():
    return sorted((REPO / "endosr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_or_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in _FORBIDDEN, f"{path.name} imports {mod}"
