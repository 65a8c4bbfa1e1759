"""DepthNet's lowering switches (``chain_in``, ``lazy_o_chunk``,
``pallas_packed_chain``, ``blend_fold``, ``obranch_body``,
``tail_defer_act``, ``mask_stack_conv``) at the values besides JAX's
defaults, against the JAX module at the same values on the CPU.

Each arm builds the JAX ``DepthNet`` and the port's with the same fields
(×2: nb 7, trunk blocks 0–3 in style groups of 2; ×8: nb 5, trunk blocks
0–1; latent 16, K 4; LR 8×12, batch 2; ``pallas_style`` off, a style
group's dot a plain matmul), the weights the JAX module's seeded leaves
(``quick_flax_init``) carried across with ``from_flax``; each JAX forward
runs once a module (``_jax`` keeps it):

- fp32: within 2e-4 max abs of JAX's forward (the repo's parity bar);
- bf16 (every stream and branch in bf16), RMS distances: the port's
  distance from JAX's bf16 forward, over JAX's own distance from its fp32
  forward (the ratio ``tests/test_torch_precision.py`` bounds), below 1
  and at most 1.1 × the same ratio of the default fields at that scale:
  an arm lies as close to JAX as the default path does. (The default
  path's ratio is 0.69 at ×2 and 0.78 at ×8 here; the arms' 0.48–0.78.)

``blend_fold`` is taken twice: with the blend kernel on (which folds the
blend whatever the field says, as in JAX) and with ``pallas_style_blend``
off (the reassociated blend of the lazy branches); ``lazy_o_chunk`` 2
lines up with the style groups (the blend kernel runs) and 1 does not
(the groups take ``style_dot_hwbm`` and per-block convs, as in JAX);
``obranch_body: dot`` on the lazy and on the hoisted trunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosr.nn.depthnet import DepthNet as JaxDepthNet
from endosr_torch.nn.depthnet import DepthNet
from endosr_torch.utils.port_params import from_flax
from tests.torch_models_common import quick_flax_init, tree_np
from tests.torch_threads import one_torch_thread  # noqa: F401

K, H, W, B = 4, 8, 12, 2
TOL = 2e-4
# pallas_style off on both sides: JAX runs its style-dot kernel in interpret
# mode on the CPU (≈ 8 s a forward here), and no arm touches that kernel
SMALL = dict(depth_latent_ch=16, depth_range_num=K, style_chunk=2,
             pallas_style=False)
NB = {2: 7, 8: 5}
WHICH = {2: (0, 1, 2, 3, 5, 6), 8: (0, 1)}
ARMS = {
    "chain_in": (2, {"chain_in": False}),
    "lazy_o_chunk_aligned": (2, {"lazy_o_chunk": 2}),
    "lazy_o_chunk_unaligned": (2, {"lazy_o_chunk": 1}),
    "pallas_packed_chain": (8, {"pallas_packed_chain": False}),
    "blend_fold": (2, {"blend_fold": True}),
    "blend_fold_unfused": (2, {"blend_fold": True,
                               "pallas_style_blend": False}),
    "obranch_body_lazy": (2, {"obranch_body": "dot"}),
    "obranch_body_hoisted": (2, {"obranch_body": "dot",
                                 "lazy_branches": False}),
    "tail_defer_act": (8, {"tail_defer_act": False}),
    "mask_stack_conv": (2, {"mask_stack_conv": False}),
}


def _inputs(seed=17):
    rng = np.random.default_rng(seed)
    return (rng.random((B, H, W, 3), dtype=np.float32),
            rng.random((B, H, W, 1), dtype=np.float32),
            (rng.random((B, H, W, K)) > 0.6).astype(np.float32))


@pytest.fixture(scope="module")
def params():
    """The JAX module's seeded leaves at each scale (every arm shares
    the parameter tree)."""
    out = {}
    for scale, which in WHICH.items():
        jnet = JaxDepthNet(**SMALL, nb=NB[scale], scale=scale,
                           which_resblk_depth=which)
        with quick_flax_init(0):
            out[scale] = jnet.init(jax.random.PRNGKey(0),
                                   *_inputs())["params"]
    return out


def _port(scale, fields, dtype, tree):
    net = DepthNet(**SMALL, nb=NB[scale], scale=scale,
                   which_resblk_depth=WHICH[scale], dtype=dtype, device="cpu",
                   **fields)
    net.load_state_dict(from_flax(tree_np(tree)), strict=True)
    net.eval()
    with torch.no_grad():
        return net(*(torch.from_numpy(a) for a in _inputs())).numpy()


_JAX_OUT = {}


def _jax(scale, fields, dtype, tree):
    key = (scale, tuple(sorted(fields.items())), jnp.dtype(dtype).name)
    if key not in _JAX_OUT:
        jnet = JaxDepthNet(**SMALL, nb=NB[scale], scale=scale,
                           which_resblk_depth=WHICH[scale], dtype=dtype,
                           **fields)
        _JAX_OUT[key] = np.asarray(jnet.apply({"params": tree}, *_inputs()),
                                   dtype=np.float32)
    return _JAX_OUT[key]


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_arm_matches_jax_in_fp32(params, arm):
    scale, fields = ARMS[arm]
    want = _jax(scale, fields, jnp.float32, params[scale])
    got = _port(scale, fields, torch.float32, params[scale])
    assert got.shape == want.shape == (B, H * scale, W * scale, 3)
    err = float(np.abs(got - want).max())
    assert err <= TOL, f"{arm}: max |Δ| {err:.3g}"


def _bf16_ratio(scale, fields, tree):
    """(the port's bf16 RMS distance from JAX's bf16 forward) / (JAX's
    bf16 RMS distance from its fp32 forward)."""
    want = _jax(scale, fields, jnp.bfloat16, tree)
    fp32 = _jax(scale, fields, jnp.float32, tree)
    got = _port(scale, fields, torch.bfloat16, tree)
    assert got.shape == want.shape and np.isfinite(got).all()
    return _rms(got - want) / _rms(want - fp32)


@pytest.fixture(scope="module")
def default_ratio(params):
    return {scale: _bf16_ratio(scale, {}, tree)
            for scale, tree in params.items()}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_arm_matches_jax_in_bf16(params, default_ratio, arm):
    scale, fields = ARMS[arm]
    ratio = _bf16_ratio(scale, fields, params[scale])
    base = default_ratio[scale]
    assert ratio < 1.0 and ratio <= 1.1 * base, (
        f"{arm}: {ratio:.3f} of JAX's own bf16 distance, the default "
        f"fields {base:.3f}")


def test_packed_chain_off_gives_head_dot_contiguous_channels(params,
                                                             monkeypatch):
    """``head_dot`` takes g4 with contiguous channels only (on the card it
    raises otherwise): with the plain chains the tail's input must be laid
    out BHWC, or the convs write NCHW."""
    import endosr_torch.nn.depthnet as dn

    seen = []

    def head_dot(g4, *args):
        seen.append(g4.stride(-1))
        return orig(g4, *args)

    orig = dn.head_dot
    monkeypatch.setattr(dn, "head_dot", head_dot)
    _port(8, {"pallas_packed_chain": False}, torch.float32, params[8])
    assert seen == [1]


def test_unknown_field_raises_type_error():
    with pytest.raises(TypeError, match="no_such_field"):
        DepthNet(**SMALL, nb=NB[2], scale=2, which_resblk_depth=WHICH[2],
                 device="cpu", no_such_field=1)
