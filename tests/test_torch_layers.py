"""The port's layers, ops and SEAN helpers against their JAX counterparts
(CPU, fp32, same numpy inputs; 1e-5 max abs, exact where the function
only moves or selects values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosr.nn import depthnet as j_dn
from endosr.nn import layers as jl
from endosr.nn import sean as j_sean
from endosr.ops import masks as j_masks
from endosr.ops import resize as j_resize
from endosr_torch.nn import depthnet as t_dn
from endosr_torch.nn import layers as tl
from endosr_torch.nn import sean as t_sean
from endosr_torch.ops import masks as t_masks
from endosr_torch.ops import resize as t_resize
from endosr_torch.utils.port_params import from_flax

TOL = 1e-5


def _f32(seed, *shape, s=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * s).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cmp(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, f"max |Δ| {err:.3g} > {tol}"


def _load_module(module, flax_params, name="m"):
    """Load a JAX submodule's params, as if named ``name``, into the
    matching port module."""
    sd = {k[len(name) + 1:]: v
          for k, v in from_flax({name: flax_params}).items()}
    module.load_state_dict(sd, strict=True)
    return module


# ------------------------------------------------------------------ convs

@pytest.mark.parametrize("stride", [1, 2])
def test_wnconv_matches_jax(stride):
    x = _f32(0, 2, 9, 9, 5)
    jm = jl.WNConv(7, 3, stride, 1)
    p = jm.init(jax.random.PRNGKey(1), x)["params"]
    tm = _load_module(tl.WNConv(5, 7, 3, stride, 1), jax.tree_util.tree_map(np.asarray, p))
    _cmp(tm(_t(x), torch.float32), jm.apply({"params": p}, x))


def test_wnconv_transpose_matches_jax():
    x = _f32(1, 2, 5, 5, 6)
    jm = jl.WNConvTranspose(4, 3, 2, 1)
    p = jm.init(jax.random.PRNGKey(2), x)["params"]
    # the encoder's layer4 is the transposed conv whose layout from_flax maps
    tm = _load_module(tl.WNConvTranspose(6, 4, 3, 2, 1),
                      jax.tree_util.tree_map(np.asarray, p), "layer4")
    _cmp(tm(_t(x), torch.float32), jm.apply({"params": p}, x))


def test_conv_matches_jax():
    x = _f32(2, 1, 6, 7, 4)
    jm = jl.Conv(8, 3, 1, 1)
    p = jm.init(jax.random.PRNGKey(3), x)["params"]
    tm = _load_module(tl.Conv(4, 8, 3), jax.tree_util.tree_map(np.asarray, p))
    _cmp(tm(_t(x), torch.float32), jm.apply({"params": p}, x))


def test_wn_effective_kernel_matches_jax():
    p = jl.WNConvParams(27, (3, 3, 3, 6), jnp.float32)(jax.random.PRNGKey(4))
    p = jax.tree_util.tree_map(np.asarray, p)
    tm = _load_module(tl.WNConv(3, 6), p)
    wj, bj = jl.wn_effective_kernel(p)
    wt, bt = tl.wn_effective_kernel(tm)
    _cmp(wt, wj)
    _cmp(bt, bj, 0.0)


# ------------------------------------------------------------------ norms

@pytest.mark.parametrize("fn", ["instance_norm", "chained_instance_norm"])
def test_instance_norms_match_jax(fn):
    x = _f32(5, 2, 6, 5, 4, s=3.0) + 1.5
    _cmp(getattr(tl, fn)(_t(x)), getattr(jl, fn)(jnp.asarray(x)))


# ---------------------------------------------------- shuffles and folds

@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_matches_jax(r):
    x = _f32(6, 2, 3, 4, 3 * r * r)
    _cmp(tl.pixel_shuffle(_t(x), r), jl.pixel_shuffle(jnp.asarray(x), r), 0.0)


def test_leaky_relu_matches_jax():
    x = _f32(7, 100)
    _cmp(tl.leaky_relu(_t(x)), jl.leaky_relu(jnp.asarray(x)), 0.0)


@pytest.mark.parametrize("k,r", [(3, 2), (9, 4), (9, 2)])
def test_fold_kernel_through_pixel_shuffle_matches_jax(k, r):
    w = _f32(8, k, k, 3, 2)
    _cmp(tl.fold_kernel_through_pixel_shuffle(_t(w), r),
         jl.fold_kernel_through_pixel_shuffle(jnp.asarray(w), r), 0.0)


@pytest.mark.parametrize("s_in,s_out,inter", [(0, 1, True), (1, 0, False),
                                              (0, 1, False)])
def test_packed_stage_kernel_matches_jax(s_in, s_out, inter):
    w = _f32(9, 3, 3, 4, 5)
    _cmp(tl.packed_stage_kernel(_t(w), s_in, s_out, inter),
         jl.packed_stage_kernel(jnp.asarray(w), s_in, s_out, inter), 0.0)


@pytest.mark.parametrize("s", [0, 1])
def test_packed_gate_matches_jax(s):
    for a, b in zip(tl.packed_gate(6, 3, s), jl.packed_gate(6, 3, s, jnp.float32)):
        _cmp(a, b, 0.0)


def test_compose_pixel_shuffle_perm_matches_jax():
    np.testing.assert_array_equal(tl.compose_pixel_shuffle_perm(2, 2, 64),
                                  jl.compose_pixel_shuffle_perm(2, 2, 64))


# ------------------------------------------------------------------ ops

@pytest.mark.parametrize("size", [(8, 8), (12, 6), (3, 5)])
def test_interpolate_nearest_matches_jax(size):
    x = _f32(10, 2, 8, 8, 3)
    _cmp(t_resize.interpolate_nearest(_t(x), size),
         j_resize.interpolate_nearest(jnp.asarray(x), size), 0.0)


@pytest.mark.parametrize("align", [True, False])
def test_interpolate_bilinear_matches_jax(align):
    x = _f32(11, 2, 16, 16, 4)
    _cmp(t_resize.interpolate_bilinear(_t(x), (7, 5), align),
         j_resize.interpolate_bilinear(jnp.asarray(x), (7, 5), align))


@pytest.mark.parametrize("fixed", [True, False])
def test_depth_masks_match_jax(fixed):
    d = np.random.default_rng(12).random((2, 9, 11)).astype(np.float32)
    _cmp(t_masks.depth_masks(_t(d), fixed, 10),
         j_masks.depth_masks(jnp.asarray(d), fixed, 10), 0.0)
    _cmp(t_masks.depth_masks_np(d[0], fixed, 10),
         j_masks.depth_masks_np(d[0], fixed, 10), 0.0)


def test_region_wise_avg_pooling_matches_jax():
    f = _f32(13, 2, 4, 4, 6)
    m = (np.random.default_rng(14).random((2, 16, 16, 3)) > 0.5).astype(np.float32)
    _cmp(t_dn.region_wise_avg_pooling(_t(f), _t(m)),
         j_dn.region_wise_avg_pooling(jnp.asarray(f), jnp.asarray(m)))


# ------------------------------------------------------- SEAN lazy helpers

def _sean_weights(n, c=4, k=3, l=5):
    """n random SEAN weight sets as JAX tuples and as the port's tuples."""
    jd, js, td, ts = [], [], [], []
    for i in range(n):
        s = 100 + 10 * i
        wm, bm = _f32(s, 3, 3, 1, 2 * c), _f32(s + 1, 2 * c)
        wob, bob = _f32(s + 2, 3, 3, 2 * c, 2 * c, s=0.3), _f32(s + 3, 2 * c)
        aw, ab = _f32(s + 4, 1, 1, k, k), _f32(s + 5, k)
        wg, bg = _f32(s + 6, 3, 3, l, c, s=0.3), _f32(s + 7, c)
        wb, bb = _f32(s + 8, 3, 3, l, c, s=0.3), _f32(s + 9, c)
        jd.append(({"kernel": wm, "bias": bm}, wob, bob))
        td.append((_t(wm), _t(bm), _t(wob), _t(bob)))
        js.append((aw, ab, {"kernel": wg, "bias": bg}, {"kernel": wb, "bias": bb}))
        ts.append((_t(aw[0, 0]), _t(ab), _t(wg), _t(bg), _t(wb), _t(bb)))
    return jd, js, td, ts


def test_precompute_o_actv_and_raw_conv_match_jax():
    jd, _, td, _ = _sean_weights(2)
    d = np.random.default_rng(15).random((2, 6, 6, 1)).astype(np.float32)
    aj = j_sean.precompute_o_actv(jd, jnp.asarray(d), jnp.float32)
    at = t_sean.precompute_o_actv(td, _t(d), torch.float32)
    al = (np.array([0.3], np.float32), np.array([0.7], np.float32))
    for i in range(2):
        _cmp(at[i], aj[i])
        _cmp(t_sean.o_branch_raw_hwnc(at[i], td[i], torch.float32,
                                      tuple(map(_t, al))),
             j_sean.o_branch_raw_hwnc(aj[i], jd[i], jnp.float32, al))


def test_style_v_and_mask_stack_match_jax():
    _, js, _, ts = _sean_weights(3)
    st = _f32(16, 2, 3, 5)
    vj = j_sean.precompute_style_v(js, jnp.asarray(st), jnp.float32)
    vt = t_sean.precompute_style_v(ts, _t(st), torch.float32)
    for a, b in zip(vt, vj):
        _cmp(a, b)
    m = (np.random.default_rng(17).random((2, 6, 7, 3)) > 0.5).astype(np.float32)
    _cmp(t_sean.shifted_mask_stack(_t(m), torch.float32),
         j_sean.shifted_mask_stack(jnp.asarray(m), jnp.float32,
                                   stack_conv=True), 0.0)


def test_style_blend_chunk_matches_jax():
    jd, js, td, ts = _sean_weights(2)
    st = _f32(18, 2, 3, 5)
    m = (np.random.default_rng(19).random((2, 8, 8, 3)) > 0.5).astype(np.float32)
    d = np.random.default_rng(20).random((2, 8, 8, 1)).astype(np.float32)
    al = [(np.array([0.2 + 0.1 * i], np.float32),
           np.array([0.6 - 0.1 * i], np.float32)) for i in range(2)]
    shj = j_sean.shifted_mask_stack(jnp.asarray(m), jnp.float32, stack_conv=True)
    vj = j_sean.precompute_style_v(js, jnp.asarray(st), jnp.float32)
    aj = j_sean.precompute_o_actv(jd, jnp.asarray(d), jnp.float32)
    convj = [j_sean.o_branch_raw_hwnc(aj[i], jd[i], jnp.float32, al[i])
             for i in range(2)]
    want = j_sean.style_blend_chunk(shj, list(vj), js, al,
                                    [w[2] for w in jd], convj, jnp.float32)
    alt = [tuple(map(_t, a)) for a in al]
    sht = t_sean.shifted_mask_stack(_t(m), torch.float32)
    vt = t_sean.precompute_style_v(ts, _t(st), torch.float32)
    at = t_sean.precompute_o_actv(td, _t(d), torch.float32)
    convt = [t_sean.o_branch_raw_hwnc(at[i], td[i], torch.float32, alt[i])
             for i in range(2)]
    got = t_sean.style_blend_chunk(sht, list(vt), ts, alt,
                                   [w[3] for w in td], convt, torch.float32)
    for (gt, bt), (gj, bj) in zip(got, want):
        _cmp(gt, gj)
        _cmp(bt, bj)
