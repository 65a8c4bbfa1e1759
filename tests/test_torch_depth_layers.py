"""The port's monodepth2 geometry (``endosr_torch/depth/layers.py``) and
warps (``endosr_torch/ops/warp.py``) against the JAX package's, on the CPU
in fp32, on seeded numpy inputs.

- SE(3) from axis-angle (both directions), translation matrices,
  back-projection and projection ≤ 1e-6 of max |ref|;
- ``grid_sample`` (bilinear, border padding, ``align_corners=False``):
  values and the gradients with respect to the image and to the grid, on
  grids that reach past every border (no sample on an exact tie, where
  the two packages may take another side) ≤ 1e-6 of max |ref|;
- the smoothness and the monodepth SSIM map, values and gradients
  ≤ 1e-6 of max |ref|;
- ``flow_warp`` and ``duf_downsample`` (×2, ×3 on sides that are no
  multiple of 3, ×4) ≤ 1e-6 of max |ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosr.depth import layers as J
from endosr.ops import warp as JW
from endosr_torch.depth import layers as T
from endosr_torch.ops import warp as TW
from tests.torch_depth_common import nrel
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters_matches_jax(invert):
    rng = np.random.default_rng(1)
    aa = (rng.standard_normal((5, 1, 3)) * 0.3).astype(np.float32)
    aa[0] = 0.0                              # the 1e-7 guard of a zero angle
    tr = (rng.standard_normal((5, 1, 3)) * 0.5).astype(np.float32)
    want = np.asarray(J.transformation_from_parameters(
        jnp.asarray(aa), jnp.asarray(tr), invert=invert))
    got = T.transformation_from_parameters(torch.from_numpy(aa),
                                           torch.from_numpy(tr), invert)
    assert got.shape == (5, 4, 4)
    assert nrel(got.numpy(), want) <= TOL
    np.testing.assert_array_equal(got[:, 3].numpy(), want[:, 3])


def test_rotation_and_translation_matrices_match_jax():
    rng = np.random.default_rng(2)
    aa = (rng.standard_normal((4, 1, 3)) * 0.7).astype(np.float32)
    t = rng.standard_normal((4, 3)).astype(np.float32)
    assert nrel(T.rot_from_axisangle(torch.from_numpy(aa)).numpy(),
                J.rot_from_axisangle(jnp.asarray(aa))) <= TOL
    for shape in ((4, 3), (4, 1, 3)):
        np.testing.assert_array_equal(
            T.get_translation_matrix(torch.from_numpy(t.reshape(shape))).numpy(),
            np.asarray(J.get_translation_matrix(jnp.asarray(t.reshape(shape)))))


@pytest.mark.parametrize("hw", [(8, 12), (16, 20)])
def test_backproject_and_project_match_jax(hw):
    h, w = hw
    rng = np.random.default_rng(h)
    depth = rng.uniform(0.5, 20.0, (2, h, w, 1)).astype(np.float32)
    k = np.array([[0.82 * w, 0, 0.5 * w, 0], [0, 1.02 * h, 0.5 * h, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    ks = np.stack([k, k * np.float32(1.1)]).astype(np.float32)
    ks[:, 3] = [0, 0, 0, 1]
    inv_k = np.linalg.inv(ks).astype(np.float32)
    aa = (rng.standard_normal((2, 1, 3)) * 0.05).astype(np.float32)
    tr = (rng.standard_normal((2, 1, 3)) * 0.1).astype(np.float32)
    tmat = np.array(J.transformation_from_parameters(aa, tr))

    pts_j = J.backproject_depth(jnp.asarray(depth), jnp.asarray(inv_k))
    pts_t = T.backproject_depth(_nchw(depth), torch.from_numpy(inv_k))
    assert pts_t.shape == (2, 4, h * w)
    assert nrel(pts_t.numpy(), pts_j) <= TOL
    pix_j = J.project_3d(pts_j, jnp.asarray(ks), jnp.asarray(tmat), h, w)
    pix_t = T.project_3d(torch.from_numpy(np.array(pts_j)),
                         torch.from_numpy(ks), torch.from_numpy(tmat), h, w)
    assert pix_t.shape == (2, h, w, 2)
    assert nrel(pix_t.numpy(), pix_j) <= TOL


def _grid(rng, b, ho, wo, reach=1.3):
    """Normalised grid points over [-reach, reach]², none on a tie: no
    point lands on an integer pixel coordinate or on a border."""
    return rng.uniform(-reach, reach, (b, ho, wo, 2)).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 9, 13, 3, 7, 11), (1, 16, 20, 5, 16, 20)])
def test_grid_sample_values_and_gradients_match_jax(shape):
    b, h, w, c, ho, wo = shape
    rng = np.random.default_rng(h * w)
    img = rng.random((b, h, w, c)).astype(np.float32)
    grid = _grid(rng, b, ho, wo)
    cot = rng.standard_normal((b, ho, wo, c)).astype(np.float32)
    # every border is crossed
    assert (grid < -1).any() and (grid > 1).any()

    def jf(img, grid):
        return jnp.sum(J.grid_sample(img, grid) * cot)

    want, (gi_j, gg_j) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(grid))
    img_t = _nchw(img).requires_grad_()
    grid_t = torch.from_numpy(grid).requires_grad_()
    out = T.grid_sample(img_t, grid_t)
    assert out.shape == (b, c, ho, wo)
    np.testing.assert_allclose(
        _nhwc(out), np.asarray(J.grid_sample(jnp.asarray(img),
                                             jnp.asarray(grid))),
        rtol=0, atol=TOL)
    (out * _nchw(cot)).sum().backward()
    assert nrel(_nhwc(img_t.grad), gi_j) <= TOL
    assert nrel(grid_t.grad.numpy(), gg_j) <= TOL
    # outside the image the grid's gradient is 0 in both
    out_x = (np.abs(grid[..., 0]) > 1.0 + 1.0 / w)
    assert np.all(grid_t.grad.numpy()[..., 0][out_x] == 0)
    assert np.all(np.asarray(gg_j)[..., 0][out_x] == 0)


def test_smooth_loss_and_ssim_match_jax():
    rng = np.random.default_rng(4)
    disp = rng.random((2, 12, 16, 1)).astype(np.float32)
    img = rng.random((2, 12, 16, 3)).astype(np.float32)
    x = rng.random((2, 12, 16, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)

    jl, jg = jax.value_and_grad(J.get_smooth_loss, argnums=(0, 1))(
        jnp.asarray(disp), jnp.asarray(img))
    d_t, i_t = _nchw(disp).requires_grad_(), _nchw(img).requires_grad_()
    tl = T.get_smooth_loss(d_t, i_t)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= TOL * abs(float(jl))
    assert nrel(_nhwc(d_t.grad), jg[0]) <= TOL
    assert nrel(_nhwc(i_t.grad), jg[1]) <= TOL

    cot = rng.standard_normal(x.shape).astype(np.float32)
    want, jgx = jax.value_and_grad(
        lambda a, b: jnp.sum(J.ssim_monodepth(a, b) * cot), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    x_t, y_t = _nchw(x).requires_grad_(), _nchw(y).requires_grad_()
    m = T.ssim_monodepth(x_t, y_t)
    assert nrel(_nhwc(m), J.ssim_monodepth(jnp.asarray(x), jnp.asarray(y))) <= TOL
    (m * _nchw(cot)).sum().backward()
    assert nrel(_nhwc(x_t.grad), jgx[0]) <= TOL
    assert nrel(_nhwc(y_t.grad), jgx[1]) <= TOL


def test_disp_to_depth_matches_jax():
    disp = np.random.default_rng(5).random((2, 1, 6, 8)).astype(np.float32)
    for a, b in zip(J.disp_to_depth(jnp.asarray(disp), 0.1, 100.0),
                    T.disp_to_depth(torch.from_numpy(disp), 0.1, 100.0)):
        assert nrel(b.numpy(), a) <= TOL


@pytest.mark.parametrize("hw", [(10, 14), (16, 16)])
def test_flow_warp_matches_jax(hw):
    h, w = hw
    rng = np.random.default_rng(h + w)
    x = rng.random((2, h, w, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, h, w, 2)) * 3.3).astype(np.float32)
    got = TW.flow_warp(torch.from_numpy(x), torch.from_numpy(flow))
    assert got.shape == x.shape
    assert nrel(got.numpy(), JW.flow_warp(jnp.asarray(x), jnp.asarray(flow))) <= TOL


@pytest.mark.parametrize("scale,hw", [(2, (40, 44)), (3, (41, 43)), (4, (48, 52))])
def test_duf_downsample_matches_jax(scale, hw):
    rng = np.random.default_rng(scale)
    x = rng.random((2, 3, *hw, 3)).astype(np.float32)
    want = np.asarray(JW.duf_downsample(jnp.asarray(x), scale))
    got = TW.duf_downsample(torch.from_numpy(x), scale)
    assert got.shape == want.shape
    assert nrel(got.numpy(), want) <= TOL
    with pytest.raises(ValueError):
        TW.duf_downsample(torch.from_numpy(x), 5)
