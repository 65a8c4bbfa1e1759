"""DepthNet's unmasked forward H-sharded (``endosr_torch/parallel/
spatial.py::spatial_forward``) and ``spatial_jit``, against the JAX
package's unsharded forward on the CPU.

Each net is a JAX ``DepthNet`` (nb 5, latent 16, K 4, style groups of 2)
on seeded leaves (``quick_flax_init``), carried to the port with
``from_flax``; the inputs are a seeded 16×12 frame, batch 2. The port's
``spatial_forward`` runs on 2 and on 4 gloo ranks started as ``torchrun``
starts them (``tests/torch_dist_common.py``; 8 and 4 LR rows a rank, the
least JAX allows at 4 ranks; 3 ranks for the odd frame below), every
rank on the same whole inputs, and
every rank's whole SR is held against JAX's unsharded ``apply``:

- fp32 within 2e-4 (JAX's own spatial bar, ``tests/test_spatial_parallel
  .py:49``): ×2 and ×8 at their defaults (×8: the packed tail, its chains,
  head and output stage on slabs extended by four LR rows), ×4 with the
  fused epilogue and the ``in_stats`` kernel route (the stats-in
  ``fused_in_mod`` on each slab; the phase-split head), ×2 with the
  depth-block ablation (its style image whole on every rank);
- ``bf16c`` at ×2 (one-pass centered convs, bf16 branches): its distance
  from JAX's bf16c forward at most 0.7 of JAX's own distance from its
  fp32 forward (RMS), ``tests/test_torch_precision.py``'s bar for the
  one-pass centered precisions;
- the depth-matrix ablation: its encoder gives the trunk H − 1 rows for
  an even H, so JAX's forward fails on any H an even mesh divides, and
  the port's sharded forward refuses it by name;
- frames whose rows do not split into equal 4-row units a rank
  (``parallel/spatial.py::row_layout``), fp32 within 2e-4 of JAX's
  unsharded forward: 18 rows on 2 ranks (slabs of 8 and 10: the last
  slab's half and quarter heights are odd) at ×2, ×8 and ×4 with the fused
  epilogue; 24 rows on 4 ranks (8, 8, 4, 4) at ×8; 15 × 11 on 3 ranks
  (4, 4, 7) with the depth-matrix ablation, which needs an odd frame and
  so runs only on an odd number of ranks;
- ``spatial_jit`` of JAX's generic case (``tests/test_spatial_parallel
  .py:100-113``: a 3×3 conv minus its whole-image mean, the mean through
  ``whole_mean``) within 1e-5 of the same function in JAX on the whole
  input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosr.nn.depthnet import DepthNet as JaxDepthNet
from endosr_torch.utils.port_params import from_flax
from tests.torch_dist_common import run_ranks
from tests.torch_models_common import quick_flax_init, tree_np
from tests.torch_threads import one_torch_thread  # noqa: F401

K, H, W, B = 4, 16, 12, 2
TOL = 2e-4
SMALL = dict(nb=5, depth_latent_ch=16, depth_range_num=K, style_chunk=2)
# case: (fields of both packages, the port-only fields, JAX's precision)
CASES = {
    "x2": (dict(scale=2, which_resblk_depth=(0, 1, 3, 4)), {}, None),
    "x8": (dict(scale=8, which_resblk_depth=(0, 1)), {}, None),
    "x4_fused_epilogue": (dict(scale=4, which_resblk_depth=(0, 1),
                               fused_epilogue=True), {"in_stats": "kernel"},
                          None),
    "x2_bf16c": (dict(scale=2, which_resblk_depth=(0, 1, 3, 4)), {},
                 "bf16c"),
    "x2_ablate_depth_block": (dict(scale=2, which_resblk_depth=(0, 1, 3, 4),
                                   ablate_depth_block=True), {}, None),
    "x2_ablate_depth_matrix": (dict(scale=2, which_resblk_depth=(0, 1, 3, 4),
                                    ablate_depth_matrix=True), {}, None),
}
WORLDS = (2, 4)
# world: (H, W, cases) of a frame whose slabs are uneven
UNEVEN = {2: (18, 12, ("x2", "x8", "x4_fused_epilogue")),
          4: (24, 12, ("x8",)),
          3: (15, 11, ("x2_ablate_depth_matrix",))}


def _inputs(seed=11, h=H, w=W):
    rng = np.random.default_rng(seed)
    lq = rng.random((B, h, w, 3), dtype=np.float32)
    dep = rng.random((B, h, w, 1), dtype=np.float32)
    bins = rng.integers(0, K, (B, h, w))
    mk = (bins[..., None] == np.arange(K)).astype(np.float32)
    return lq, dep, mk


def _jit_inputs():
    w = (np.random.default_rng(0).standard_normal((3, 3, 2, 4)) * 0.1
         ).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 2)).astype(
        np.float32)
    return w, x


def _jax_jit_fn(params, x):
    y = jax.lax.conv_general_dilated(
        x, params, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y - jnp.mean(y, axis=(1, 2), keepdims=True)


@pytest.fixture(scope="module")
def jax_refs():
    """Per case: the port's fields, its state and JAX's forwards (the
    precision's, and fp32 for bf16c), or the exception JAX's raised."""
    inputs = _inputs()
    refs = {}
    for name, (shared, port_only, precision) in CASES.items():
        fields = {**SMALL, **shared}
        jnet = JaxDepthNet(**fields)
        # the weights' shapes do not depend on the frame's: an odd one
        # lets the depth-matrix ablation's init trace
        odd = [a[:, :H - 1, :W - 1] for a in inputs]
        with quick_flax_init(0):
            params = jnet.init(jax.random.PRNGKey(0), *odd)["params"]
        ref = {"state": from_flax(tree_np(params)),
               "net": {**fields, **port_only}}
        try:
            ref["fp32"] = np.asarray(jnet.apply({"params": params}, *inputs))
        except (TypeError, ValueError) as e:
            ref["error"] = e
        for world, (h, w, names) in UNEVEN.items():
            if name in names:
                ref[f"uneven{world}"] = np.asarray(jnet.apply(
                    {"params": params}, *_inputs(h=h, w=w)))
        if "error" in ref:
            refs[name] = ref
            continue
        if precision == "bf16c":
            jq = JaxDepthNet(**fields, modulation_dtype=jnp.bfloat16,
                             centered_convs=1)
            ref["want"] = np.asarray(jq.apply({"params": params}, *inputs))
            ref["net"].update(modulation_dtype="bfloat16", centered_convs=1)
        else:
            ref["want"] = ref["fp32"]
        refs[name] = ref
    return refs


@pytest.fixture(scope="module")
def ranks(jax_refs, tmp_path_factory):
    """Each world's ranks' outputs, every case run by one launch (world 3:
    its uneven case alone)."""
    inputs = _inputs()
    w, x = _jit_inputs()
    out = {}
    for world in (*WORLDS, 3):
        cases = {} if world == 3 else {
            name: {"net": ref["net"], "state": ref["state"],
                   "inputs": inputs} for name, ref in jax_refs.items()}
        h, wd, names = UNEVEN[world]
        for name in names:
            cases[f"uneven:{name}"] = {
                "net": jax_refs[name]["net"], "state": jax_refs[name]["state"],
                "inputs": _inputs(h=h, w=wd)}
        out[world] = run_ranks(
            "spatial_unmasked_job", world, {"cases": cases, "jit": None if
                                            world == 3 else {"w": w, "x": x}},
            tmp_path_factory.mktemp(f"w{world}"))
    return out


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c for c in CASES
                                  if c not in ("x2_bf16c",
                                               "x2_ablate_depth_matrix")])
def test_sharded_forward_matches_jax(jax_refs, ranks, case, world):
    want = jax_refs[case]["want"]
    scale = CASES[case][0]["scale"]
    for r, out in enumerate(ranks[world]):
        got = out[case]
        assert torch.is_tensor(got), (r, got)
        assert tuple(got.shape) == want.shape == (B, H * scale, W * scale, 3)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= TOL, f"{case} world {world} rank {r}: max |Δ| {err:.3g}"


@pytest.mark.parametrize("world, case", [(world, case) for world, (_, _, names)
                                         in UNEVEN.items() for case in names])
def test_uneven_slabs_match_jax(jax_refs, ranks, world, case):
    h, w, _ = UNEVEN[world]
    want = jax_refs[case][f"uneven{world}"]
    scale = CASES[case][0]["scale"]
    for r, out in enumerate(ranks[world]):
        got = out[f"uneven:{case}"]
        assert torch.is_tensor(got), (r, got)
        assert tuple(got.shape) == want.shape == (B, h * scale, w * scale, 3)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= TOL, f"{case} {h} rows, world {world} rank {r}: " \
            f"max |Δ| {err:.3g}"


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_bf16c_within_the_centered_precision_bar(jax_refs, ranks,
                                                         world):
    ref = jax_refs["x2_bf16c"]
    own = _rms(ref["want"] - ref["fp32"])
    for r, out in enumerate(ranks[world]):
        got = out["x2_bf16c"].numpy()
        assert got.shape == ref["want"].shape
        dist = _rms(got - ref["want"])
        assert dist <= 0.7 * own, (f"world {world} rank {r}: RMS {dist:.3g} "
                                   f"against JAX's bf16c, JAX's own "
                                   f"{own:.3g} from fp32")


@pytest.mark.parametrize("world", WORLDS)
def test_depth_matrix_ablation_refused_as_jax_fails(jax_refs, ranks, world):
    assert isinstance(jax_refs["x2_ablate_depth_matrix"].get("error"),
                      (TypeError, ValueError))
    for out in ranks[world]:
        kind, msg = out["x2_ablate_depth_matrix"]
        assert kind == "ValueError" and "depth-matrix ablation" in msg


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_jit_generic_fn_matches_jax(ranks, world):
    w, x = _jit_inputs()
    want = np.asarray(_jax_jit_fn(jnp.asarray(w), jnp.asarray(x)))
    for out in ranks[world]:
        got = out["jit"].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
