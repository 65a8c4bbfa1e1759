"""The port's training step against the JAX package's, and the kernels'
gradients.

Kernels: each of the nine kernels with a JAX ``custom_vjp`` has a
``*_vjp`` in the port; on the same inputs and cotangent it equals the JAX
kernel's VJP (the JAX ``_bwd``, run on the CPU as the JAX tests run it) to
≤ 1e-5 of the gradient's largest magnitude in fp32 and 2⁻⁴ in bf16: both
sides round the backward's products and sums to bf16, in other orders;
a bias's gradient, one bf16 sum over every pixel, differs most (up to
3.6 %, the packed tail chain's deferred bias), the o-branch kernels'
conv1 weights up to 1.8 %, most others not at all. Through the
wrapper (autograd, the plain forward on the CPU) the gradient is
``*_vjp``'s, bit for bit.

Training: ``FModelDepthCond`` with ``is_train`` at the ×8 smoke
configuration (LR 16 → GT 128, nb 4, K 4, latent 16, batch 2, fp32 on the
CPU) on the JAX model's weights (``from_flax_train``), for the flagship
recipe (L1 + dynamic SmoothL1 × 10, cosine restarts, β2 0.99) and two
variants (L2 or Charbonnier pixel loss, the mask loss, SSIM, weight decay,
``MultiStepLR_Restart`` with ``clear_state`` at update 1, a uint8 batch):

- the first step's ``log_dict`` (keys and values) to ≤ 1e-5 relative;
- every gradient of that step to ≤ 2e-4 of the gradient's largest
  magnitude, plus four times the difference between two fp32 gradients
  of the port itself (oneDNN convolutions on and off): a gradient that is
  a small sum of large terms that cancel (the blend factor α, a scalar
  summed over every pixel) holds no more digits than that. The conv
  biases right before an InstanceNorm have a zero gradient; both sides
  must be ≤ 1e-7 of the largest gradient (they hold ~1e-9 of rounding).
  Masks are drawn per bin: with one-hot bins (every pixel in one bin)
  the SEAN style parameters' gradients shrink to ~1e-6 of the largest
  and keep fewer digits still (up to 1.7 % apart, the port against itself
  0.6 %);
- the parameters after 1 and 3 updates (Adam's first update is ≈
  ±lr for any gradient far from zero, so where two gradients that agree
  to their rounding straddle zero the updates differ by up to 2·lr). Every
  component within 2·lr an update; after one update the components whose
  Adam input (gradient + weight decay) exceeds 10× the tensor's gradient
  error within 1e-2·lr (measured ≤ 4.4e-3), and all of them within 1 %
  in norm of the distance they moved; after three updates, when the other
  components have moved the forward a little, within 5 % in norm
  (measured 0.1–1.2 %). The losses of steps 2 and 3 to ≤ 2e-4 relative
  (measured ≤ 5.3e-5) for the same reason.

Also: serve → train → serve in one process (constants first made under
inference mode are saved for backward later), checkpoints saved and read
back (weights, trainer state, a resumed update), the refusals by name
(depth and VGG losses whose weight files are missing, as JAX's, a field
the port does not take, gradients of the two kernels that have none), and
the LR queries.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from endosr.models.f_depthcond import FModelDepthCond as JaxModel
from endosr.parallel.mesh import make_mesh
from endosr_torch.kernels._autograd import refuse_grad
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.models.recipes import X8_YAML, x8_train_opt
from endosr_torch.utils.port_params import from_flax, from_flax_train

jax_fm = importlib.import_module("endosr.kernels.fused_mod")
jax_fo = importlib.import_module("endosr.kernels.fused_obranch")
jax_ft = importlib.import_module("endosr.kernels.fused_tail")
jax_hd = importlib.import_module("endosr.kernels.head_dot")
jax_os = importlib.import_module("endosr.kernels.output_stage")
jax_pc = importlib.import_module("endosr.kernels.packed_chain")
jax_sd = importlib.import_module("endosr.kernels.style_dot")
t_fm = importlib.import_module("endosr_torch.kernels.fused_mod")
t_fo = importlib.import_module("endosr_torch.kernels.fused_obranch")
t_ft = importlib.import_module("endosr_torch.kernels.fused_tail")
t_hd = importlib.import_module("endosr_torch.kernels.head_dot")
t_os = importlib.import_module("endosr_torch.kernels.output_stage")
t_pc = importlib.import_module("endosr_torch.kernels.packed_chain")
t_sd = importlib.import_module("endosr_torch.kernels.style_dot")

VJP_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -4}


def _f32(rng, *shape, s=1.0, mean=0.0):
    return (rng.standard_normal(shape) * s + mean).astype(np.float32)


def _mask(rng, *shape, p=0.7):
    return (rng.random(shape) > p).astype(np.float32)


# Each case: (numpy inputs, the JAX kernel on them, the port's wrapper on
# them, the port's *_vjp on them and a cotangent → one gradient an input).

def _packed(phases):
    rng = np.random.default_rng(30 + phases)
    b, c4 = 2, 16
    if phases:        # the tail chain: packed producer, deferred bias
        cin4 = 16
        x = _f32(rng, 5, 6, b, 4 * cin4)
    else:             # the up1 chain
        cin4 = 32
        x = _f32(rng, 7, 9, b, cin4)
    args = [x, _f32(rng, 2, 2, cin4, c4, s=0.2), _f32(rng, c4, s=0.1),
            _f32(rng, 2, 2, c4, c4, s=0.2), _f32(rng, c4, s=0.1),
            _f32(rng, 2, 2, c4, c4, s=0.2), _f32(rng, c4, s=0.1)]
    if phases:
        args.append(_f32(rng, cin4, s=0.1))
    pb = (lambda a: a[7]) if phases else (lambda a: None)
    return (args,
            lambda *a: jax_pc.packed_g123(*a[:7], None, None, True, pb(a),
                                          phases),
            lambda *a: t_pc.packed_g123(*a[:7], True, pb(a), phases),
            lambda *a, g: t_pc.packed_g123_vjp(*a[:7], pb(a), g, True,
                                               phases)[:len(a)])


def _blend():
    rng = np.random.default_rng(32)
    b, h, w, j, c2, n = 2, 6, 5, 36, 8, 4
    args = [_mask(rng, b, h, w, j), _f32(rng, b, j, n * c2, s=0.3),
            *[_f32(rng, h, w, b, c2) for _ in range(n)], _f32(rng, n * c2)]

    def vjp(*a, g):
        gs, gv, gc, gb = t_sd.style_blend_vjp(a[0], a[1], n, a[2].dtype,
                                              a[-1].dtype, g)
        return (gs, gv, *gc, gb)

    return (args,
            lambda s, v, *r: jax_sd.style_blend_dot(s, v, tuple(r[:-1]), r[-1]),
            lambda s, v, *r: t_sd.style_blend_dot(s, v, tuple(r[:-1]), r[-1]),
            vjp)


def _head(pre_bias):
    rng = np.random.default_rng(33)
    hp, wc, b, c4, wout = 7, 9, 2, 16, 6
    args = [_f32(rng, hp, wc, b, c4), _f32(rng, 3, 3, c4, 64, s=0.1),
            _f32(rng, 64, s=0.1)]
    if pre_bias:
        args.append(_f32(rng, c4, s=0.1))

    def pb(a):
        return a[3] if pre_bias else None

    return (args,
            lambda *a: jax_hd.head_dot(*a[:3], wout, pb(a)),
            lambda *a: t_hd.head_dot(*a[:3], wout, pb(a)),
            lambda *a, g: t_hd.head_dot_vjp(*a[:3], pb(a), g,
                                            wout=wout)[:len(a)])


def _out_x8(order):
    rng = np.random.default_rng(34)
    shape = (5, 2, 6, 64) if order == "hbwc" else (2, 5, 6, 64)
    args = [_f32(rng, *shape, s=0.6, mean=0.5)]
    return (args,
            lambda p: jax_os.output_stage_x8(p, 0.0, 1.0, order),
            lambda p: t_os.output_stage_x8(p, 0.0, 1.0, order),
            lambda p, g: t_os.output_stage_x8_vjp(p, g, 0.0, 1.0, order))


def _out(r):
    rng = np.random.default_rng(35)
    args = [_f32(rng, 2, 5, 6, 3 * r * r, s=0.6, mean=0.5)]
    return (args,
            lambda p: jax_os.output_stage(p, r, 0.0, 1.0),
            lambda p: t_os.output_stage(p, r, 0.0, 1.0),
            lambda p, g: t_os.output_stage_vjp(p, g, r, 0.0, 1.0))


def _style_hwbm():
    rng = np.random.default_rng(36)
    args = [_mask(rng, 2, 6, 5, 36), _f32(rng, 2, 36, 24, s=0.3)]
    return (args, jax_sd.style_dot_hwbm, t_sd.style_dot_hwbm,
            lambda s, v, g: t_sd.style_dot_vjp(s, v, g))


def _registered_bwd(module, reference):
    """The JAX kernel's own backward (``module._bwd``) with the twin's
    output: its forward is Pallas only, and the TPU kernel takes bf16 at
    32 × 128 and up; its ``_bwd`` is the VJP of ``reference``."""
    def fwd_and_vjp(*a):
        return reference(*a), lambda g: module._bwd(None, a, g)

    fwd_and_vjp.gives_vjp = True
    return fwd_and_vjp


def _obranch():
    rng = np.random.default_rng(37)
    b, h, w, n, c2 = 2, 6, 7, 3, 8
    args = [rng.random((b, h, w, 1), dtype=np.float32),
            _f32(rng, n, 9, c2, s=0.3), _f32(rng, n, c2, s=0.3),
            _f32(rng, n, 9, c2, c2, s=0.2), _f32(rng, n, c2, s=0.3)]
    return (args, _registered_bwd(jax_fo, jax_fo.fused_o_branch_reference),
            t_fo.fused_o_branch, lambda *a, g: t_fo.fused_o_branch_vjp(*a, g))


def _fmod():
    rng = np.random.default_rng(38)
    b, h, w, n, c2, k = 2, 6, 7, 3, 8, 4
    args = [rng.random((b, h, w, 1), dtype=np.float32), _mask(rng, b, h, w, k),
            _f32(rng, n, 9, c2, s=0.3), _f32(rng, n, c2, s=0.3),
            _f32(rng, n, 9 * c2, c2, s=0.2), _f32(rng, b, n, 9 * k, c2, s=0.3),
            _f32(rng, n, c2, s=0.3)]
    return (args, _registered_bwd(jax_fm, jax_fm.fused_modulation_reference),
            t_fm.fused_modulation,
            lambda *a, g: t_fm.fused_modulation_vjp(*a, g))


def _tail(layout):
    rng = np.random.default_rng(39)
    g4 = np.maximum(_f32(rng, 2, 7, 8, 16), 0.0)
    g4[:, 6] = 0.0                  # the dead row and columns, as fed
    g4[:, :, 6:] = 0.0
    wh, bh = _f32(rng, 3, 3, 16, 48, s=0.05), _f32(rng, 48, s=0.1, mean=0.5)
    if layout == "hwbc":
        g4 = np.ascontiguousarray(g4.transpose(1, 2, 0, 3))
    return ([g4, wh, bh],
            lambda *a: jax_ft.fused_tail(*a, 0.0, 1.0, layout),
            lambda *a: t_ft.fused_tail(*a, 0.0, 1.0, layout),
            lambda *a, g: t_ft.fused_tail_vjp(*a, None, g, 0.0, 1.0,
                                              layout)[:3])


KERNELS = {
    "packed_g123[up1]": lambda: _packed(False),
    "packed_g123[tail, phases, pre_bias]": lambda: _packed(True),
    "style_blend_dot": _blend,
    "head_dot": lambda: _head(False),
    "head_dot[pre_bias]": lambda: _head(True),
    "output_stage_x8[hbwc]": lambda: _out_x8("hbwc"),
    "output_stage_x8[bhwc]": lambda: _out_x8("bhwc"),
    "output_stage[r=2]": lambda: _out(2),
    "output_stage[r=3]": lambda: _out(3),
    "style_dot_hwbm": _style_hwbm,
    "fused_o_branch": _obranch,
    "fused_modulation": _fmod,
    "fused_tail[bhwc]": lambda: _tail("bhwc"),
    "fused_tail[hwbc]": lambda: _tail("hwbc"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_kernel_vjp_matches_jax(kernel, dtype):
    args, jfn, tfn, tvjp = KERNELS[kernel]()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in args]
    targs = [torch.from_numpy(a).to(tdt) for a in args]
    jout, jvjp = (jfn(*jargs) if getattr(jfn, "gives_vjp", False)
                  else jax.vjp(jfn, *jargs))
    rng = np.random.default_rng(40)
    g_np = rng.standard_normal(jout.shape).astype(np.float32)
    want = jvjp(jnp.asarray(g_np, jout.dtype))
    g = torch.from_numpy(g_np).to(getattr(torch, jout.dtype.name))
    got = tvjp(*targs, g=g)
    assert len(got) == len(want) == len(args)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= VJP_TOL[dtype] * scale, \
            f"input {i}: max |Δ| {err:.3g} > {VJP_TOL[dtype]:g} · {scale:.3g}"

    # through the wrapper: autograd takes *_vjp's gradients
    leaves = [t.clone().requires_grad_(True) for t in targs]
    out = tfn(*leaves)
    out.backward(g)
    for i, (leaf, a) in enumerate(zip(leaves, got)):
        assert torch.equal(leaf.grad, a.to(leaf.dtype)), f"input {i}"


def test_wrappers_take_autograd_only_when_asked():
    """No input requiring a gradient: the wrapper's output has no graph."""
    args, _, tfn, _ = _blend()
    out = tfn(*map(torch.from_numpy, args))
    assert out.grad_fn is None
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    assert type(tfn(*leaves).grad_fn).__name__ == "KernelFunctionBackward"
    with torch.no_grad():
        assert tfn(*leaves).grad_fn is None


def test_kernels_without_a_gradient_refuse_it_by_name():
    """``in_stats`` and ``fused_in_mod`` have no gradient in the JAX
    package on the TPU; on CUDA under autograd their wrappers raise (the
    check they call), never taking the plain version quietly."""
    x = torch.zeros(2, 4, 4, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="in_stats: kernel"):
        refuse_grad("in_stats", "in_stats: kernel", (x,))
    with pytest.raises(NotImplementedError, match="fused_epilogue"):
        refuse_grad("fused_in_mod", "net_kw: {fused_epilogue: true}",
                    (x.detach(), x))
    refuse_grad("in_stats", "in_stats: kernel", (x.detach(),))
    with torch.no_grad():
        refuse_grad("in_stats", "in_stats: kernel", (x,))


# ---------------------------------------------------------------- training

NET = {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3, "nf": 64,
       "nb": 4, "depth_latent_ch": 16, "which_ResBlk_depth": [0],
       "use_trainable_params": True}
K, LR, SCALE, B = 4, 16, 8, 2
FLAGSHIP = x8_train_opt()["train"]


def _variant(pixel, mask_criterion, dyn_criterion):
    return {**FLAGSHIP, "lr_scheme": "MultiStepLR_Restart", "beta2": 0.999,
            "lr_steps": [2], "lr_gamma": 0.5, "restarts": [1],
            "restart_weights": [0.5], "clear_state": True,
            "weight_decay_G": 1e-2, "pixel_criterion": pixel,
            "pixel_weight": 0.5,
            "ssim_loss": {"use_ssim_criterion": True, "ssim_weight": 0.3},
            "mask_loss": {"use_mask_criterion": True,
                          "mask_criterion": mask_criterion,
                          "mask_weight": 2.0},
            "dynamic_loss": {"use_dynamic_criterion": True,
                             "dynamic_criterion": dyn_criterion,
                             "dynamic_weight": 3.0},
            "manual_seed": 5}


RECIPES = {"flagship": (FLAGSHIP, False),
           "variant_l2_u8": (_variant("l2", "smoothl1", "l2"), True),
           "variant_cb_u8": (_variant("cb", "l1", "cb"), True)}
STEPS = 3


def _opt(train):
    return {"is_train": True, "model": "sftmd_depthCond", "scale": SCALE,
            "precision": None,
            "datasets": {"train": {"depthMaskNum": K, "LR_size": LR}},
            "network_G": dict(NET), "path": {}, "train": copy.deepcopy(train)}


def _train_batch(u8, seed=11, one_hot=False):
    """A seeded batch; masks independent per bin, or ``one_hot`` (every
    pixel in one bin, as depth binning gives)."""
    rng = np.random.default_rng(seed)
    gt = rng.random((B, LR * SCALE, LR * SCALE, 3), dtype=np.float32)
    lq = rng.random((B, LR, LR, 3), dtype=np.float32)
    if one_hot:
        bins = rng.integers(0, K, (B, LR, LR))
        masks = np.stack([bins == k for k in range(K)], -1)
    else:
        masks = rng.random((B, LR, LR, K)) > 0.6
    masks = masks.astype(np.float32)
    batch = {"LQ": lq, "GT": gt,
             "Depth": rng.random((B, LR, LR, 1), dtype=np.float32),
             "DepthMaskList": masks}
    if u8:
        batch.update(LQ=(lq * 255).astype(np.uint8),
                     GT=(gt * 255).astype(np.uint8),
                     DepthMaskList=masks.astype(np.uint8))
    return batch


def _jax_loss_fn(jm):
    """The JAX train step's own loss function (from its closure)."""
    step = jm._train_step.__wrapped__
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    return cells["loss_fn"]


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    """{recipe: the JAX and the port's runs}, each made once, when a test
    first asks for it."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run(*RECIPES[name])
        return cache[name]

    return get


def _run(train, u8):
    opt = _opt(train)
    jm = JaxModel(copy.deepcopy(opt), mesh=make_mesh(jax.devices()[:1]))
    p0 = _tree_np(jm.state.params)
    batch = _train_batch(u8)
    first_bin = np.random.default_rng(train["manual_seed"]).integers(0, K)
    jb = dict(batch, mask_bin=np.int32(first_bin))
    grads, _ = jax.jit(jax.grad(_jax_loss_fn(jm), has_aux=True))(
        jm.state.params, jb)
    out = {"grads_jax": from_flax_train(_tree_np(grads)), "logs_jax": [],
           "logs": [], "params_jax": {}, "params": {}}
    jm.feed_data(batch)
    for n in range(1, STEPS + 1):
        jm.optimize_parameters(n)
        out["logs_jax"].append(dict(jm.log_dict))
        out["params_jax"][n] = from_flax_train(_tree_np(jm.state.params))

    tm = FModelDepthCond(copy.deepcopy(opt), device="cpu")
    start = from_flax_train(p0)
    with torch.no_grad():
        for name, p in tm.named_train_parameters():
            p.copy_(start[name])
    tm.feed_data(batch)
    for n in range(1, STEPS + 1):
        out["logs"].append(dict(tm.optimize_parameters(n)))
        if n == 1:
            out["grads"] = {k: p.grad.clone()
                            for k, p in tm.named_train_parameters()}
        out["params"][n] = {k: p.detach().clone()
                            for k, p in tm.named_train_parameters()}
    # the rounding scale of each gradient: the port's own first gradient
    # once more with oneDNN's convolutions off (other summation orders)
    again = FModelDepthCond(copy.deepcopy(opt), device="cpu")
    with torch.no_grad():
        for name, p in again.named_train_parameters():
            p.copy_(start[name])
    again.feed_data(batch)
    with torch.backends.mkldnn.flags(enabled=False):
        again.optimize_parameters()
    out["noise"] = {k: float((p.grad - out["grads"][k]).abs().max())
                    for k, p in again.named_train_parameters()}
    out["start"], out["lr"], out["model"] = start, train["lr_G"], tm
    out["wd"] = float(train.get("weight_decay_G") or 0)
    return out


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_log_dict_matches_jax(runs, recipe):
    r = runs(recipe)
    for n, (got, want) in enumerate(zip(r["logs"], r["logs_jax"])):
        assert sorted(got) == sorted(want)
        tol = 1e-5 if n == 0 else 2e-4
        for k, v in want.items():
            assert abs(got[k] - v) <= tol * max(abs(v), 1e-12), \
                f"step {n + 1} {k}: {got[k]} vs {v}"
    keys = set(r["logs"][0])
    assert {"l_pix", "l_all", "l_dynamic", "dyn_w_0", f"dyn_l_{K - 1}"} <= keys
    if recipe != "flagship":
        assert {"l_mask", "l_ssim"} <= keys


def _before_instance_norm(key):
    """A depth block's conv biases: an InstanceNorm follows each, so the
    true gradient is zero."""
    return key.startswith("netG.depth-residual") and key.endswith(
        (".conv1.0.bias", ".conv2.0.bias"))


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_gradients_match_jax(runs, recipe):
    r = runs(recipe)
    got, want, noise = r["grads"], r["grads_jax"], r["noise"]
    assert sorted(got) == sorted(want)
    top = max(float(g.abs().max()) for g in want.values())
    for k, w in want.items():
        if _before_instance_norm(k):
            assert max(float(w.abs().max()), float(got[k].abs().max())) \
                <= 1e-7 * top, k
            continue
        err = float((got[k] - w).abs().max())
        tol = 2e-4 * float(w.abs().max()) + 4 * noise[k]
        assert err <= tol, f"{k}: max |Δ| {err:.3g} > {tol:.3g}"


def _param_errors(r, updates):
    """(max |Δ| of each tensor's well-determined components / lr, max
    |Δ| / lr, ‖Δ‖ / ‖movement‖ over every tensor) after ``updates``."""
    lr, wd = r["lr"], r["wd"]
    well_worst = worst = num = den = 0.0
    for k, want in r["params_jax"][updates].items():
        d = (r["params"][updates][k] - want).abs()
        worst = max(worst, float(d.max()) / lr)
        err_g = float((r["grads"][k] - r["grads_jax"][k]).abs().max())
        g_eff = r["grads_jax"][k] + wd * r["start"][k]      # Adam's input
        well = g_eff.abs() > 10 * err_g
        if well.any():
            well_worst = max(well_worst, float(d[well].max()) / lr)
        num += float(d.square().sum())
        den += float((want - r["start"][k]).square().sum())
    return well_worst, worst, (num / den) ** 0.5


@pytest.mark.parametrize("updates", [1, STEPS])
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_parameters_match_jax(runs, recipe, updates):
    well_worst, worst, rel = _param_errors(runs(recipe), updates)
    assert worst <= 2 * updates          # Adam's bound: ≤ lr an update
    if updates == 1:
        assert well_worst <= 1e-2, well_worst
        assert rel <= 1e-2, rel
    else:
        assert rel <= 5e-2, rel


def test_serve_then_train_then_serve_in_one_process():
    """Constants a serving call makes first (under inference mode) are
    saved for backward by a training step after it, and the model serves
    again with the updated weights."""
    from endosr_torch.utils.device import device_constant

    device_constant.cache_clear()
    tm = FModelDepthCond(_opt(FLAGSHIP), device="cpu")
    serve = _train_batch(False, seed=12)
    serve = {k: serve[k] for k in ("LQ", "Depth", "DepthMaskList")}
    tm.feed_data(serve)
    first = tm.test()
    assert first.is_inference()              # serving ran in inference mode
    first = first.clone()
    tm.feed_data(_train_batch(False))
    logs = tm.optimize_parameters()
    assert np.isfinite(logs["l_all"])
    tm.feed_data(serve)
    second = tm.test()
    assert second.shape == first.shape == (B, LR * SCALE, LR * SCALE, 3)
    assert bool(torch.isfinite(second).all())
    assert float((second - first).abs().max()) > 0
    tm.feed_data(_train_batch(False))
    tm.optimize_parameters()
    assert tm.step == 2


@pytest.mark.parametrize("what", ["depth_loss", "vgg_loss"])
def test_losses_without_weights_refuse_by_name(what, tmp_path):
    """The YAML's depth / VGG loss turned on with its weights missing: the
    model refuses, naming the files (with the JAX package's message,
    ``tests/test_torch_perceptual.py``)."""
    train = copy.deepcopy(FLAGSHIP)
    name = what.split("_")[0]
    missing = str(tmp_path / "absent")
    train[what].update({f"use_{name}_criterion": True},
                       **({"pretrained_model_path": missing}
                          if name == "depth" else
                          {"vgg_weights_path": missing + ".pth"}))
    match = ("monodepth2 checkpoints not found" if name == "depth"
             else "VGG weights not found")
    with pytest.raises(FileNotFoundError, match=match):
        FModelDepthCond(_opt(train), device="cpu")


def _ckpt_opt(tmp_path, **path):
    opt = _opt(FLAGSHIP)
    opt["path"] = {"models": str(tmp_path / "models"),
                   "training_state": str(tmp_path / "training_state"), **path}
    return opt


def _state_equal(a, b):
    """Two nested checkpoint structures hold equal values (tensors bit for
    bit)."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_state_equal, a, b))
    return a == b


@pytest.mark.parametrize("call", ["save", "save_network",
                                  "save_training_state", "resume_training"])
def test_checkpoints_round_trip(call, tmp_path):
    """Each checkpoint call writes a file that reads back into an equal
    model: the weights (``{iter}_G.pth``, under the reference keys), the
    trainer state (``{iter}.state``: epoch, iteration, updates, Adam, the
    weights, the dynamic loss's K-vector), and a resumed model whose next
    update equals the uninterrupted one's bit for bit."""
    tm = FModelDepthCond(_ckpt_opt(tmp_path), device="cpu")
    tm.feed_data(_train_batch(False))
    tm.optimize_parameters()
    sd = {k: v.detach().clone() for k, v in tm.netG.state_dict().items()}
    if call == "save":
        path = tm.save(7)
        assert path == str(tmp_path / "models" / "7_G.pth")
        again = FModelDepthCond(_ckpt_opt(tmp_path, pretrain_model_G=path),
                                device="cpu")
        assert _state_equal(again.netG.state_dict(), sd)
    elif call == "save_network":
        path = tm.save_network(tm.netG, "G", "latest")
        assert path.endswith("latest_G.pth") and not list(
            (tmp_path / "models").glob("*.tmp"))
        assert _state_equal(torch.load(path, weights_only=True), sd)
    elif call == "save_training_state":
        path = tm.save_training_state(3, 9)
        assert path == str(tmp_path / "training_state" / "9.state")
        st = torch.load(path, weights_only=True)
        assert (st["epoch"], st["iter"], st["step"]) == (3, 9, 1)
        assert _state_equal(st["netG"], sd)
        assert _state_equal(st["optimizer"], tm.optimizer_G.state_dict())
        assert torch.equal(st["dyn_weight"], tm.dyn_weight.detach())
    else:
        path = tm.save_training_state(0, 1)
        resumed = FModelDepthCond(_ckpt_opt(tmp_path), device="cpu")
        assert resumed.resume_training(path) == (0, 1)
        assert resumed.step == 1 and _state_equal(resumed.netG.state_dict(), sd)
        assert _state_equal(resumed.optimizer_G.state_dict(),
                            tm.optimizer_G.state_dict())
        resumed.feed_data(_train_batch(False))
        # one thread: with several, the CPU backward's sums vary by run
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            tm.optimize_parameters()
            logs = resumed.optimize_parameters()
        finally:
            torch.set_num_threads(threads)
        assert logs == tm.log_dict
        for (k, a), (_, b) in zip(tm.named_train_parameters(),
                                  resumed.named_train_parameters()):
            assert torch.equal(a, b), k
        assert _state_equal(resumed.optimizer_G.state_dict(),
                            tm.optimizer_G.state_dict())


def test_remat_blocks_and_serving_models_refuse_training():
    """A serving model refuses a training step (``remat_blocks`` trains:
    ``tests/test_torch_train_scales.py``)."""
    serving = {**_opt(FLAGSHIP), "is_train": False}
    tm = FModelDepthCond(serving, device="cpu")
    tm.feed_data(_train_batch(False))
    with pytest.raises(RuntimeError, match="is_train"):
        tm.optimize_parameters()


def test_lazy_o_chunk_trains_like_the_default_fields():
    """``lazy_o_chunk``'s first training step's logs equal the default
    fields' on the same weights (≤ 1e-5 relative; the same function, the
    first conv split by groups of blocks)."""
    opt = _opt(FLAGSHIP)
    opt["network_G"]["net_kw"] = {"lazy_o_chunk": 2}
    chunked = FModelDepthCond(opt, device="cpu")
    ref = FModelDepthCond(_opt(FLAGSHIP), device="cpu")
    chunked.netG.load_state_dict(ref.netG.state_dict(), strict=True)
    logs = []
    for m in (ref, chunked):
        m.feed_data(_train_batch(True))
        logs.append(dict(m.optimize_parameters()))
    for k, v in logs[0].items():
        assert abs(logs[1][k] - v) <= 1e-5 * max(abs(v), 1e-12), k


def test_learning_rate_queries_follow_the_updates():
    train = _variant("l1", "smoothl1", "smoothl1")
    tm = FModelDepthCond(_opt(train), device="cpu")
    assert tm.get_current_learning_rate() == tm.schedule(0)
    assert tm.schedule(0) == float(np.float32(1e-3))       # fp32, as JAX
    assert tm.update_learning_rate(1) == tm.schedule(1)
    tm.feed_data(_train_batch(True))
    tm.optimize_parameters()
    assert tm.optimizer_G.param_groups[0]["lr"] == tm.schedule(0)
    tm.optimize_parameters()
    assert tm.optimizer_G.param_groups[0]["lr"] == tm.schedule(1)
    assert tm.get_current_learning_rate() == tm.schedule(2)
    assert tm.get_current_log() is tm.log_dict


def test_from_flax_train_names_every_trainable_parameter():
    tm = FModelDepthCond(_opt(FLAGSHIP), device="cpu")
    names = [k for k, _ in tm.named_train_parameters()]
    assert names[-1] == "dyn.trainable_weight" and len(set(names)) == len(names)
    tree = {"netG": {"head_0": {"bias": np.zeros(64, np.float32)}},
            "dyn": {"trainable_weight": np.ones(K, np.float32)}}
    got = from_flax_train(tree)
    assert sorted(got) == ["dyn.trainable_weight", "netG.head.0.bias"]
    assert torch.equal(got["netG.head.0.bias"],
                       from_flax(tree["netG"])["head.0.bias"])


def test_flagship_recipe_is_the_yaml_train_block():
    """The options the chip script and the profiler train with are the
    flagship YAML's ``train:`` block and ``network_G``."""
    y = yaml.safe_load(X8_YAML.read_text())
    opt = x8_train_opt("fp32", preset="plain")
    assert opt["train"] == y["train"]
    assert opt["network_G"] == {**y["network_G"], "preset": "plain"}
    assert opt["scale"] == y["scale"] == 8
    assert opt["precision"] == "fp32" and opt["is_train"]
    assert opt["datasets"]["train"]["depthMaskNum"] == 10
    assert not opt["train"]["depth_loss"]["use_depth_criterion"]
    assert not opt["train"]["vgg_loss"]["use_vgg_criterion"]
    assert x8_train_opt()["network_G"] == y["network_G"]   # a fresh copy
