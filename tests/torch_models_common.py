"""Helpers shared by the parity tests of the one-network trainers and the
co-training model (``test_torch_simple_models.py``,
``test_torch_depthseg.py``): the options of a small training model, the
JAX train step's own loss function, and the yardsticks for gradients and
for parameters after Adam updates."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import torch
from flax import linen as nn

from endosr.config.options import dict_to_nonedict
from endosr.parallel.mesh import make_mesh, replicate


def train_block(**over):
    t = {"lr_G": 1e-4, "lr_scheme": "MultiStepLR", "lr_steps": [100],
         "lr_gamma": 0.5, "beta1": 0.9, "beta2": 0.99, "niter": 4,
         "warmup_iter": -1, "pixel_criterion": "l1", "pixel_weight": 1.0,
         "manual_seed": 0, "val_freq": 100}
    t.update(over)
    return t


def model_opt(model, network_g, train_over=None, scale=4, **top):
    """A small training model's options (the JAX package's own model
    tests' layout, ``tests/test_models.py``)."""
    opt = {"is_train": True, "model": model, "scale": scale,
           "datasets": {"train": {"phase": "train", "LR_size": 8,
                                  "GT_size": 8 * scale, "batch_size": 2,
                                  "depthMaskNum": 4}},
           "network_G": network_g, "path": {},
           "train": train_block(**(train_over or {})),
           "logger": {"print_freq": 1, "save_checkpoint_freq": 100}}
    opt.update(top)
    return dict_to_nonedict(opt)


def jax_loss_fn(jm, name="loss_fn"):
    """The JAX train step's own loss function (from its closure)."""
    step = jm._train_step.__wrapped__
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    return cells[name]


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def grad_rel(got, want):
    """max |Δ| / max |want| of one gradient tensor."""
    w = torch.as_tensor(want)
    return float((got - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def check_updates(got, want, start, lr, n, grads, grads_jax, label="",
                  frac3=5e-2, wd=0.0):
    """Parameters after ``n`` Adam updates from ``start``, against JAX's.
    Adam's first steps are ≈ ±lr for any gradient, so a component whose two
    gradients (``grads``, ``grads_jax``: the first step's) agree to their
    rounding but straddle zero — a sum of terms that cancel, a bias before
    an InstanceNorm — moves the other way. So: every component within 2·lr
    an update of JAX's; the components whose JAX gradient exceeds 10× the
    tensor's gradient error (its largest |Δ|) — with weight decay ``wd``,
    whose optimiser input g + wd·p does — within 1e-2·lr after one update, and within 1 % (one update) or 5 % (three) of the distance
    JAX's moved them, in norm (three updates: ``frac3``)."""
    frac = 1e-2 if n == 1 else frac3
    for k, w in want.items():
        g, s = got[k], start[k]
        assert g.shape == w.shape, k
        assert float((g - w).abs().max()) <= 2 * lr * n * (1 + 1e-3), \
            f"{label} {k}: {float((g - w).abs().max())}"
        gj = torch.as_tensor(grads_jax[k])
        err = float((grads[k] - gj).abs().max())
        strong = (gj + wd * s).abs() > 10 * err
        if not bool(strong.any()):
            continue
        d = (g - w)[strong]
        if n == 1:
            assert float(d.abs().max()) <= 1e-2 * lr, \
                f"{label} {k}: {float(d.abs().max())}"
        moved = float((w - s)[strong].norm())
        assert float(d.norm()) <= frac * moved, \
            f"{label} {k}: {float(d.norm())} vs moved {moved}"



_TRANSPOSED = ("deconv", "layer4", "mlp_depthMatrix")


def seeded_leaves(shapes, seed):
    """Seeded numpy values on a flax ``eval_shape`` tree, drawn as the JAX
    modules' own inits draw them: a kernel (``kernel``, ``v``, a SEAN
    ``A_i_j_kernel`` or ``mlp_*`` stack) and its node's biases
    U(±1/√fan_in) (torch's convention: a transposed conv's fan-in is
    out·kh·kw); a weight-norm gain ``g`` = ‖v‖; SEAN's ``alpha_*``
    U[0, 1); BatchNorm scale 1, bias 0, mean 0, variance 1."""
    rng = np.random.default_rng(seed)

    def fan_in(name, shape):
        if name.startswith(_TRANSPOSED):
            return shape[-1] * shape[0] * shape[1]
        return int(np.prod(shape[:-1]))

    def node(tree, name):
        out, bound = {}, None
        kernels = [k for k, v in tree.items() if not isinstance(v, dict)
                   and len(v.shape) >= 2]
        for k in kernels:
            shape = tree[k].shape
            b = 1.0 / np.sqrt(fan_in(name, shape))
            bound = bound or b
            out[k] = rng.uniform(-b, b, shape).astype(np.float32)
        bn = "scale" in tree or "mean" in tree
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = node(v, k)
            elif k in out:
                continue
            elif k == "g":
                out[k] = np.sqrt((out["v"].astype(np.float64) ** 2).reshape(
                    -1, v.shape[0]).sum(0)).astype(np.float32)
            elif k.startswith("alpha"):
                out[k] = rng.uniform(0, 1, v.shape).astype(np.float32)
            elif bn:
                fill = 1.0 if k in ("scale", "var") else 0.0
                out[k] = np.full(v.shape, fill, np.float32)
            else:
                b = bound if bound is not None else 0.1
                out[k] = rng.uniform(-b, b, v.shape).astype(np.float32)
        return out

    return node(dict(shapes), "")


@contextlib.contextmanager
def quick_flax_init(seed=0):
    """Inside: flax ``Module.init`` gives :func:`seeded_leaves` of the
    variables' shapes (``jax.eval_shape``) instead of running the
    network's init eagerly (tens of seconds for a DepthNet on the CPU).
    The tests carry whatever the JAX model starts from to the port."""
    init = nn.Module.init

    def fast_init(self, key, *a, **kw):
        shapes = jax.eval_shape(lambda k, *x: init(self, k, *x, **kw), key,
                                *a)
        return seeded_leaves(dict(shapes), seed)

    nn.Module.init = fast_init
    try:
        yield
    finally:
        nn.Module.init = init


def jax_model(create, opt, seed=0):
    """The JAX training model ``create(opt)`` on one CPU device, built by
    :func:`quick_flax_init`, its step counter replicated over the mesh as
    the train step returns it (a counter on one device would make the
    second step compile again)."""
    mesh = make_mesh(jax.devices()[:1])
    with quick_flax_init(seed):
        jm = create(opt, mesh=mesh)
    jm.state = jm.state.replace(step=replicate(jm.state.step, mesh))
    return jm
