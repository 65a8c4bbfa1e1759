"""Helpers shared by the depth trainer's parity tests (``test_torch_depth_*``,
``test_torch_pose.py``): seeded flax variables without running flax's
eager init, a fast JAX ``Trainer``, JAX's tie-break noise for the port's
loss, seeded batches and synthetic frame folders.

The JAX trainer builds its networks with eager ``init`` / ``apply`` calls,
which take ~40 s on the CPU at 64×96. :func:`fast_flax_init` replaces them,
for the trainer's construction only, by ``jax.eval_shape`` and seeded
numpy leaves: the variables keep the trainer's structure and shapes, with
other numbers (the tests carry them to the port anyway).
"""

from __future__ import annotations

import contextlib
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

# the parity feed: ResNet-18's layer4 is 2×3 (at 32×32 it is 1×1 and its
# BatchNorm normalises over B values); the decoder's skips need sides
# that are multiples of 32
H, W, B = 64, 96, 2
ENDOVIS_K = np.array([[0.82, 0, 0.5, 0], [0, 1.02, 0.5, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


def _draw(rng, path, leaf):
    """A seeded value for one flax leaf, by its name."""
    name = getattr(path[-1], "key", str(path[-1]))
    shape = tuple(leaf.shape)
    if name == "kernel":
        bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
        a = rng.uniform(-bound, bound, shape)
    elif name == "scale":
        a = rng.uniform(0.8, 1.2, shape)
    elif name == "var":
        a = rng.uniform(0.5, 1.5, shape)
    else:                                  # bias, mean
        a = rng.uniform(-0.1, 0.1, shape)
    return a.astype(np.float32)


def seeded_variables(shapes, seed):
    """A tree of ``ShapeDtypeStruct`` → seeded numpy leaves."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(rng, p, leaf), shapes)


@contextlib.contextmanager
def fast_flax_init(seed):
    """Inside: flax ``Module.init`` gives :func:`seeded_variables` of the
    variables' shapes and ``Module.apply`` gives shapes only."""
    init, apply = nn.Module.init, nn.Module.apply
    rng = np.random.default_rng(seed)

    def fast_init(self, key, *a, **kw):
        shapes = jax.eval_shape(lambda k, *x: init(self, k, *x, **kw), key, *a)
        return jax.tree_util.tree_map_with_path(
            lambda p, leaf: _draw(rng, p, leaf), shapes)

    def shape_apply(self, v, *a, **kw):
        return jax.eval_shape(lambda v, *x: apply(self, v, *x, **kw), v, *a)

    nn.Module.init, nn.Module.apply = fast_init, shape_apply
    try:
        yield
    finally:
        nn.Module.init, nn.Module.apply = init, apply


def jax_trainer(opts, seed=0, **kw):
    """The JAX depth ``Trainer`` on ``opts``, its variables seeded
    (:func:`fast_flax_init`) and as numpy."""
    from endosr.depth.trainer import Trainer

    with fast_flax_init(seed):
        tr = Trainer(opts, **kw)
    tr.variables = jax.tree_util.tree_map(np.asarray, tr.variables)
    return tr


def jax_noise(step):
    """The port's noise source for ``step`` from JAX's draws: the JAX
    trainer's ``PRNGKey(step)``, split once a scale, normal draws of the
    NHWC shape, given NCHW."""
    key = jax.random.PRNGKey(step)

    def draw(shape):
        nonlocal key
        key, sub = jax.random.split(key)
        b, c, h, w = shape
        a = np.asarray(jax.random.normal(sub, (b, h, w, c)))
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())

    return draw


def make_batch(seed, frame_ids=(0, -1, 1), scales=4, h=H, w=W, b=B,
               stereo=False):
    """A seeded NHWC numpy batch with the keys the loss reads: smooth
    random frames in [0.05, 0.9] at each scale (a panned base image, so
    the warps have structure), brightened copies at scale 0, the endovis
    K / inv_K per scale and, with ``stereo``, a ``stereo_T`` per image."""
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.random((h // 4, w // 4 + 8, 3)).astype(np.float32),
                      (w + 32, h), interpolation=cv2.INTER_CUBIC)
    base = 0.05 + 0.85 * (base - base.min()) / (base.max() - base.min())
    out = {}
    for n, f in enumerate(frame_ids):
        shift = {"s": 5}.get(f, f if isinstance(f, int) else 0) * 2 + 8
        frames = np.stack([base[:, shift + i:shift + i + w]
                           for i in range(b)]).astype(np.float32)
        for s in range(scales):
            out[("color", f, s)] = np.stack([
                cv2.resize(x, (w >> s, h >> s), interpolation=cv2.INTER_AREA)
                for x in frames]).astype(np.float32)
        out[("color_aug", f, 0)] = (frames * rng.uniform(0.9, 1.05)
                                    + 0.02 * n).astype(np.float32)
    for s in range(scales):
        k = ENDOVIS_K.copy()
        k[0] *= w >> s
        k[1] *= h >> s
        out[("K", s)] = np.stack([k] * b)
        out[("inv_K", s)] = np.stack([np.linalg.inv(k).astype(np.float32)] * b)
    if stereo:
        t = np.stack([np.eye(4, dtype=np.float32)] * b)
        t[:, 0, 3] = [0.1, -0.1][:b] + [0.1] * max(0, b - 2)
        out["stereo_T"] = t
    return out


def to_port(batch, device="cpu"):
    """A NHWC numpy batch → the port's device batch (images NCHW)."""
    from endosr_torch.depth.trainer import _image_key

    return {k: (torch.from_numpy(v).permute(0, 3, 1, 2).contiguous()
                if _image_key(k) else torch.from_numpy(v)).to(device)
            for k, v in batch.items()}


def to_jax(batch):
    from endosr.depth.trainer import encode_inputs

    return encode_inputs({k: jnp.asarray(v) for k, v in batch.items()})


def write_sequence(root, n=8, h=80, w=120, seed=0, names="{:010d}.jpg"):
    """``n`` frames of a panned random image under ``root``."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    for i in range(n):
        cv2.imwrite(os.path.join(root, names.format(i)),
                    np.roll(base, i * 2, axis=1))


def nrel(got, want):
    """max |Δ| / max |want| of two arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ the loss

def loss_opt(**kw):
    """The JAX / port loss options of the endovis defaults at the parity
    feed, ``kw`` changed."""
    opt = {"frame_ids": (0, -1, 1), "scales": (0, 1, 2, 3), "height": H,
           "width": W, "min_depth": 0.1, "max_depth": 100.0,
           "disparity_smoothness": 1e-3, "v1_multiscale": False,
           "avg_reprojection": False, "disable_automasking": False,
           "no_ssim": False, "pose_model_type": "separate_resnet"}
    opt.update(kw)
    return opt


def _shapes(module, *args, **kw):
    return jax.eval_shape(lambda k, *a: module.init(k, *a, **kw),
                          jax.random.PRNGKey(0), *args)


def loss_nets():
    """The JAX networks of every loss config with seeded variables."""
    from endosr.nn.monodepth import (DepthDecoder, PoseCNN, PoseDecoder,
                                     ResnetEncoder)

    enc = ResnetEncoder(num_layers=18)
    x3 = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    x6 = jax.ShapeDtypeStruct((1, H, W, 6), jnp.float32)
    pose_enc = ResnetEncoder(num_layers=18, num_input_images=2)
    feats = [jax.ShapeDtypeStruct((1, H >> s, W >> s, c), jnp.float32)
             for s, c in zip(range(1, 6), enc.num_ch_enc)]
    dec = DepthDecoder(num_ch_enc=tuple(enc.num_ch_enc), scales=(0, 1, 2, 3))
    dec02 = DepthDecoder(num_ch_enc=tuple(enc.num_ch_enc), scales=(0, 2))
    pose = PoseDecoder(num_ch_enc=tuple(pose_enc.num_ch_enc),
                       num_input_features=1, num_frames_to_predict_for=2)
    cnn = PoseCNN(num_input_frames=2)
    v = {"encoder": seeded_variables(_shapes(enc, x3, train=True), 1),
         "depth": seeded_variables(_shapes(dec, feats), 2),
         "pose_encoder": seeded_variables(_shapes(pose_enc, x6, train=True), 3),
         "pose": seeded_variables(_shapes(pose, [feats]), 4),
         "posecnn": seeded_variables(_shapes(cnn, x6), 5)}
    v["depth02"] = {"params": {k: a for k, a in v["depth"]["params"].items()
                               if not k.startswith("dispconv_")
                               or k[-1] in "02"}}
    return {"enc": enc, "dec": dec, "dec02": dec02, "pose_enc": pose_enc,
            "pose": pose, "cnn": cnn, "vars": v}


def select_nets(nets, opt, train=True):
    """(JAX nets tuple, JAX variables, port models in ``train`` mode with
    the variables carried across) for the loss options ``opt``."""
    from endosr_torch.nn import monodepth as t_md
    from endosr_torch.utils.port_params import from_flax_depth_trainer

    v = nets["vars"]
    dec, dkey = ((nets["dec02"], "depth02") if tuple(opt["scales"]) == (0, 2)
                 else (nets["dec"], "depth"))
    jv = {"encoder": v["encoder"], "depth": v[dkey]}
    models = {"encoder": t_md.ResnetEncoder(18),
              "depth": t_md.DepthDecoder(scales=opt["scales"])}
    pose_enc = pose = None
    if tuple(opt["frame_ids"]) == (0, "s"):
        pass
    elif opt["pose_model_type"] == "posecnn":
        pose, jv["pose"] = nets["cnn"], v["posecnn"]
        models["pose"] = t_md.PoseCNN(2)
    else:
        pose_enc, pose = nets["pose_enc"], nets["pose"]
        jv["pose_encoder"], jv["pose"] = v["pose_encoder"], v["pose"]
        models["pose_encoder"] = t_md.ResnetEncoder(18, num_input_images=2)
        models["pose"] = t_md.PoseDecoder(num_input_features=1,
                                          num_frames_to_predict_for=2)
    for name, sd in from_flax_depth_trainer(jv).items():
        models[name].load_state_dict(sd)
        t_md.freeze_running_stats(models[name]).train(train)
    return (nets["enc"], dec, pose_enc, pose), jv, models


def jax_loss_fn(jnets, jv, opt, step, train=True):
    """JAX's loss of ``(params, inputs)`` as its trainer's step computes
    it (the batch statistics held as the trainer holds them) → (total,
    losses)."""
    from endosr.depth.trainer import monodepth_loss

    stats = {k: a.get("batch_stats", {}) for k, a in jv.items()}

    def loss(params, inputs):
        variables = {k: ({"params": params[k], "batch_stats": stats[k]}
                         if stats[k] else {"params": params[k]})
                     for k in params}
        total, (losses, _) = monodepth_loss(
            variables, jnets, inputs, opt, jax.random.PRNGKey(step),
            train=train)
        return total, losses

    return loss


def nudged(tree, seed):
    """Every leaf one fp32 ulp up or down (a seeded sign each)."""
    rng = np.random.default_rng(seed)

    def nudge(p):
        p = np.asarray(p, np.float32)
        up = rng.random(p.shape) < 0.5
        return np.where(up, np.nextafter(p, np.float32(np.inf)),
                        np.nextafter(p, np.float32(-np.inf)))

    return jax.tree_util.tree_map(nudge, tree)


def nudged_batches(batch):
    """The batch with every image one ulp up, then one ulp down."""
    def move(to):
        return {k: (np.nextafter(v, np.float32(to)) if isinstance(k, tuple)
                    and k[0].startswith("color") else v)
                for k, v in batch.items()}

    return [move(2.0), move(-1.0)]


LOSS_REL = 1e-5      # a loss, relative
GRAD_REL = 2e-4      # a gradient, of its tensor's max |ref|
GRAD_NOISE = 4       # × the largest one-ulp move of either package's own
LOSS_STEP = 3        # the step whose noise the loss tests draw


def check_losses(got, want):
    """Each of JAX's losses ``want`` within ``LOSS_REL`` in ``got``."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].item()
        assert abs(g - float(w)) <= LOSS_REL * abs(float(w)), \
            f"{k}: {g} vs {float(w)}"


def _grads_by_network(tree):
    from endosr_torch.utils.port_params import from_flax_depth_trainer

    return from_flax_depth_trainer({k: {"params": g} for k, g in tree.items()})


def _port_grads(nets, jv, opt, batch):
    """The port's gradients ({network: {name: array}}) on the variables
    ``jv`` and the numpy batch."""
    from endosr_torch.depth.trainer import monodepth_loss

    _, _, models = select_nets({**nets, "vars": {**nets["vars"], **jv}}, opt)
    total, _, _ = monodepth_loss(models, to_port(batch), opt,
                                 jax_noise(LOSS_STEP))
    total.backward()
    return {n: {k: p.grad.numpy().copy() for k, p in m.named_parameters()}
            for n, m in models.items()}


def check_loss_and_gradients(nets, frame_ids, seed):
    """The port's loss and gradients against JAX's for ``frame_ids`` on
    the batch of ``seed`` (``tests/test_torch_depth_loss.py`` states the
    bars)."""
    from endosr_torch.depth.trainer import monodepth_loss

    opt = loss_opt(frame_ids=frame_ids)
    batch = make_batch(seed, frame_ids=frame_ids, stereo="s" in frame_ids)
    jnets, jv, models = select_nets(nets, opt)
    params = {k: a["params"] for k, a in jv.items()}
    grad_fn = jax.jit(jax.value_and_grad(
        jax_loss_fn(jnets, jv, opt, LOSS_STEP), has_aux=True))
    (_, want), jgrads = grad_fn(params, to_jax(batch))

    total, losses, outputs = monodepth_loss(models, to_port(batch), opt,
                                            jax_noise(LOSS_STEP))
    check_losses(losses, want)
    assert outputs[("color", frame_ids[-1], 0)].shape == (B, 3, H, W)
    total.backward()
    want_g = _grads_by_network(jgrads)
    got = {n: {k: p.grad.numpy() for k, p in m.named_parameters()}
           for n, m in models.items()}
    errs = {(n, k): nrel(g, want_g[n][k].numpy())
            for n, gs in got.items() for k, g in gs.items()}
    assert max(errs.values()) > 0.0
    over = sorted(k for k, e in errs.items() if e > GRAD_REL)
    if not over:
        return
    # the nudge rule: how far rounding alone moves either package's own
    # gradient under the same four one-ulp nudges
    cases = [*((params, b) for b in nudged_batches(batch)),
             (nudged(params, 7), batch), (nudged(params, 8), batch)]
    jax_moved = [_grads_by_network(grad_fn(p, to_jax(b))[1]) for p, b in cases]
    port_moved = [_port_grads(nets, {k: dict(jv[k], params=p[k]) for k in jv},
                              opt, b) for p, b in cases]
    fails, rows = [], []
    for n, k in over:
        w = want_g[n][k].numpy()
        moved = max(max(nrel(g[n][k].numpy(), w) for g in jax_moved),
                    max(nrel(g[n][k], got[n][k]) for g in port_moved))
        tol = GRAD_NOISE * moved + GRAD_REL
        rows.append((errs[n, k] / tol, errs[n, k], moved, f"{n}.{k}"))
        if not errs[n, k] <= tol:
            fails.append(f"{n}.{k}: {errs[n, k]:.3g} > {tol:.3g}")
    rows.sort(reverse=True)
    print(f"{len(over)} of {len(errs)} tensors over {GRAD_REL:g}; the "
          f"largest one-ulp move {max(r[2] for r in rows):.3g}; nearest "
          "the bound: " + ", ".join(f"{k} {e:.3g} (move {m:.3g}, {q:.2f} "
                                    "of tol)" for q, e, m, k in rows[:3]))
    assert not fails, fails
