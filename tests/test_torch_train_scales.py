"""The port's training step at ×2, ×3 and ×4, with and without
``remat_blocks``, against the JAX package's, on the CPU in fp32.

Each scale takes its shipped YAML's ``train:`` block (×2 and ×4 Kvasir,
whose ``network_G`` sets ``remat_blocks``, and ×3 EndoScene, which does
not) on the smoke network (nb 4, K 4, latent 16, LR 16, batch 2): every
block a depth block at ×2 / ×3, the trunk's at ×4, as the YAMLs have
them, and at ×3 also ``tests/test_torch_train.py``'s network (block 0
the only depth block, ``x3_block0``). One JAX model a case, with the
YAML's ``remat_blocks``; its
gradient comes from the train step's own ``loss_fn`` (read from its
closure, jitted once), its first update from the model's own optimizer.
Both port variants (checkpointed per-block branches, and the hoisted lazy
branches) start from its weights (``from_flax_train``) on the same batch
(``tests/test_torch_train.py``'s seed):

- the first step's logs to ≤ 1e-5 relative;
- at ×2 and ×4 every gradient as ``tests/test_torch_train.py`` holds it
  (2e-4 of its largest magnitude plus four times the port's own change
  with oneDNN off); the conv biases before an InstanceNorm, whose true
  gradient is zero, ≤ ``ZERO_GRAD`` of the largest gradient on both
  sides (here, unlike at ×8, JAX itself holds up to 9.9e-7 there);
- at ×3 ReLU and max inputs of this batch sit close to their kinks: a
  one-ulp nudge moves JAX's own gradient of a tensor by up to 1.3e-2
  norm-relative, and with block 0 the only depth block a probe of the
  network's VJP found the two packages on two one-sided slopes (4.1e-3
  apart; ``ROADMAP.md`` Queue C). Each tensor is held as
  ``chip_smoke.py`` phase 6b holds the card: its
  norm-relative distance from JAX's within ``GRAD_NOISE`` × the largest
  change of JAX's own gradient under one-ulp nudges (LQ up, LQ down,
  every weight up or down at random, twice) + ``GRAD_FLOOR``;
- the parameters after one update as ``tests/test_torch_train.py``
  states (every component within 2·lr; the components whose gradient
  exceeds 10× its error within 1e-2·lr; all of them within 1 % of their
  move in norm). At ×3 a gradient's error is also the largest change a
  nudge makes in JAX's (Adam's update of a gradient near its ε of 1e-8
  follows each rounding), and the distance in norm may add
  ``GRAD_NOISE`` × the largest nudge's change.

Also: a ``remat_blocks`` step equals, bit for bit on one thread, the same
step with the checkpoints taken out (each depth block computing its own
branches, nothing recomputed), and both call the same kernel wrappers as
often (nothing the checkpoint reruns launches a kernel); under
``remat_blocks`` the branches run at the net's ``dtype``, not at
``modulation_dtype``, as in JAX.
"""

import copy

import jax
import numpy as np
import optax
import pytest
import torch

from endosr.models.f_depthcond import FModelDepthCond as JaxModel
from endosr.parallel.mesh import make_mesh
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.models.recipes import TRAIN_YAMLS, train_opt
from endosr_torch.nn import depthnet as torch_dn
from endosr_torch.utils.port_params import from_flax_train
from tests.test_torch_hoisted import _count_calls
from tests.test_torch_train import (_before_instance_norm, _jax_loss_fn,
                                    _tree_np)

K, LR, B = 4, 16, 2
YAMLS = {2: TRAIN_YAMLS[("kvasir", 2)], 3: TRAIN_YAMLS[("endoscene", 3)],
         4: TRAIN_YAMLS[("kvasir", 4)]}
# case: (scale, which_ResBlk_depth)
CASES = {"x2": (2, [0, 1, 2, 3]), "x3": (3, [0, 1, 2, 3]),
         "x3_block0": (3, [0]), "x4": (4, [0, 1])}
NET = {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3, "nf": 64,
       "nb": 4, "depth_latent_ch": 16, "use_trainable_params": True}
GRAD_NOISE = 4         # × JAX's own change under a one-ulp nudge
GRAD_FLOOR = 2e-4      # the repo's parity bar, norm-relative
SEED = 11              # tests/test_torch_train.py's batch
# a conv bias right before an InstanceNorm has a zero gradient; what both
# packages hold there is the rounding of a sum over every pixel, up to
# 9.9e-7 of the largest gradient in JAX at ×2 (1e-9 at ×8)
ZERO_GRAD = 1e-5
# the output stage each scale's tail ends in (no other kernel is called
# under remat_blocks); the hoisted lazy trunk adds its style group
TAIL = {2: "output_stage", 3: "output_stage", 4: "output_stage_x8"}


def _opt(case, remat):
    scale, depth = CASES[case]
    recipe = train_opt(YAMLS[scale])
    net = {**NET, "which_ResBlk_depth": depth, "remat_blocks": remat}
    return {"is_train": True, "model": "sftmd_depthCond", "scale": scale,
            "precision": None,
            "datasets": {"train": {"depthMaskNum": K, "LR_size": LR}},
            "network_G": net, "path": {}, "train": recipe["train"]}


def _batch(scale):
    rng = np.random.default_rng(SEED)
    return {"GT": rng.random((B, LR * scale, LR * scale, 3), dtype=np.float32),
            "LQ": rng.random((B, LR, LR, 3), dtype=np.float32),
            "Depth": rng.random((B, LR, LR, 1), dtype=np.float32),
            "DepthMaskList": (rng.random((B, LR, LR, K)) > 0.6).astype(
                np.float32)}


def _log_dict(logs):
    """JAX's aux logs as ``FModelDepthCond.log_dict`` names them."""
    out = {}
    for k, v in jax.device_get(logs).items():
        v = np.asarray(v)
        if k in ("dyn_w", "dyn_l"):
            out.update({f"{k}_{i}": float(x) for i, x in enumerate(v)})
        else:
            out[k] = float(v)
    return out


def _nudged(params, seed):
    """Every parameter one fp32 ulp up or down (a seeded sign each)."""
    rng = np.random.default_rng(seed)

    def nudge(p):
        p = np.asarray(p, np.float32)
        up = rng.random(p.shape) < 0.5
        return np.where(up, np.nextafter(p, np.float32(np.inf)),
                        np.nextafter(p, np.float32(-np.inf)))

    return jax.tree_util.tree_map(nudge, params)


def jax_nudges(grad_fn, params, batch):
    """JAX's gradients (``grad_fn``: the jitted ``grad`` of the train
    step's ``loss_fn``) under the four one-ulp nudges: LQ up, LQ down, and
    every weight up or down at random (seeds 7 and 8)."""
    lq = batch["LQ"]
    return [grad_fn(p, b)[0] for p, b in (
        (params, dict(batch, LQ=np.nextafter(lq, np.float32(2)))),
        (params, dict(batch, LQ=np.nextafter(lq, np.float32(-1)))),
        (_nudged(params, 7), batch), (_nudged(params, 8), batch))]


def _port_step(opt, start, batch, mkldnn=True):
    """One step of the port from ``start``: (logs, gradients, parameters
    after the update, kernel wrapper calls)."""
    tm = FModelDepthCond(copy.deepcopy(opt), device="cpu")
    with torch.no_grad():
        for name, p in tm.named_train_parameters():
            p.copy_(start[name])
    tm.feed_data(batch)
    with torch.backends.mkldnn.flags(enabled=mkldnn):
        logs = dict(tm.optimize_parameters())
    return (logs, {k: p.grad.clone() for k, p in tm.named_train_parameters()},
            {k: p.detach().clone() for k, p in tm.named_train_parameters()})


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: the suite runs several worker
    processes on the machine's cores, and this module's steps slow down
    many times over when every worker's threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """{case: the JAX step and both port variants'}, made once a case."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(case)
        return cache[case]

    return get


def _run(case):
    scale = CASES[case][0]
    opt = _opt(case, remat=scale != 3)           # the YAML's remat_blocks
    jm = JaxModel(copy.deepcopy(opt), mesh=make_mesh(jax.devices()[:1]))
    params = jm.state.params
    batch = _batch(scale)
    first_bin = np.random.default_rng(opt["train"]["manual_seed"]).integers(
        0, K)
    jb = dict(batch, mask_bin=np.int32(first_bin))
    grad_fn = jax.jit(jax.grad(_jax_loss_fn(jm), has_aux=True))
    grads, logs = grad_fn(params, jb)
    updates, _ = jm.tx.update(grads, jm.state.opt_state, params)
    out = {"logs_jax": _log_dict(logs),
           "grads_jax": from_flax_train(_tree_np(grads)),
           "params_jax": from_flax_train(_tree_np(
               optax.apply_updates(params, updates))),
           "start": from_flax_train(_tree_np(params)),
           "lr": float(opt["train"]["lr_G"])}
    if scale == 3:
        out["nudges"] = [
            (from_flax_train(_tree_np(g)), from_flax_train(_tree_np(
                optax.apply_updates(params, jm.tx.update(
                    g, jm.state.opt_state, params)[0]))))
            for g in jax_nudges(grad_fn, params, jb)]
    for remat in (True, False):
        out[remat] = _port_step(_opt(case, remat), out["start"], batch)
    # the rounding scale of each gradient: the port once more with
    # oneDNN's convolutions off (other summation orders)
    _, again, _ = _port_step(_opt(case, True), out["start"], batch, False)
    out["noise"] = {k: float((g - out[True][1][k]).abs().max())
                    for k, g in again.items()}
    return out


VARIANTS = [True, False]
VARIANT_IDS = ["remat", "hoisted"]


@pytest.mark.parametrize("remat", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("case", CASES)
def test_step_logs_match_jax(runs, case, remat):
    r = runs(case)
    got, want = r[remat][0], r["logs_jax"]
    assert sorted(got) == sorted(want)
    assert {"l_pix", "l_dynamic", "l_all", f"dyn_w_{K - 1}"} <= set(got)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1e-12), (k, got[k], v)


def _nrel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("remat", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("case", CASES)
def test_step_gradients_match_jax(runs, case, remat):
    r = runs(case)
    got, want = r[remat][1], r["grads_jax"]
    assert sorted(got) == sorted(want)
    top = max(float(g.abs().max()) for g in want.values())
    fails = []
    for k, w in want.items():
        if _before_instance_norm(k):
            worst = max(float(w.abs().max()), float(got[k].abs().max()))
            if not worst <= ZERO_GRAD * top:
                fails.append(f"{k}: |g| {worst:.3g}")
            continue
        if "nudges" in r:
            err = _nrel(got[k], w)
            tol = GRAD_NOISE * max(_nrel(g[k], w) for g, _ in r["nudges"])
            tol += GRAD_FLOOR
        else:
            err = float((got[k] - w).abs().max())
            tol = 2e-4 * float(w.abs().max()) + 4 * r["noise"][k]
        if not err <= tol:
            fails.append(f"{k}: {err:.3g} > {tol:.3g}")
    assert not fails, fails


@pytest.mark.parametrize("remat", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("case", CASES)
def test_parameters_after_one_update_match_jax(runs, case, remat):
    r = runs(case)
    lr, start = r["lr"], r["start"]
    logs, grads, params = r[remat]

    def apart(p):
        num = sum(float((p[k] - w).square().sum())
                  for k, w in r["params_jax"].items())
        den = sum(float((w - start[k]).square().sum())
                  for k, w in r["params_jax"].items())
        return (num / den) ** 0.5

    worst = well_worst = 0.0
    for k, want in r["params_jax"].items():
        d = (params[k] - want).abs()
        worst = max(worst, float(d.max()) / lr)
        err_g = float((grads[k] - r["grads_jax"][k]).abs().max())
        if "nudges" in r:   # a gradient is as well determined as JAX's is
            err_g = max(err_g, *(float((g[k] - r["grads_jax"][k]).abs().max())
                                 for g, _ in r["nudges"]))
        well = r["grads_jax"][k].abs() > 10 * err_g     # no weight decay
        if well.any():
            well_worst = max(well_worst, float(d[well].max()) / lr)
    assert worst <= 2                    # Adam's bound: ≤ lr an update
    assert well_worst <= 1e-2, well_worst
    tol = 1e-2
    if "nudges" in r:
        tol += GRAD_NOISE * max(apart(p) for _, p in r["nudges"])
    assert apart(params) <= tol, (apart(params), tol)


def _step_calls(opt, start, batch, monkeypatch, checkpointed=True):
    """One port step on one thread: (logs, gradients, updated parameters,
    the calls of each kernel wrapper)."""
    with monkeypatch.context() as mp:
        calls = _count_calls(mp)
        if not checkpointed:
            mp.setattr(torch_dn, "checkpoint",
                       lambda fn, *a, use_reentrant: fn(*a))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out = _port_step(opt, start, batch)
        finally:
            torch.set_num_threads(threads)
    return (*out, {k: v for k, v in calls.items() if v})


@pytest.mark.parametrize("case", CASES)
def test_remat_step_equals_the_step_without_checkpoints(runs, case,
                                                        monkeypatch):
    r = runs(case)
    scale = CASES[case][0]
    opt, batch = _opt(case, True), _batch(scale)
    ckpt = _step_calls(opt, r["start"], batch, monkeypatch)
    plain = _step_calls(opt, r["start"], batch, monkeypatch, False)
    assert ckpt[0] == plain[0]
    for k in ckpt[1]:
        assert torch.equal(ckpt[1][k], plain[1][k]), k
        assert torch.equal(ckpt[2][k], plain[2][k]), k
    assert ckpt[3] == plain[3] == {TAIL[scale]: 1}
    hoisted = _step_calls(_opt(case, False), r["start"], batch, monkeypatch)
    assert hoisted[3] == {TAIL[scale]: 1, "style_blend_dot": 1}


def test_remat_checkpoints_every_depth_block_under_autograd_only(
        monkeypatch):
    """Each depth block (trunk and tail) runs in one checkpoint while a
    gradient is recorded; serving (inference mode) and ``no_grad`` run it
    directly."""
    net = torch_dn.DepthNet(scale=2, nb=4, which_resblk_depth=(0, 2, 3),
                            depth_latent_ch=16, depth_range_num=K,
                            remat_blocks=True, device="cpu")
    net.init_(torch.Generator().manual_seed(0))
    seen = []
    orig = torch_dn.checkpoint

    def counted(fn, *a, **k):
        seen.append(a[0].shape)
        return orig(fn, *a, **k)

    monkeypatch.setattr(torch_dn, "checkpoint", counted)
    b = _batch(2)
    x = [torch.from_numpy(b[k]) for k in ("LQ", "Depth", "DepthMaskList")]
    out = net(*x)
    assert out.requires_grad and len(seen) == 3
    with torch.no_grad():
        net(*x)
    with torch.inference_mode():
        net(*x)
    assert len(seen) == 3


def test_remat_computes_the_branches_at_the_net_dtype():
    """Under ``remat_blocks`` every SEAN computes its branches at the net's
    ``dtype``, not at ``modulation_dtype`` (JAX: "remat_blocks computes
    branches per block at ``dtype``"): a ``mixed`` net (fp32, bf16
    modulations) with remat equals the JAX module's within 2e-4, and the
    fp32 net's output bit for bit; without remat its bf16 maps show."""
    import jax.numpy as jnp

    from endosr.nn.depthnet import DepthNet as JaxDepthNet
    from endosr_torch.utils.port_params import from_flax

    kw = dict(scale=2, nb=4, which_resblk_depth=(0, 2, 3),
              depth_latent_ch=16, depth_range_num=K)
    b = _batch(2)
    x = [b[k] for k in ("LQ", "Depth", "DepthMaskList")]
    jnet = JaxDepthNet(**kw, remat_blocks=True,
                       modulation_dtype=jnp.bfloat16)
    params = jnet.init(jax.random.PRNGKey(3), *x)["params"]
    want = np.asarray(jnet.apply({"params": params}, *x))
    sd = from_flax(_tree_np(params))
    out = {}
    for name, extra in (("remat_mixed", dict(remat_blocks=True,
                                              modulation_dtype=torch.bfloat16)),
                        ("remat_fp32", dict(remat_blocks=True)),
                        ("hoisted_mixed", dict(modulation_dtype=torch.bfloat16))):
        net = torch_dn.DepthNet(**kw, **extra, device="cpu")
        net.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out[name] = net(*map(torch.from_numpy, x))
    assert float(np.abs(out["remat_mixed"].numpy() - want).max()) <= 2e-4
    assert torch.equal(out["remat_mixed"], out["remat_fp32"])
    assert float((out["hoisted_mixed"] - out["remat_fp32"]).abs().max()) > 1e-4
