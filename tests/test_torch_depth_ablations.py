"""The port's monodepth2 loss (``endosr_torch/depth/trainer.py::
monodepth_loss``) against the JAX trainer's under each ablation and
variant of the options, values only, on the CPU in fp32 at feed 64×96,
batch 2 (seeded flax variables carried across, JAX's noise draws): each
scale's loss and the total ≤ 1e-5 relative for ``posecnn``, stereo alone
([0, 's'], no pose networks), ``v1_multiscale``, ``avg_reprojection``,
``disable_automasking``, ``no_ssim`` and scales {0, 2} (training mode),
and for the default config in eval mode (BatchNorm by the running
statistics, as ``Trainer.process_batch`` runs it).
"""

import jax
import pytest
import torch

from endosr_torch.depth.trainer import monodepth_loss
from tests.torch_depth_common import (check_losses, jax_loss_fn, jax_noise,
                                      loss_nets, loss_opt, make_batch,
                                      select_nets, to_jax, to_port)
from tests.torch_threads import one_torch_thread  # noqa: F401

STEP = 5

ABLATIONS = {
    "posecnn": dict(pose_model_type="posecnn"),
    "stereo_only": dict(frame_ids=(0, "s")),
    "v1_multiscale": dict(v1_multiscale=True),
    "avg_reprojection": dict(avg_reprojection=True),
    "disable_automasking": dict(disable_automasking=True),
    "no_ssim": dict(no_ssim=True),
    "scales_0_2": dict(scales=(0, 2)),
    "eval_mode": dict(),
}


@pytest.fixture(scope="module")
def nets():
    return loss_nets()


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_losses_match_jax(nets, name):
    opt = loss_opt(**ABLATIONS[name])
    train = name != "eval_mode"
    batch = make_batch(20, frame_ids=opt["frame_ids"],
                       stereo="s" in opt["frame_ids"])
    jnets, jv, models = select_nets(nets, opt, train=train)
    params = {k: a["params"] for k, a in jv.items()}
    _, want = jax.jit(jax_loss_fn(jnets, jv, opt, STEP, train=train))(
        params, to_jax(batch))
    with torch.no_grad():
        _, losses, _ = monodepth_loss(models, to_port(batch), opt,
                                      jax_noise(STEP))
    check_losses(losses, want)
