"""The port's monodepth2 loss and its gradients (``endosr_torch/depth/
trainer.py::monodepth_loss``) against the JAX trainer's, on the CPU in fp32
at feed 64×96, batch 2, the networks in training mode (BatchNorm by batch
statistics) on seeded flax variables carried across by
``from_flax_depth_trainer``, the auto-mask noise JAX's own draws
(``PRNGKey(step)`` split once a scale).

For the default config (ResNet-18, ``separate_resnet``, frames [0, -1, 1],
scales 0–3; the stereo config, frames [0, -1, 1, 's'] with ``stereo_T``
from the batch, is ``tests/test_torch_depth_loss_stereo.py``, held to the
same bars: one JAX compile a file):

- the total and each scale's loss ≤ 1e-5 relative;
- every parameter's gradient ≤ 2e-4 of that tensor's max |ref|, or, where
  a kink shows, by the one-ulp-nudge rule (phase 6b's, on both sides):
  within ``GRAD_NOISE`` × the largest change of either package's own
  gradient of that tensor under the same four one-ulp nudges (every
  image up, every image down, every weight up or down at random, twice)
  + 2e-4. With untrained networks the encoders' gradients are
  ill-conditioned: a nudge moves either package's own gradient of some
  tensors by up to 20 % of their max (the test prints its readings with
  ``-s``), and the two packages' distance stays about one such move.
"""

import pytest

from tests.torch_depth_common import check_loss_and_gradients, loss_nets
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def nets():
    return loss_nets()


def test_loss_and_gradients_match_jax(nets):
    check_loss_and_gradients(nets, (0, -1, 1), seed=12)
