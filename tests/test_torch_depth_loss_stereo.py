"""The port's monodepth2 loss and its gradients against the JAX trainer's
for a stereo config (frames [0, -1, 1, 's'], the stereo frame's camera
transform ``stereo_T`` from the batch), on the CPU in fp32 at feed 64×96,
batch 2, by the bars of ``tests/test_torch_depth_loss.py``: the losses
≤ 1e-5 relative, every gradient ≤ 2e-4 of its max |ref| or within the
one-ulp-nudge rule of both packages.
"""

import pytest

from tests.torch_depth_common import check_loss_and_gradients, loss_nets
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def nets():
    return loss_nets()


def test_stereo_loss_and_gradients_match_jax(nets):
    check_loss_and_gradients(nets, (0, -1, 1, "s"), seed=13)
