"""ESRGAN's SRGAN step (``ragan`` with the VGG feature loss, a seeded
VGG19 file both packages read) against the JAX package's, fp32 on the
CPU: ``tests/test_torch_gan.py``'s SRGAN checks (logs and their keys per
gate, G's and D's gradients against JAX's float64 ones, D's running
statistics after a G + D step, the parameters after 1 and all updates),
at its sizes and bars."""

import pytest

from endosr_torch.utils.port_params import write_seeded_vgg
from tests.test_torch_gan import (_srgan_run, check_srgan_d_statistics,
                                  check_srgan_gradients, check_srgan_logs,
                                  check_srgan_parameters)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ragan(tmp_path_factory):
    vgg = write_seeded_vgg(str(tmp_path_factory.mktemp("vgg") / "vgg.pth"),
                           seed=3)
    return _srgan_run("ragan", vgg)


def test_ragan_logs_match_jax(ragan):
    check_srgan_logs(ragan, "ragan")


def test_ragan_gradients_match_jax(ragan, record_property):
    check_srgan_gradients(ragan, record_property)


def test_ragan_d_statistics_after_a_g_and_d_step(ragan):
    check_srgan_d_statistics(ragan)


def test_ragan_parameters_after_updates_match_jax(ragan):
    check_srgan_parameters(ragan, "ragan")
