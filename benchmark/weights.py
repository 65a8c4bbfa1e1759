"""Seeded weights for a configuration, made on the device in a few calls.

Every parameter of ``reference.depthnet.param_spec`` is drawn from one
uniform draw of a ``torch.Generator`` on the device: torch's conv default
U(±1/√fan_in) for kernels and biases, the weight-norm gain ‖v‖ (so the
effective kernel starts as v), α ~ U[0, 1). The output conv is then scaled
and shifted so that the SR of a calibration input, computed by the plain
reference without its clamp, has its median at 0.5 per colour and its 1st
and 99th percentiles within [0.1, 0.9], the one farther from the median
on its edge: the SR is neither clamped flat nor a faint ripple on 0.5, and
the comparison sees a whole range of values, as a trained network's output
has.
"""

from __future__ import annotations

import torch

from benchmark.reference.depthnet import forward, param_spec

__all__ = ["make_params", "calibrate_output"]


def make_params(cfg: dict, seed: int, device) -> dict:
    """{name: fp32 tensor on ``device``} of the configured network."""
    spec = param_spec(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    params, at = {}, 0
    for (name, shape, kind, fan), n in zip(spec, sizes):
        u = flat[at:at + n].view(shape)
        at += n
        if kind == "u":
            bound = 1.0 / fan ** 0.5
            params[name] = u * (2 * bound) - bound
        elif kind == "g":
            v = params[name[:-len("weight_g")] + "weight_v"]
            params[name] = v.square().sum(dim=(1, 2, 3), keepdim=True).sqrt()
        else:
            params[name] = u.clone()
    return params


@torch.no_grad()
def calibrate_output(params: dict, cfg: dict, lq, depth, masks) -> None:
    """Scale and shift ``conv_output`` in place from one unclamped plain
    forward of the given (small) inputs."""
    out = forward(params, cfg, lq, depth, masks, clamp=None).reshape(-1, 3)
    q = torch.quantile(out[::max(1, out.shape[0] // 100000)],
                       torch.tensor([0.01, 0.5, 0.99], device=out.device),
                       dim=0)
    lo, med, hi = q[0], q[1], q[2]
    half = torch.maximum(med - lo, hi - med).amax()
    s = 0.4 / half.clamp_min(1e-12)
    params["conv_output.weight"] = params["conv_output.weight"] * s
    params["conv_output.bias"] = params["conv_output.bias"] * s + (0.5 - s * med)
