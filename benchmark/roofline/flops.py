"""Model FLOPs a frame (serving) or a training image (forward and
backward), counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
plain reference on the ``meta`` device at the cell's shapes: the FLOPs of
the model's convolutions and products, whatever the program computes."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.depthnet import forward, param_spec
from benchmark.roofline.peaks import peak_flops

__all__ = ["model_flops", "mfu_pct"]


@functools.lru_cache(maxsize=8)
def _count(key):
    cfg, (h, w), train = dict(key[0]), key[1], key[2]
    cfg["which_ResBlk_depth"] = list(cfg["which_ResBlk_depth"])
    dev = torch.device("meta")
    params = {n: torch.empty(s, device=dev, requires_grad=train)
              for n, s, _, _ in param_spec(cfg)}
    k = cfg["depth_masks"]
    x = [torch.empty((1, h, w, c), device=dev) for c in (3, 1, k)]
    with FlopCounterMode(display=False) as counter:
        if train:
            forward(params, cfg, *x).sum().backward()
        else:
            with torch.no_grad():
                forward(params, cfg, *x)
    return counter.get_total_flops()


def model_flops(net: dict, lr_hw, train: bool = False) -> int:
    """FLOPs of one frame at LR ``lr_hw``; with ``train`` its forward and
    backward."""
    key = (tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in sorted(net.items())), tuple(lr_hw), bool(train))
    return _count(key)


def mfu_pct(trace, cell, train: bool):
    """The traced window's model FLOPs a second over the cards' peak at
    the configuration's stated precision, in %; None with nothing traced."""
    if not trace.frames or trace.window_s <= 0:
        return None
    flops = model_flops(cell.net, cell.traffic["lr_hw"], train) * trace.frames
    prec = cell.config["train_precision" if train else "serve_precision"]
    return 100.0 * flops / trace.window_s / (cell.chips * peak_flops(prec))
