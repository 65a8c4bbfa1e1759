"""The program's kernel calls in one request of a serving cell, with the
work of each (``roofline/kernels.py``), for the paths whose calls are
known: the unmasked ×8 forward in bf16 (the packed tail) and the unmasked
×2 forward in a centered precision. A path not listed here has no plan,
and ``kernels_roofline.serve`` then reads nothing.
"""

from __future__ import annotations

from benchmark.roofline import kernels as K
from benchmark.roofline.peaks import peak_flops

__all__ = ["serve_plan"]


def _style_groups(cfg: dict, chunk: int = 7):
    trunk = [i for i in range(cfg["network_G"]["nb"] - 3)
             if i in set(cfg["network_G"]["which_ResBlk_depth"])]
    return [len(trunk[i:i + chunk]) for i in range(0, len(trunk), chunk)]


def serve_plan(config: dict, traffic: dict, opt: dict):
    """{kernel wrapper: [bound seconds of each call]} of one request, or
    None where the cell's path has no plan."""
    b = int(traffic["batch"])
    h, w = traffic["lr_hw"]
    if opt.get("eval_bucket_multiple", 32) != 0:
        return None
    chunk = opt.get("serve_batch_chunk", 8)
    if chunk and b > chunk:
        return None
    g = config["network_G"]
    c, k = int(g["nf"]), int(config["depthMaskNum"])
    prec, scale = config["serve_precision"], int(config["scale"])
    peak = peak_flops(prec)

    def bound(work):
        return K.bound_s(work, peak)

    j = 9 * k
    if scale == 8 and prec == "bf16":
        isz = 2
        return {
            "packed_g123": [bound(K.packed_g123(b, h, w, 256, False, isz)),
                            bound(K.packed_g123(b, h + 1, w + 1, 128, True,
                                                isz, pre_bias=True))],
            "style_blend_dot": [bound(K.style_blend_dot(b, h, w, j,
                                                        n * 4 * c, isz))
                                for n in _style_groups(config)],
            "head_dot": [bound(K.head_dot(b, 2 * h + 1, 2 * w + 1, 2 * w,
                                          512, 64, isz))],
            "output_stage_x8": [bound(K.output_stage_x8(4 * h * w * b, isz))],
        }
    if scale == 2 and prec in ("bf16c", "bf16c3"):
        return {
            "style_dot_hwbm": [bound(K.style_dot_hwbm(b, h, w, j, n * 4 * c, 2))
                               for n in _style_groups(config)],
            "output_stage": [bound(K.output_stage(b, h, w, 2, 4))],
        }
    return None
