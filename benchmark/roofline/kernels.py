"""Operations and bytes of one call of each of the program's kernels, as
functions of the call's shapes and element size: the work the call has to
do, whatever implements it (each input read once, each output written
once). The arithmetic is that of the per-kernel cases the kernels were
built against (``chip_smoke.py::make_cases``); ``bound_s`` turns it into
the least time the chip can take.
"""

from __future__ import annotations

from benchmark.roofline.peaks import FLOPS, HBM_BPS

__all__ = ["bound_s", "packed_g123", "style_blend_dot", "style_dot_hwbm",
           "head_dot", "output_stage_x8", "output_stage"]


def bound_s(work, peak=FLOPS["bf16"]) -> float:
    """max(operations ÷ peak, bytes ÷ HBM rate) of (bytes, flops)."""
    nbytes, flops = work
    return max(flops / peak, nbytes / HBM_BPS)


def packed_g123(b, h, w, cin4, phases, isz, pre_bias=False):
    """Three gated 2×2 convs (cin4 → 128 → 128 → 128) on the packed grid
    of an [h, w, b, ·] input: (h + 1)(w + 1) positions, or with ``phases``
    (2h − 1)(2w − 1)."""
    n, m = ((2 * (h - 1) + 1, 2 * (w - 1) + 1) if phases else (h + 1, w + 1))
    cin = 512 if phases else cin4
    weights = (4 * cin4 * 128 + 2 * 4 * 128 * 128 + 3 * 128
               + (cin4 if pre_bias else 0))
    nbytes = (b * h * w * cin + weights + n * m * b * 128) * isz
    flops = 2 * b * n * m * 4 * (cin4 * 128 + 2 * 128 * 128)
    return nbytes, flops


def style_blend_dot(b, h, w, j, m, isz):
    """The blended modulation of a style group: [b,h,w,j] shifted masks ×
    [b,j,m] style kernels + the group's m conv channels + an fp32 bias."""
    nbytes = (b * h * w * j + b * j * m + 2 * b * h * w * m) * isz + m * 4
    return nbytes, 2 * b * h * w * j * m


def style_dot_hwbm(b, h, w, j, m, isz):
    """[b,h,w,j] shifted masks × [b,j,m] style kernels."""
    nbytes = (b * h * w * j + b * j * m + b * h * w * m) * isz
    return nbytes, 2 * b * h * w * j * m


def head_dot(b, hg, wg, wout, cin, cout, isz):
    """The folded 9×9 head, a 3×3 conv of cin → cout over the [hg, wg, b,
    cin] packed g4 into [wout-wide rows]."""
    nbytes = ((hg * wg * b * cin + 9 * cin * cout + cin) * isz + cout * 4
              + (hg - 1) * b * wout * cout * isz)
    return nbytes, 2 * b * (hg - 1) * wout * 9 * cin * cout


def output_stage_x8(n_pix, isz):
    """clamp + PixelShuffle(4) of n_pix 64-channel rows → fp32 RGB."""
    return n_pix * 64 * isz + n_pix * 48 * 4, 0


def output_stage(b, h, w, r, isz):
    """clamp + PixelShuffle(r) of [b,h,w,3r²] → fp32 RGB."""
    n = b * h * w * 3 * r * r
    return n * isz + n * 4, 0
