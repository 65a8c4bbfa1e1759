"""The whole serving step's share of the chip's peak, in %: model FLOPs a
frame (`roofline/flops.py`) × frames ÷ the traced window ÷ (cards × the
stated precision's peak). Moves `sr_frames_per_s`."""

from benchmark.roofline.flops import mfu_pct


def read(trace, cell):
    return mfu_pct(trace, cell, train=False)
