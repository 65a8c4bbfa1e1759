"""The whole training step's share of the chip's peak, in %: forward and
backward model FLOPs an image × images ÷ the traced window ÷ (cards × the
stated precision's peak). Moves `train_images_per_s`."""

from benchmark.roofline.flops import mfu_pct


def read(trace, cell):
    return mfu_pct(trace, cell, train=True)
