"""The data-parallel training step's share of the cards' peak, in %, as
`mfu.train` counts it over the global batch. Moves `train_images_per_s.dp`."""

from benchmark.roofline.flops import mfu_pct


def read(trace, cell):
    return mfu_pct(trace, cell, train=True)
