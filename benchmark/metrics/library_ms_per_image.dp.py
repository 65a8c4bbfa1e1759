"""Rank 0's device ms a training image of kernels not built from
`endosr_torch/csrc`, over the images rank 0 stepped (its share of the
global batch). Moves `train_images_per_s.dp`."""


def read(trace, cell):
    ms = trace.ms_per_frame(own=False)
    return ms * cell.chips if ms is not None else None
