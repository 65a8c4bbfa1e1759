"""Device ms a training image of kernels not built from
`endosr_torch/csrc`. Moves `train_images_per_s`."""


def read(trace, cell):
    return trace.ms_per_frame(own=False)
