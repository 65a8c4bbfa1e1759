"""Device kernels launched a data-parallel training step on rank 0.
Moves `train_images_per_s.dp`."""


def read(trace, cell):
    return trace.per_unit(len(trace.kernels()))
