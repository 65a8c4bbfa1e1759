"""Device ms a frame of kernels not built from `endosr_torch/csrc` (cuDNN,
elementwise work, norms, copies, casts around the kernels). Moves
`sr_frames_per_s`."""


def read(trace, cell):
    return trace.ms_per_frame(own=False)
