"""Device ms a frame of the program's own kernels (`endosr_torch/csrc`).
Moves `sr_frames_per_s`."""


def read(trace, cell):
    return trace.ms_per_frame(own=True)
