"""Device kernels launched a request (serving model layer: `feed_data`,
`test`, its copies and chunking). Moves `sr_frames_per_s`."""


def read(trace, cell):
    return trace.per_unit(len(trace.kernels()))
