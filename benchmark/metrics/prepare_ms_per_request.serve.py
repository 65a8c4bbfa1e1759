"""Host ms a request covered by the union of the program's `net.prepare`
spans (weight norm, folds, phase packing, the kernels' weight packing)
÷ requests. Moves `sr_frames_per_s`."""

from benchmark.spans import ms_per_unit


def read(trace, cell):
    return ms_per_unit(trace, "net.prepare")
