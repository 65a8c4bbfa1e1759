"""Host ms a request covered by the union of the program's `kernel.*`
spans (each kernel wrapper: checks, operands, pointer tables, weight
packing and the launch) ÷ requests. Moves `sr_frames_per_s`."""

from benchmark.spans import ms_per_unit


def read(trace, cell):
    return ms_per_unit(trace, "kernel.")
