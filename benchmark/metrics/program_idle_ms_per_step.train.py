"""Device-idle ms ÷ steps, over the gaps whose innermost open host
event, on any thread, is a program span (`serve.`, `net.`, `kernel.`,
`train.`, `dp.`): the device waits on the program's own Python, not on
a library operation, a CUDA call or the harness. Moves `train_images_per_s`."""

from benchmark.spans import program_idle_ms_per_unit


def read(trace, cell):
    return program_idle_ms_per_unit(trace)
