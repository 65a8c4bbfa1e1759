"""Launch calls (`cudaLaunchKernel`, `cudaLaunchKernelExC`,
`cuLaunchKernel*`, `cudaMemcpyAsync`, `cudaMemsetAsync`) that start inside
a `net.prepare` span ÷ requests: the device work of preparing weights on
every forward. Moves `sr_frames_per_s`."""

from benchmark.spans import launches_per_unit


def read(trace, cell):
    return launches_per_unit(trace, "net.prepare")
