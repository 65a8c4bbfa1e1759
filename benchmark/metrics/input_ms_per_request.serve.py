"""Host ms a request covered by the program's `serve.inputs` spans
(`FModelDepthCond.test`: casts, bucketing's pad and pooling mask, the
host-to-device copies) ÷ requests. Moves `request_ms_p95`."""

from benchmark.spans import ms_per_unit


def read(trace, cell):
    return ms_per_unit(trace, "serve.inputs")
