"""Share of the served requests whose forward replayed a CUDA graph, in %:
the program's `serve.replay` spans (`models/serve_graph.py`) ÷ its
`serve.forward` spans (one a `FModelDepthCond.test`) in the traced window.
None without a `serve.forward` span, and for a program without graph
replay (no `FModelDepthCond.graph_stats`). Moves `sr_frames_per_s`."""

from benchmark.spans import spans


def read(trace, cell):
    from endosr_torch.models.f_depthcond import FModelDepthCond

    forwards = spans(trace, "serve.forward")
    if not forwards or not hasattr(FModelDepthCond, "graph_stats"):
        return None
    return 100.0 * len(spans(trace, "serve.replay")) / len(forwards)
