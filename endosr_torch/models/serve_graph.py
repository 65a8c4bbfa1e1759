"""CUDA-graph replay of the unbucketed serving forward.

``FModelDepthCond.test`` serves its unbucketed, unsharded forward (every
chunk of ``chunked_serving_fn``) from one ``torch.cuda.CUDAGraph`` per input
signature where :func:`engaged` says so: on CUDA, unbucketed, unsharded,
in a model without an optimizer (a training run's validation stays eager:
its weights move between calls and a graph's memory would sit beside the
step's). Elsewhere, and on the CPU, the forward runs as it is written.

- The key (:func:`graph_key`) is the three inputs' shapes, dtypes and
  strides, the device and the chunk. A key's first call runs eager (it makes
  the lazy builds, the device constants and the kernels' state), its second
  captures (``torch.cuda.graph``, on a side stream) and then replays, every
  later call replays. The last :data:`KEPT` keys are kept, least recently
  used dropped first, so a caller whose frame size keeps changing does not
  pile up graphs; the graphs of a model share one memory pool (one call
  runs at a time, on one stream).
- Inputs: each graph has static device buffers; a call copies its arrays in
  (``copy_``, the copy ``.to(device)`` made).
- Weights: the weight preparation is inside the graph, so each replay reads
  the parameters' memory as it is then (an in-place ``load_state_dict`` is
  seen). When any parameter's or buffer's storage moves, every graph is
  dropped. A graph keeps the device constants and kernel buffers that it
  reads (``utils/device.py::held``).
- Output: a copy of the graph's static output, so a caller may keep it
  across calls.
- The kernel wrappers' launch counters count launches that ran: what the
  capture added is taken back, and each replay adds it
  (``kernels/_counters.py``).

``stats`` counts the calls: ``eager``, ``captures`` (a call that captured
and replayed once) and ``replays``. A replay runs in a ``serve.replay``
span (``utils/prof.annotate``).
"""

from __future__ import annotations

import collections

import torch

from endosr_torch.kernels import _counters
from endosr_torch.utils.device import held
from endosr_torch.utils.prof import annotate

__all__ = ["KEPT", "ServingGraphs", "engaged", "graph_key"]

# input signatures a model keeps (each seen once, or with its graph)
KEPT = 4


def engaged(device, bucket: int, nsp: int, optimizer) -> bool:
    """Whether a ``test()`` call serves from a graph: on CUDA, unbucketed,
    unsharded, without an optimizer."""
    return (torch.device(device).type == "cuda" and not bucket and not nsp
            and optimizer is None)


def graph_key(x, device, chunk) -> tuple:
    """A call's graph: the inputs' (shape, dtype, strides), the device and
    the chunk."""
    return (tuple((tuple(t.shape), t.dtype, t.stride()) for t in x),
            torch.device(device), chunk)


class _Graph:
    """One key's static inputs and, once captured, its graph, its static
    output, the launch counts of one forward and the long-lived tensors it
    reads (``utils/device.py::held``)."""

    def __init__(self, x, device):
        self.inputs = [torch.empty_like(t, device=device) for t in x]
        self.graph = self.out = self.counts = self.held = None


class ServingGraphs:
    """The graphs of one serving forward ``fwd`` of ``net``."""

    def __init__(self, net, fwd, chunk, device):
        self.net, self.fwd, self.chunk = net, fwd, chunk
        self.device = torch.device(device)
        self.stats = {"eager": 0, "captures": 0, "replays": 0}
        # key → its _Graph, or None for a key seen once
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._storage = None
        self._pool = None
        # (its module's parameter or buffer dict, name) of every tensor of
        # the net's modules: a dict lookup each is a tenth of a walk
        self._slots = [(d, k) for m in net.modules()
                       for d in (m._parameters, m._buffers)
                       for k, v in d.items() if v is not None]

    def _storage_now(self) -> tuple:
        return tuple(d[k].data_ptr() for d, k in self._slots)

    def fill(self, x):
        """The graph of inputs ``x`` (host or device tensors) with ``x``
        copied into its static inputs, or None where the call runs eager
        (the key's first call)."""
        storage = self._storage_now()
        if storage != self._storage:
            self._graphs.clear()
            self._storage, self._pool = storage, None
        key = graph_key(x, self.device, self.chunk)
        if key not in self._graphs:
            self._graphs[key] = None
            g = None
        else:
            g = self._graphs[key] or _Graph(x, self.device)
            self._graphs[key] = g
            self._graphs.move_to_end(key)
            for s, t in zip(g.inputs, x):
                s.copy_(t)
        while len(self._graphs) > KEPT:
            self._graphs.popitem(last=False)
        return g

    def run(self, g):
        """The forward of ``g``'s static inputs: captured on the key's second
        call, then replayed. Returns a copy of the output."""
        if g.graph is None:
            before = _counters.snapshot()
            graph = torch.cuda.CUDAGraph()
            with held() as kept, torch.cuda.graph(
                    graph, pool=self._pool, capture_error_mode="thread_local"):
                out = self.fwd(*g.inputs)
            g.counts = _counters.since(before)
            _counters.advance(g.counts, -1)
            g.graph, g.out, g.held = graph, out, kept
            self._pool = self._pool or graph.pool()
            self.stats["captures"] += 1
        else:
            self.stats["replays"] += 1
        with annotate("serve.replay"):
            g.graph.replay()
        _counters.advance(g.counts)
        return g.out.clone()
