"""CPU tests of ``graph_replay_share.serve`` on synthetic traces.

    python -m pytest benchmark/tests/test_bench_replay.py -q
"""

from __future__ import annotations

import pytest

from benchmark.harness import load_module
from benchmark.tracing import Trace

READER = load_module("metrics", "graph_replay_share.serve")


def _trace(requests, replayed):
    """``requests`` served requests, the first ``replayed`` of them from a
    graph: a ``serve.inputs`` then a ``serve.forward`` span each, the
    ``serve.replay`` span inside the forward."""
    host = []
    for i in range(requests):
        t = i * 1_000
        host += [("serve.inputs", t, t + 100), ("serve.forward", t + 100, t + 900)]
        if i < replayed:
            host.append(("serve.replay", t + 200, t + 800))
    return Trace([("k", 0, requests * 1_000, "kernel")], host,
                 [("request.test", 0, requests * 1_000)], window_s=1.0,
                 units=requests)


@pytest.mark.parametrize("replayed, want", [(4, 100.0), (0, 0.0), (1, 25.0)])
def test_share_of_forwards_that_replayed(replayed, want):
    assert READER.read(_trace(4, replayed), None) == pytest.approx(want)


def test_no_serve_forward_reads_none():
    t = Trace([("k", 0, 10, "kernel")], [("serve.replay", 0, 5),
                                         ("aten::add", 0, 5)], [],
              window_s=1.0, units=1)
    assert READER.read(t, None) is None
