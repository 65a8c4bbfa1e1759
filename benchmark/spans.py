"""The program's own spans in a traced run, and what the span metrics read.

The program opens a ``record_function`` span at each of its layer
boundaries (``endosr_torch/utils/prof.py::annotate``), named by layer:
``serve.*``, ``net.*``, ``kernel.*``, ``train.*`` and ``dp.*``. Their names
are not the harness's, so a :class:`~benchmark.tracing.Trace` holds them
among its host operations, on the profiler's one clock with the device's.

Every reading is None where the trace holds none of the spans it reads (a
program without them), never 0.
"""

from __future__ import annotations

import bisect
import heapq

from benchmark.tracing import union_s

__all__ = ["PROGRAM", "is_program", "is_launch", "spans", "ms_per_unit",
           "launches_per_unit", "device_gaps", "innermost",
           "program_idle_ms_per_unit"]

# the name prefixes of the program's spans, one per layer
PROGRAM = ("serve.", "net.", "kernel.", "train.", "dp.")
# host calls that put work on the device
_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
           "cudaMemsetAsync")


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def is_launch(name: str) -> bool:
    """``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel*``,
    ``cudaMemcpyAsync`` or ``cudaMemsetAsync`` (versioned names too)."""
    return name.startswith(_LAUNCH)


def spans(trace, prefix: str) -> list:
    """[(start_ns, end_ns)] of the host operations named ``prefix``, or
    starting with it when it ends in a dot."""
    if prefix.endswith("."):
        return [(s, e) for n, s, e in trace.host_ops if n.startswith(prefix)]
    return [(s, e) for n, s, e in trace.host_ops if n == prefix]


def ms_per_unit(trace, prefix: str):
    """Host ms covered by the union of the ``prefix`` spans ÷ requests or
    steps; None without such a span."""
    got = spans(trace, prefix)
    if not got or not trace.units:
        return None
    return union_s(got) * 1e3 / trace.units


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def launches_per_unit(trace, prefix: str):
    """Launch calls (:func:`is_launch`) that start inside a ``prefix`` span
    ÷ requests or steps; None without such a span."""
    got = spans(trace, prefix)
    if not got or not trace.units:
        return None
    merged = _merged(got)
    starts = [s for s, _ in merged]
    n = 0
    for name, s, _ in trace.host_ops:
        if is_launch(name):
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s < merged[i][1]
    return n / trace.units


def device_gaps(trace) -> list:
    """[(start_ns, end_ns)] of every stretch between two device operations
    in which none ran (as ``Trace.breakdown`` finds them)."""
    gaps, end = [], None
    for _, s, e, _ in sorted(trace.device_ops, key=lambda o: o[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def innermost(events, instants) -> list:
    """For each of the ascending ``instants``, the shortest of ``events``
    [(name, start_ns, end_ns)] open there (start ≤ t < end), however long
    before it opened, on any thread; None where none is. One sweep."""
    order = sorted(range(len(events)), key=lambda i: events[i][1])
    heap, j, out = [], 0, []
    for t in instants:
        while j < len(order) and events[order[j]][1] <= t:
            _, s, e = events[order[j]]
            # the shortest first; of two alike the one opened later
            heapq.heappush(heap, (e - s, -s, e, order[j]))
            j += 1
        while heap and heap[0][2] <= t:
            heapq.heappop(heap)
        out.append(events[heap[0][3]] if heap else None)
    return out


def program_idle_ms_per_unit(trace):
    """Device-idle ms ÷ requests or steps, over the gaps whose innermost
    open host event (host operations and the harness's spans alike) is a
    program span: the device waits on the program's own Python, not on a
    library operation, a CUDA call or the harness. None without a program
    span in the trace."""
    if not trace.units or not any(is_program(n) for n, _, _ in
                                  trace.host_ops):
        return None
    gaps = device_gaps(trace)
    found = innermost(trace.host_ops + trace.spans, [g0 for g0, _ in gaps])
    ns = sum(g1 - g0 for (g0, g1), ev in zip(gaps, found)
             if ev is not None and is_program(ev[0]))
    return ns / 1e6 / trace.units
