"""CPU tests of the span metrics (``benchmark/spans.py`` and the
``metrics/*`` that read the program's spans), on synthetic traces and on a
tiny traced serving run.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import math

import pytest

from benchmark.harness import load_cell, load_module
from benchmark.roofline.plan import serve_plan
from benchmark.run import _per_layer
from benchmark.spans import (innermost, launches_per_unit, ms_per_unit,
                             program_idle_ms_per_unit)
from benchmark.tests.test_bench_harness import bench, run_tiny, tiny
from benchmark.tracing import Trace

SPAN_METRICS = {
    "input_ms_per_request.serve", "prepare_ms_per_request.serve",
    "prepare_launches_per_request.serve", "kernel_host_ms_per_request.serve",
    "program_idle_ms_per_request.serve", "program_idle_ms_per_step.train",
    "program_idle_ms_per_step.dp"}


def _trace(device, host, spans=(), units=1):
    return Trace([(n, s, e, "kernel") for n, s, e in device], list(host),
                 list(spans), window_s=1.0, units=units)


# a device gap from 1 000 ns to 10 000 ns
GAP = [("k", 0, 1_000), ("k", 10_000, 10_100)]


def test_gap_in_a_span_opened_long_before_is_counted():
    """300 host operations open and close between the span's start and the
    gap: the program span is still the innermost event open there."""
    busy = [("aten::add", 10 + 3 * i, 11 + 3 * i) for i in range(300)]
    t = _trace(GAP, [("train.backward", 0, 20_000), *busy],
               [("step.optimize_parameters", 0, 30_000)], units=2)
    assert program_idle_ms_per_unit(t) == pytest.approx(9_000 / 1e6 / 2)
    # the breakdown looks back 200 host events only
    assert t.breakdown()["idle_gaps"][0][0] == "step.optimize_parameters"


@pytest.mark.parametrize("inner", ["aten::copy_", "cudaLaunchKernel",
                                   None])
def test_gap_under_a_library_op_a_launch_or_the_harness_is_not(inner):
    host = [("serve.inputs", 20_000, 30_000)]       # elsewhere in the trace
    if inner:
        host += [("serve.forward", 0, 20_000), (inner, 900, 5_000)]
    t = _trace(GAP, host, [("request.test", 0, 40_000)])
    assert program_idle_ms_per_unit(t) == 0.0


def test_innermost_is_the_shortest_open_event_on_any_thread():
    events = [("a", 0, 100), ("b", 10, 50), ("c", 20, 30), ("d", 60, 70)]
    got = innermost(events, [5, 25, 40, 65, 80, 100])
    assert [g and g[0] for g in got] == ["a", "c", "b", "d", "a", None]


def test_launches_count_only_inside_net_prepare():
    host = [("net.prepare", 100, 200), ("net.prepare", 120, 180),   # nested
            ("cudaLaunchKernel", 150, 151), ("cudaMemcpyAsync", 160, 161),
            ("cudaLaunchKernelExC_v11060", 190, 191),
            ("aten::cat", 170, 175),                   # not a launch
            ("cudaLaunchKernel", 250, 251),            # outside
            ("kernel.head_dot", 300, 400), ("cuLaunchKernel", 350, 351)]
    t = _trace([], host, units=3)
    assert launches_per_unit(t, "net.prepare") == 1.0
    # the union: the nested span adds nothing
    assert ms_per_unit(t, "net.prepare") == pytest.approx(100 / 1e6 / 3)
    assert ms_per_unit(t, "kernel.") == pytest.approx(100 / 1e6 / 3)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metrics_read_none_without_spans(name):
    t = _trace(GAP, [("aten::add", 0, 500), ("cudaLaunchKernel", 5, 6)],
               [("request.test", 0, 20_000)])
    assert load_module("metrics", name).read(t, None) is None


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_declared_metric_reads_a_trace_with_program_spans(cell):
    """The trace of ``test_every_declared_metric_reads_a_trace_of_its_cell``
    with the host events the span metrics read added (a ``serve.inputs``, a
    ``net.prepare`` holding a ``cudaLaunchKernel``, a ``kernel.*`` span and
    a program span open over a device gap): every per-layer metric declared
    for the cell returns a finite number."""
    c = load_cell(cell)
    units = 2
    plan = serve_plan(c.config, c.traffic, c.spec.get("opt", {})) or {}
    ops = [("void output_stage_x8_vec16_kernel<bf16>(float*)", 0, 10**9,
            "kernel"),
           ("void at::native::add_kernel(float*)", 0, 2 * 10**8, "kernel"),
           ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 3 * 10**8, 4 * 10**8,
            "kernel"),
           ("Memcpy HtoD (Pageable -> Device)", 5 * 10**8, 6 * 10**8,
            "memcpy"),
           ("void at::native::add_kernel(float*)", 12 * 10**8, 13 * 10**8,
            "kernel")]
    host = [("serve.inputs", 0, 5 * 10**7),
            ("net.prepare", 6 * 10**7, 9 * 10**7),
            ("cudaLaunchKernel", 7 * 10**7, 7 * 10**7 + 5_000),
            ("kernel.head_dot", 9 * 10**7, 10**8),
            ("train.forward", 9 * 10**8, 12 * 10**8)]
    trace = Trace(ops, host, [], window_s=2.0, units=units,
                  frames=units * c.traffic["batch"],
                  extra={"calls": {k: len(v) * units for k, v in plan.items()}})
    for m in c.per_layer:
        v = load_module("metrics", m["name"]).read(trace, c)
        assert v is not None and v == v and v > 0, m["name"]
        if m["unit"] == "%":
            assert v < 100, m["name"]


def test_span_metrics_declared_for_the_cells_that_have_the_spans():
    b = bench()
    got = {m["name"]: set(m["workloads"]) for m in b["per_layer"]
           if m["name"] in SPAN_METRICS}
    serve = {"x8_offline_b32", "x2_live_b1"}
    assert got == {**{n: serve for n in SPAN_METRICS if n.endswith(".serve")},
                   "program_idle_ms_per_step.train": {"x8_train_b8"},
                   "program_idle_ms_per_step.dp": {"x8_train_dp4"}}


def test_traced_tiny_serving_run_reads_the_program_spans():
    cell = tiny("x8_offline_b32")
    out = run_tiny(cell, trace=1)
    assert out.trace is not None and out.trace.units == 3
    got = _per_layer(cell, out)
    for name in ("input_ms_per_request.serve",
                 "prepare_ms_per_request.serve",
                 "kernel_host_ms_per_request.serve"):
        v = got[name]["value"]
        assert math.isfinite(v) and v > 0, name
    # no device on the CPU: no launch calls, no device gaps
    assert got["prepare_launches_per_request.serve"]["value"] == 0
    assert got["program_idle_ms_per_request.serve"]["value"] == 0
