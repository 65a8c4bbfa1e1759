"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds ``benchmark/workloads/<name>.json``, its configuration and its
traffic generator by name, builds the program (``endosr_torch``) on the
card, warms up the cell's own shapes, measures for ``--seconds`` (or, with
``--trace 1``, traces a fixed number of requests or steps), checks what
the timed path produced against the plain reference, and prints one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; ``checks``, last, holds every
number compared beside its limit, which also end standard error.

Exits non-zero without a result when there is no CUDA device, when the
cell asks for more cards than there are, or when a module of JAX or of the
JAX package is loaded once the window has closed. A cell of several cards
starts one process a card (NCCL on ``localhost``) and the first prints.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

os.environ.setdefault("USE_FLAX", "0")


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Context:
    """What a traffic generator is given."""

    def __init__(self, cell, seed, seconds, trace, device, rank=0, world=1,
                 mesh=None, t_start=T_START):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = bool(trace), device
        self.rank, self.world, self.mesh = rank, world, mesh
        self.t_start = t_start


def _per_layer(cell, outcome):
    """{metric: {"value", "unit"}} of the cell's per-layer metrics that
    find something to read in the trace."""
    from benchmark.harness import load_module

    out = {}
    for m in cell.per_layer:
        value = load_module("metrics", m["name"]).read(outcome.trace, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _line(cell, outcome, traced):
    from benchmark.harness import device_record

    checks = {c.name: {"value": c.value, "limit": c.limit}
              for c in outcome.checks}
    correct = (outcome.failed == 0 and bool(outcome.checks)
               and all(c.ok for c in outcome.checks))
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if traced:
        metrics = _per_layer(cell, outcome)
    else:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in outcome.metrics.items() if k in units}
    dev = device_record(cell.chips, outcome.peak_bytes)
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = outcome.trace.busy_s()
        dev["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = checks
    return line


def run_cell(ctx):
    """The cell's traffic under ``ctx``: its Outcome."""
    from benchmark.harness import load_module

    return load_module("traffic", ctx.cell.traffic["kind"]).run(ctx)


def _rank_main(rank, world, device, mesh, args, t_start):
    """One rank of a several-card cell: (its Outcome on rank 0, its peak,
    the forbidden modules it loaded)."""
    from benchmark.harness import forbidden_modules, load_cell

    cell = load_cell(args.workload)
    out = run_cell(Context(cell, args.seed, args.seconds, args.trace, device,
                           rank, world, mesh, t_start))
    return (out if rank == 0 else None, out.peak_bytes, forbidden_modules())


def _several(cell, args):
    from benchmark.harness import launch_ranks

    got = launch_ranks(_rank_main, cell.chips, args, T_START)
    forbidden = sorted({m for _, _, found in got for m in found})
    if forbidden:
        raise SystemExit(f"run.py: a rank loaded modules of JAX or the JAX "
                         f"package: {forbidden}")
    out = got[0][0]
    out.peak_bytes = max(peak for _, peak, _ in got)
    return out


def main(argv=None) -> int:
    args = _parse(argv)
    import torch

    from benchmark.harness import forbidden_modules, load_cell, strict_fp32

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    strict_fp32()
    if cell.chips > 1:
        outcome = _several(cell, args)
    else:
        outcome = run_cell(Context(cell, args.seed, args.seconds, args.trace,
                                   torch.device("cuda", 0)))
    found = forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    line = _line(cell, outcome, bool(args.trace))
    for e in outcome.errors[:5]:
        print(f"error: {e}", file=sys.stderr)
    notes = {**outcome.notes, "run_s": time.perf_counter() - T_START}
    print("notes: " + json.dumps(notes), file=sys.stderr)
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
