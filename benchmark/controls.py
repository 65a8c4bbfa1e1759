"""Readings that the limits of ``correct`` are set from (run on the card;
the benchmark's own runs never run this).

    python3 benchmark/controls.py --workload <name> [--seeds 12]
        [--control-seeds 3] [--faults] [--witness bf16] [--seconds 3.5]
        [--out FILE]

For each of ``--seeds`` seeds the cell runs as ``run.py`` runs it, with a
short window that still holds every sampled request, and its compared
numbers are read. Then the cell's control (``control`` in its file) on
``--control-seeds`` further seeds:

- ``{"kind": "reference", "numerics": "fp8"}``: the plain reference
  computed with fp8 operands in the program's place;
- ``{"kind": "program", "precision": P}``: the program serving at its own
  lower precision P;
- ``{"kind": "program", "tf32": true}``: the program with TF32 on.

``--witness N`` (serving cells) also reads, on the program's seeds, the
plain reference computed with ``N`` operands in the program's place: the
stated precision's own error beside the program's, seed by seed.

``--faults`` (training cells) also runs, on the same seeds, the program
with half of each batch left out (its mean taken over the rest) and, on
several cards, with the gradients' all-reduce left out. All runs of a cell
of several cards share one process a card. Every reading is printed as a
JSON line and written to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))


def seeds(n, base, step=7919):
    return [base + i * step for i in range(n)]


@contextlib.contextmanager
def variant(kind):
    """The program as the reading ``kind`` runs it."""
    import torch

    import endosr_torch.models.base as base
    from endosr_torch.models.f_depthcond import FModelDepthCond

    feed, reduce_ = FModelDepthCond.feed_data, base.allreduce_grads
    if kind == "control:tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif kind == "fault:half_batch":
        FModelDepthCond.feed_data = lambda self, d: feed(
            self, {k: v[:max(1, v.shape[0] // 2)] for k, v in d.items()})
    elif kind == "fault:no_exchange":
        base.allreduce_grads = lambda params, mesh=None: None
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        FModelDepthCond.feed_data, base.allreduce_grads = feed, reduce_


def reading(cell, kind, seed, seconds, device, rank=0, world=1, mesh=None):
    """{number: value} of one run of ``cell`` as ``kind`` runs it (rank 0;
    None on the others)."""
    from benchmark.run import Context, run_cell
    from benchmark.traffic.serve_closed import control_numbers

    ctl = cell.spec.get("control", {})
    if kind.startswith("witness:"):
        return control_numbers(Context(cell, seed, seconds, 0, device),
                               kind.split(":", 1)[1])
    if kind.startswith("control:") and ctl.get("kind") == "reference":
        return control_numbers(Context(cell, seed, seconds, 0, device),
                               ctl["numerics"])
    if kind.startswith("control:") and ctl.get("precision"):
        cell = copy.deepcopy(cell)
        cell.config["serve_precision"] = ctl["precision"]
    with variant(kind):
        out = run_cell(Context(cell, seed, seconds, 0, device, rank, world,
                               mesh, time.perf_counter()))
    if rank:
        return None
    nums = {c.name: c.value for c in out.checks}
    return nums if not out.failed else {k: float("inf") for k in nums}


def _rank(rank, world, device, mesh, workload, jobs, seconds):
    """One rank of a several-card cell: every job's reading (rank 0)."""
    import torch

    from benchmark.harness import load_cell

    cell, rows = load_cell(workload), []
    for kind, seed in jobs:
        rows.append((kind, seed, reading(cell, kind, seed, seconds, device,
                                         rank, world, mesh)))
        torch.distributed.barrier()
    return rows if rank == 0 else None


def main(argv=None) -> int:
    import torch

    from benchmark.harness import launch_ranks, load_cell, strict_fp32

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--witness", choices=["bf16"])
    ap.add_argument("--seconds", type=float, default=3.5)
    ap.add_argument("--first-seed", type=int, default=2**31 + 12345)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls.py: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    ctl = cell.spec.get("control", {})
    ctl_kind = "control:" + str(ctl.get("numerics") or ctl.get("precision")
                                or ("tf32" if ctl.get("tf32") else ""))
    all_seeds = seeds(args.seeds + args.control_seeds, args.first_seed)
    jobs = [("program", s) for s in all_seeds[:args.seeds]]
    if args.witness:
        jobs += [("witness:" + args.witness, s)
                 for s in all_seeds[:args.seeds]]
    for s in all_seeds[args.seeds:]:
        jobs.append((ctl_kind, s))
        if args.faults:
            jobs.append(("fault:half_batch", s))
            if cell.chips > 1:
                jobs.append(("fault:no_exchange", s))
    strict_fp32()
    rows = []

    def emit(kind, seed, nums):
        row = {"workload": cell.name, "kind": kind, "seed": seed,
               "numbers": nums}
        rows.append(row)
        print(json.dumps(row), flush=True)

    if cell.chips == 1:
        for kind, s in jobs:
            emit(kind, s, reading(cell, kind, s, args.seconds,
                                  torch.device("cuda", 0)))
    else:
        for row in launch_ranks(_rank, cell.chips, cell.name, jobs,
                                args.seconds)[0]:
            emit(*row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
