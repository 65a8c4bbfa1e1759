"""What every cell shares: finding a cell and its configuration by name,
building the program under test from them, timing, the device's record
and the comparison's numbers.

A cell is ``workloads/<name>.json``; its ``config`` names
``configs/<config>.json``; its ``traffic.kind`` names the generator
``traffic/<kind>.py`` (a module with ``run(ctx) -> Outcome``); each
per-layer metric is ``metrics/<metric name>.py`` (a module with
``read(trace, cell) -> float | None``). The harness finds them by name, so
a cell, a configuration, a traffic mix or a metric is added as files.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import socket
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "endosr")

__all__ = ["HERE", "ROOT", "Cell", "load_cell", "load_module", "Outcome",
           "Check", "program_opt", "build_model", "Clock", "p95",
           "device_record", "forbidden_modules", "serve_numbers",
           "train_numbers", "strict_fp32", "launch_ranks"]


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Cell:
    """One workload with its configuration and the BENCHMARK.json entries
    that name it."""
    name: str
    spec: dict                     # workloads/<name>.json
    config: dict                   # configs/<config>.json
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def traffic(self) -> dict:
        return self.spec["traffic"]

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])

    @property
    def net(self) -> dict:
        """The network as the reference reads it."""
        g = self.config["network_G"]
        return {"scale": int(self.config["scale"]), "nb": int(g["nb"]),
                "depth_latent_ch": int(g["depth_latent_ch"]),
                "depth_masks": int(self.config["depthMaskNum"]),
                "which_ResBlk_depth": list(g["which_ResBlk_depth"])}


def _declared(bench: dict, name: str, kind: str) -> list:
    out = []
    for m in bench.get(kind, []):
        cells = m.get("workloads")
        if cells is None or name in cells:
            out.append(m)
    return out


def load_cell(name: str, root: Path = HERE, overrides: dict | None = None) -> Cell:
    """The cell ``name`` under ``root`` (the benchmark's folder), with its
    metrics from ``root/../BENCHMARK.json``; ``overrides`` replace keys of
    the configuration and the traffic (tests run tiny sizes with it)."""
    spec = _read(root / "workloads" / f"{name}.json")
    config = _read(root / "configs" / f"{spec['config']}.json")
    overrides = overrides or {}
    if overrides:
        spec, config = copy.deepcopy(spec), copy.deepcopy(config)
        config["network_G"].update(overrides.get("network_G", {}))
        spec["traffic"].update(overrides.get("traffic", {}))
    bench_file = root.parent / "BENCHMARK.json"
    bench = _read(bench_file) if bench_file.exists() else {}
    return Cell(name, spec, config, _declared(bench, name, "end_to_end"),
                _declared(bench, name, "per_layer"))


def load_module(kind: str, name: str, root: Path = HERE):
    """``root/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    mod_name = f"_bench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Check:
    """One number compared with its limit: correct while value ≤ limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a traffic generator hands back to the harness."""
    attempted: int
    failed: int
    metrics: dict                  # end-to-end name → value (untraced runs)
    checks: list                   # [Check]
    peak_bytes: int = 0
    trace: object = None           # tracing.Trace of a --trace 1 run
    errors: list = field(default_factory=list)
    notes: dict = field(default_factory=dict)      # printed to stderr


def program_opt(cell: Cell, train: bool) -> dict:
    """The program's options for this cell: the configuration's network
    and precision, its ``train:`` block when training, and the cell's own
    ``opt`` keys."""
    c = cell.config
    opt = {"is_train": train, "scale": int(c["scale"]),
           "model": "sftmd_depthCond",
           "precision": c["train_precision"] if train else c["serve_precision"],
           "datasets": {("train" if train else "test"): {
               "depthMaskNum": int(c["depthMaskNum"])}},
           "network_G": copy.deepcopy(c["network_G"]),
           "path": {"pretrain_model_G": None, "strict_load": True}}
    if train:
        opt["train"] = copy.deepcopy(c["train"])
    opt.update(copy.deepcopy(cell.spec.get("opt", {})))
    return opt


def build_model(cell: Cell, params: dict, train: bool, device, mesh=None):
    """The program's FModelDepthCond for the cell with ``params`` loaded
    (strict: every name and shape of the reference's spec)."""
    import torch

    from endosr_torch.models.f_depthcond import FModelDepthCond

    model = FModelDepthCond(program_opt(cell, train), device=device, mesh=mesh)
    with torch.no_grad():
        model.netG.load_state_dict(params, strict=True)
    return model


def strict_fp32():
    """fp32 means fp32: the configurations state TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, port, backend, args, queue):
    """One rank: the process group, the mesh, then ``fn``; what it returns
    goes back through ``queue`` as (rank, value)."""
    import torch
    import torch.distributed as dist

    from endosr_torch.parallel.mesh import make_mesh

    if backend == "nccl":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        extra = {"device_id": dev}
    else:
        dev, extra = torch.device("cpu"), {}
    strict_fp32()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, **extra)
    try:
        queue.put((rank, fn(rank, world, dev, make_mesh(dev), *args)))
    finally:
        dist.destroy_process_group()


def launch_ranks(fn, world: int, *args, backend: str = "nccl") -> list:
    """``fn(rank, world, device, mesh, *args)`` in ``world`` spawned
    processes, one a card (NCCL on ``localhost``; ``gloo`` on the CPU),
    each in its process group. Returns what each returned, by rank; every
    process has ended when it returns. Raises SystemExit naming the exit
    codes when a rank fails. On the card the kernel libraries are built
    here first: ranks that each built a missing library would write the
    same files at once."""
    import torch.multiprocessing as mp

    if backend == "nccl":
        from endosr_torch.kernels._build import build_all
        build_all()
    from queue import Empty

    spawn = mp.get_context("spawn")
    queue, port = spawn.Queue(), _free_port()
    procs = [spawn.Process(target=_rank_entry,
                           args=(fn, r, world, port, backend, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            if any(p.exitcode not in (None, 0) for p in procs) or (
                    not any(p.is_alive() for p in procs) and queue.empty()):
                break                  # a rank failed: the others may wait
            try:
                rank, value = queue.get(timeout=5)
            except Empty:              # look at the ranks again
                continue
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=120 if len(got) == world else 5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if len(got) < world or any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"a rank failed (exit codes "
                         f"{[p.exitcode for p in procs]})")
    return [got[r] for r in range(world)]


class Clock:
    """Host clock that waits for the device before it reads."""

    def __init__(self, device):
        import torch
        self.cuda = torch.device(device).type == "cuda"
        self._torch = torch

    def sync(self):
        if self.cuda:
            self._torch.cuda.synchronize()

    def now(self) -> float:
        self.sync()
        return time.perf_counter()


def p95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = 0.95 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def device_record(chips: int, peak_bytes: int) -> dict:
    """``device`` of the result line."""
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(peak_bytes)}
    try:
        rec["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        rec["power_limit"] = "not read"
    return rec


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, the
    whole name compared."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def serve_numbers(sr_list, ref_list) -> dict:
    """The serving comparison over sampled requests (lists of NHWC fp32
    tensors, program and reference): ``frame_nsr``, the worst frame's
    RMS error over its reference's RMS deviation from its mean, and
    ``max_abs``, the largest absolute error."""
    nsr, mabs = 0.0, 0.0
    for sr, ref in zip(sr_list, ref_list):
        if sr is None or tuple(sr.shape) != tuple(ref.shape):
            return {"frame_nsr": float("inf"), "max_abs": float("inf")}
        d = (sr.double() - ref.double()).flatten(1)
        r = ref.double().flatten(1)
        dev = (r - r.mean(dim=1, keepdim=True)).square().mean(dim=1).sqrt()
        err = d.square().mean(dim=1).sqrt()
        nsr = max(nsr, float((err / dev.clamp_min(1e-12)).max()))
        mabs = max(mabs, float(d.abs().max()))
    return {"frame_nsr": nsr, "max_abs": mabs}


def _gap(a: dict, b: dict, keep=None) -> float:
    """The worst leaf's |‖a‖ − ‖b‖| over max(‖b‖, the median leaf's ‖b‖)
    (``b`` is the reference); ``keep``: the leaves counted."""
    names = [k for k in b if keep is None or k in keep]
    med = statistics.median(b[k] for k in names)
    return max(abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training comparison from per-leaf norms and losses:
    ``loss_gap`` (the worst step's relative gap), ``grad_gap`` (first
    gradient, worst leaf), ``change_gap`` (the change over the checked
    steps, worst leaf of those whose reference gradient is at least a
    thousandth of the median leaf's)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or any(
            not math.isfinite(x) for x in prog["losses"]):
        losses = [float("inf")]
    g_med = statistics.median(ref["grad"].values())
    moved = {k for k, v in ref["grad"].items() if v >= 1e-3 * g_med}
    ref["left_out"] = sorted(set(ref["grad"]) - moved)
    return {"loss_gap": max(losses),
            "grad_gap": _gap(prog["grad"], ref["grad"]),
            "change_gap": _gap(prog["change"], ref["change"], moved)}
