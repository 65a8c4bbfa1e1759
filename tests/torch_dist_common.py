"""Helpers of the CPU tests that run the port over ``torch.distributed``.

:func:`run_ranks` starts ``world`` processes as ``torchrun`` starts its
ranks (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` in their environment), each running one job of this
module (``python -m tests.torch_dist_common <job> <dir>``) on the CPU over
gloo with one torch thread: the job reads its inputs from ``<dir>``
(written by the parent with ``torch.save``) and writes what it returns to
``<dir>/out<rank>.pt``. The jobs import torch and the port only; the JAX
references are built in the parent and compared there.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parent.parent
JOBS = {}


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(name, world, payload, tmp_path, timeout=300):
    """Run job ``name`` on ``world`` gloo ranks with ``payload``; returns
    each rank's result, in rank order."""
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp_path / "payload.pt")
    port = _free_port()
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
               "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        log = open(tmp_path / f"log{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_common", name,
             str(tmp_path)], cwd=REPO_ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    failed = []
    for r, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append((r, rc))
    if failed:
        logs = "\n".join(f"--- rank {r} ({rc}):\n"
                         + (tmp_path / f"log{r}.txt").read_text()[-4000:]
                         for r, rc in failed)
        raise AssertionError(f"job {name} failed on ranks {failed}\n{logs}")
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def _tensors(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def _run_steps(model, batch, steps, grads_at=1):
    """``steps`` updates on ``batch``: the logs of each, the gradients of
    update ``grads_at`` and the parameters after each."""
    out = {"logs": [], "params": {}, "grads": None}
    model.feed_data(batch)
    for n in range(1, steps + 1):
        out["logs"].append(dict(model.optimize_parameters(n)))
        if n == grads_at:
            out["grads"] = {k: p.grad.clone()
                            for k, p in model.named_train_parameters()}
        out["params"][n] = {k: p.detach().clone()
                            for k, p in model.named_train_parameters()}
    return out


@job
def flagship_step(payload):
    """``FModelDepthCond`` steps from the given parameters on this rank's
    shard of the global batch; ``local_ratios``: the mask losses' ratios
    of this rank's sums only (the per-rank-mean version, a control)."""
    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.parallel.mesh import get_mesh, shard_batch

    if payload.get("local_ratios"):
        import endosr_torch.losses.mask as mask

        mask.global_sum = lambda x, mesh=None: x
    mesh = get_mesh()
    model = FModelDepthCond(payload["opt"], device="cpu")
    assert model.mesh is not None and model.mesh.size() == mesh.size()
    start = _tensors(payload["start"])
    with torch.no_grad():
        for name, p in model.named_train_parameters():
            p.copy_(start[name])
    return _run_steps(model, shard_batch(payload["batch"], mesh),
                      payload["steps"])


@job
def srgan_step(payload):
    """``SRGANModel`` steps (G and D) from the given networks on this
    rank's shard of the global batch: the logs and D's parameters and
    BatchNorm statistics after each step, G's parameters after each."""
    from endosr_torch.models.srgan_model import SRGANModel
    from endosr_torch.parallel.mesh import get_mesh, shard_batch

    model = SRGANModel(payload["opt"], device="cpu")
    model.netG.load_state_dict(payload["netG"])
    model.netD.load_state_dict(payload["netD"])
    model.feed_data(shard_batch(payload["batch"], get_mesh()))
    out = {"logs": [], "G": {}, "D": {}}
    for n in range(1, payload["steps"] + 1):
        out["logs"].append(dict(model.optimize_parameters(n)))
        out["G"][n] = {k: v.clone() for k, v in model.netG.state_dict().items()}
        out["D"][n] = {k: v.clone() for k, v in model.netD.state_dict().items()}
    return out


@job
def spatial_forward_job(payload):
    """``spatial_forward`` of a DepthNet (seeded) on whole inputs."""
    from endosr_torch.nn.depthnet import DepthNet
    from endosr_torch.parallel.spatial import spatial_forward

    net = DepthNet(**payload["net"])
    net.load_state_dict(payload["state"])
    net.eval()
    a = payload["inputs"]
    with torch.inference_mode():
        return {"sr": spatial_forward(net, None, a["lq"], a["dep"], a["mk"])}


@job
def spatial_serving(payload):
    """``FModelDepthCond.test`` with ``spatial_shard`` (every rank on the
    same batch); the guards' errors on this mesh."""
    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.parallel.spatial import shard_spatial, spatial_forward

    model = FModelDepthCond(payload["opt"], device="cpu")
    model.netG.load_state_dict(payload["state"])
    model.feed_data(payload["batch"])
    out = {"sr": model.test().clone()}
    errors = {}
    for name, call in (
            ("indivisible", lambda: shard_spatial((torch.zeros(1, 7, 8, 3),))),
            ("degenerate", lambda: shard_spatial((torch.zeros(1, 6, 8, 3),))),
            ("forward", lambda: spatial_forward(
                model.netG, None, *(torch.zeros(1, 6, 16, c)
                                    for c in (3, 1, 10))))):
        try:
            call()
        except (AssertionError, ValueError) as e:
            errors[name] = (type(e).__name__, str(e))
    out["errors"] = errors
    return out


@job
def spatial_unmasked_job(payload):
    """``spatial_forward`` (DepthNet's unmasked forward) of each net of
    the payload on whole inputs, and ``spatial_jit`` of the generic
    conv-minus-mean function; an error a case raises is returned as
    (type name, message)."""
    from endosr_torch.nn.depthnet import DepthNet
    from endosr_torch.nn.layers import conv2d_nhwc
    from endosr_torch.parallel.spatial import (spatial_forward, spatial_jit,
                                               whole_mean)

    out = {}
    for name, case in payload["cases"].items():
        kw = dict(case["net"])
        for k in ("dtype", "modulation_dtype"):
            if k in kw:
                kw[k] = getattr(torch, kw[k])
        net = DepthNet(**kw)
        net.load_state_dict(case["state"])
        net.eval()
        try:
            out[name] = spatial_forward(net, None, *case["inputs"])
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))

    def fn(w, x):
        y = conv2d_nhwc(x, w, 1)
        return y - whole_mean(y)

    jit = payload.get("jit")
    if jit is not None:
        out["jit"] = spatial_jit(fn, n_array_args=1, min_rows=2)(
            torch.as_tensor(jit["w"]), jit["x"])
    return out


@job
def sr_pipeline_spatial(payload):
    """``tools/sr_pipeline.py --spatial`` on each argv of the payload, this
    rank writing under ``<output>/rank<r>``; returns what each run
    returned."""
    import torch.distributed as dist

    from endosr_torch.tools import sr_pipeline

    r = dist.get_rank()
    return [sr_pipeline.main(argv + ["--spatial", "--device", "cpu",
                                     "--output", f"{out}/rank{r}"])
            for argv, out in payload["runs"]]


@job
def traced_step(payload):
    """One ``FModelDepthCond`` step on this rank's shard under
    ``torch.profiler``: the names of the spans it opened, in start order."""
    from torch.profiler import ProfilerActivity, profile

    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.parallel.mesh import get_mesh, shard_batch

    model = FModelDepthCond(payload["opt"], device="cpu")
    model.feed_data(shard_batch(payload["batch"], get_mesh()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.optimize_parameters(1)
    return [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                     key=lambda e: e.start_ns())
            if e.is_user_annotation()]


def main(argv):
    import torch.distributed as dist

    from endosr_torch.parallel.mesh import maybe_init_distributed

    name, where = argv
    torch.set_num_threads(1)
    maybe_init_distributed()
    payload = torch.load(Path(where) / "payload.pt", weights_only=False)
    out = JOBS[name](payload)
    torch.save(out, Path(where) / f"out{dist.get_rank()}.pt")
    dist.barrier()          # no rank leaves while another still talks to it
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
