"""Back-to-back training steps of the configuration's ``train:`` block.

Parameters (``traffic`` of the cell's file): ``batch`` images a step (the
global batch: on several cards each rank steps on its ``batch / world``
rows), ``lr_hw`` the LQ size (GT is ``scale`` times it), ``pool`` distinct
batches made in set-up and fed in turn, ``check_steps`` the first steps,
which the reference follows, ``trace_units`` steps in a traced run,
``rate_metric`` the name the images a second are reported under (default
``train_images_per_s``).

Batches are what the u8 loader hands over: pinned host tensors (uint8 LQ
and GT, fp32 depth, uint8 masks), fed through ``feed_data`` and stepped by
``optimize_parameters()``, which reads its losses back, so a step ends on
the host.

Set-up builds the model, drives it through the first ``check_steps``
steps with the window's own feed and call on distinct batches, and hands
the same object to the window. From those steps it keeps each step's
loss, every leaf's first gradient (Adam's first moment after one step over
1 − β1) and the leaves' change over the steps. Once the window has closed
and the model is freed, the plain reference (``reference.train``) takes
the same steps from the same weights on the same batches.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import Check, Clock, Outcome, build_model, train_numbers
from benchmark.inputs import frames, train_pairs
from benchmark.reference.train import TrainReference
from benchmark.tracing import profiled
from benchmark.weights import calibrate_output, make_params

SPANS = ("step.feed_data", "step.optimize_parameters")


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def setup(ctx):
    """(weights, the pool of global batches on the device)."""
    cell, dev, t = ctx.cell, ctx.device, ctx.cell.traffic
    k = int(cell.config["depthMaskNum"])
    params = make_params(cell.net, ctx.seed, dev)
    gen = torch.Generator(device=dev).manual_seed((ctx.seed + 1) % 2**63)
    calibrate_output(params, cell.net, *frames(gen, 1, (32, 32), k, dev))
    pool = [train_pairs(gen, int(t["batch"]), tuple(t["lr_hw"]),
                        int(cell.config["scale"]), k, dev)
            for _ in range(int(t["pool"]))]
    return params, pool


def _host_shard(batch, rank, world, pin):
    """This rank's rows of a global batch, as pinned host tensors."""
    n = batch["LQ"].shape[0] // world
    out = {}
    for key, v in batch.items():
        h = v[rank * n:(rank + 1) * n].cpu()
        out[key] = h.pin_memory() if pin else h
    return out


def step(model, batch, spans=False):
    if spans:
        with torch.profiler.record_function(SPANS[0]):
            model.feed_data(batch)
        with torch.profiler.record_function(SPANS[1]):
            return model.optimize_parameters()
    model.feed_data(batch)
    return model.optimize_parameters()


def first_steps(model, host, n):
    """The first ``n`` steps: (losses, first-gradient norms, change norms)."""
    named = list(model.named_train_parameters())
    start = {k: p.detach().clone() for k, p in named}
    beta1 = model.optimizer_G.param_groups[0]["betas"][0]
    losses, grad = [], None
    for j in range(n):
        losses.append(float(step(model, host[j % len(host)])["l_all"]))
        if j == 0:
            st = model.optimizer_G.state
            grad = _norms({k: st[p]["exp_avg"] / (1 - beta1)
                           for k, p in named})
    change = _norms({k: p.detach() - start[k] for k, p in named})
    return {"losses": losses, "grad": grad, "change": change}


def reference_steps(params, cell, pool, n):
    ref = TrainReference(params, cell.net, cell.config["train"])
    losses, grad = [], None
    for j in range(n):
        losses.append(ref.step(pool[j % len(pool)]))
        if j == 0:
            grad = _norms(ref.grads())
    change = _norms({k: v - (params[k[5:]] if k.startswith("netG.") else
                             torch.ones_like(v))
                     for k, v in ref.state().items()})
    return {"losses": losses, "grad": grad, "change": change}


def run(ctx):
    cell, t, dev = ctx.cell, ctx.cell.traffic, ctx.device
    clock = Clock(dev)
    params, pool = setup(ctx)
    host = [_host_shard(b, ctx.rank, ctx.world, clock.cuda) for b in pool]
    model = build_model(cell, params, train=True, device=dev, mesh=ctx.mesh)
    n_check = int(t["check_steps"])
    errors, failed = [], 0
    try:
        prog = first_steps(model, host, n_check)
    except RuntimeError as e:
        prog, failed = None, 1
        errors.append(repr(e))
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if ctx.world > 1:
        torch.distributed.barrier()
    images = int(t["batch"])

    def window(limit_units=None, deadline=None, spans=False):
        nonlocal failed
        i = 0
        while True:
            try:
                step(model, host[(n_check + i) % len(host)], spans)
            except RuntimeError as e:
                failed += 1
                errors.append(repr(e))
            i += 1
            if limit_units is not None and i >= limit_units:
                return i
            if deadline is not None and time.perf_counter() >= deadline:
                return i

    t0 = clock.now()
    setup_s = t0 - ctx.t_start
    trace = None
    if ctx.trace:
        n, trace = profiled(lambda: window(limit_units=int(t["trace_units"]),
                                           spans=True), SPANS, clock.sync)
        window_s = trace.window_s
        trace.units, trace.frames = n, n * images
    elif ctx.world > 1:
        # every rank stops after the same step: rank 0's clock decides
        n, stop = 0, torch.zeros(1, device=dev)
        while True:
            window(limit_units=1)
            n += 1
            if ctx.rank == 0:
                stop.fill_(float(time.perf_counter() >= t0 + ctx.seconds))
            torch.distributed.broadcast(stop, 0)
            if stop.item():
                break
        window_s = clock.now() - t0
    else:
        n = window(deadline=t0 + ctx.seconds)
        window_s = clock.now() - t0
    peak = torch.cuda.max_memory_allocated(dev) if clock.cuda else 0
    del model
    if clock.cuda:
        torch.cuda.empty_cache()
    rate = t.get("rate_metric", "train_images_per_s")
    metrics = {rate: (n - failed) * images / window_s,
               "peak_device_gib": peak / 2**30, "setup_s": setup_s}
    checks = []
    notes = {}
    if ctx.rank == 0:
        t_ref = time.perf_counter()
        ref = reference_steps(params, cell, pool, n_check)
        notes["reference_s"] = time.perf_counter() - t_ref
        nums = (train_numbers(prog, ref) if prog is not None else
                {k: float("inf") for k in cell.spec["limits"]})
        notes["leaves_left_out"] = ref.get("left_out", [])
        checks = [Check(k, nums[k], float(v))
                  for k, v in cell.spec["limits"].items()]
    return Outcome(attempted=n + n_check, failed=failed, metrics=metrics,
                   checks=checks, peak_bytes=peak, trace=trace,
                   errors=errors, notes=notes)
