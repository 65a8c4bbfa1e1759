"""Closed-loop serving: one client sends a request, waits for its SR, and
sends the next, for the whole window.

Parameters (``traffic`` of the cell's file): ``batch`` frames a request,
``lr_hw`` their size, ``pool`` distinct requests made in set-up and sent in
turn, ``warmup`` requests served before the window, ``sample`` requests
drawn from the seed among the first ``sample_within`` whose SR is kept for
the comparison (the window's last request is kept too), ``sample_frames``
frames of each drawn from the seed, ``trace_units`` requests in a traced
run, ``ref_block`` frames the reference runs at once. A kept SR is copied
to pinned host memory between two requests, outside both. The output conv
is calibrated (``weights.calibrate_output``) on one frame of the cell's own
``lr_hw``.

A request is handed over as host numpy arrays (LR frames, depth map,
depth-bin masks, fp32), as a data loader hands them: it runs from
``feed_data`` until ``torch.cuda.synchronize()`` returns after ``test()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import (Check, Clock, Outcome, build_model, p95,
                               serve_numbers)
from benchmark.inputs import frames
from benchmark.reference.depthnet import Numerics, forward
from benchmark.tracing import profiled
from benchmark.weights import calibrate_output, make_params

SPANS = ("request.feed_data", "request.test", "request.sync")


def setup(ctx):
    """(weights, the model, the pool of host requests, the generator)."""
    cell, dev, t = ctx.cell, ctx.device, ctx.cell.traffic
    k = int(cell.config["depthMaskNum"])
    params = make_params(cell.net, ctx.seed, dev)
    gen = torch.Generator(device=dev).manual_seed((ctx.seed + 1) % 2**63)
    calibrate_output(params, cell.net,
                     *frames(gen, 1, tuple(t["lr_hw"]), k, dev))
    model = build_model(cell, params, train=False, device=dev)
    pool = []
    for _ in range(int(t["pool"])):
        lq, dep, m = frames(gen, int(t["batch"]), tuple(t["lr_hw"]), k, dev)
        pool.append({"LQ": lq.cpu().numpy(), "Depth": dep.cpu().numpy(),
                     "DepthMaskList": m.cpu().numpy()})
    return params, model, pool


def serve(model, batch, clock, spans=False):
    """One request; returns (SR on the device, seconds)."""
    t0 = time.perf_counter()
    if spans:
        with torch.profiler.record_function(SPANS[0]):
            model.feed_data(batch)
        with torch.profiler.record_function(SPANS[1]):
            sr = model.test()
        with torch.profiler.record_function(SPANS[2]):
            clock.sync()
    else:
        model.feed_data(batch)
        sr = model.test()
        clock.sync()
    return sr, time.perf_counter() - t0


def reference_sr(params, cell, batch, device, block, numerics=None):
    """The plain fp32 reference's SR of a host request, on the host."""
    out = []
    n = batch["LQ"].shape[0]
    for i in range(0, n, block):
        x = [torch.from_numpy(batch[k][i:i + block]).to(device)
             for k in ("LQ", "Depth", "DepthMaskList")]
        with torch.no_grad():
            out.append(forward(params, cell.net, *x, numerics).cpu())
    return torch.cat(out)


def sample_ids(seed, t):
    """(sampled requests, sampled frames of each), drawn from the seed."""
    rng = np.random.default_rng(seed)
    within = min(int(t["sample_within"]), int(t["trace_units"]))
    ids = rng.choice(within, size=int(t["sample"]), replace=False)
    frames_ = rng.choice(int(t["batch"]), size=int(t["sample_frames"]),
                         replace=False)
    return sorted(ids.tolist()), sorted(frames_.tolist())


def _rows(batch, rows):
    return {k: np.ascontiguousarray(v[rows]) for k, v in batch.items()}


def run(ctx):
    cell, t, dev = ctx.cell, ctx.cell.traffic, ctx.device
    clock = Clock(dev)
    params, model, pool = setup(ctx)
    for i in range(int(t["warmup"])):
        sr, _ = serve(model, pool[i % len(pool)], clock)
    ids_, rows = sample_ids(ctx.seed, t)
    keep_ids = set(ids_)
    kept, lat, errors, failed = {}, [], [], 0
    batch = int(t["batch"])
    rows_dev = torch.tensor(rows, device=dev)
    # pinned buffers for the kept frames, made before the window
    shape = (len(rows), *sr.shape[1:])
    bufs = [torch.empty(shape, pin_memory=clock.cuda)
            for _ in range(len(keep_ids) + 1)]
    del sr
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def keep(i, sr):
        """Copy request i's sampled frames to a pinned host buffer."""
        if tuple(sr.shape) != (batch, *shape[1:]):   # a malformed answer
            kept[i] = None
            return
        part = sr.index_select(0, rows_dev)
        buf = bufs[len(kept)]
        buf.copy_(part, non_blocking=True)
        clock.sync()
        kept[i] = buf

    def window(limit_units=None, deadline=None, spans=False):
        nonlocal failed
        i, sr = 0, None
        while True:
            try:
                sr, dt = serve(model, pool[i % len(pool)], clock, spans)
                lat.append(dt)
                if i in keep_ids:
                    keep(i, sr)
            except RuntimeError as e:      # a request the program refused
                failed += 1
                errors.append(repr(e))
                sr = None
            i += 1
            if limit_units is not None and i >= limit_units:
                break
            if deadline is not None and time.perf_counter() >= deadline:
                break
        if sr is not None and (i - 1) not in kept:
            keep(i - 1, sr)
        return i

    t0 = clock.now()
    setup_s = t0 - ctx.t_start
    trace = None
    if ctx.trace:
        n, trace = profiled(lambda: window(limit_units=int(t["trace_units"]),
                                           spans=True), SPANS, clock.sync)
        window_s = trace.window_s
        trace.units, trace.frames = n, n * batch
    else:
        n = window(deadline=t0 + ctx.seconds)
        window_s = clock.now() - t0
    peak = torch.cuda.max_memory_allocated(dev) if clock.cuda else 0
    del model
    if clock.cuda:
        torch.cuda.empty_cache()
    done = n - failed
    metrics = {"sr_frames_per_s": done * batch / window_s,
               "request_ms_p95": p95(lat) * 1e3,
               "peak_device_gib": peak / 2**30,
               "setup_s": setup_s}
    ids = sorted(kept)
    limits = cell.spec["limits"]
    t_ref = time.perf_counter()
    nums = compare([kept[i] for i in ids], params, cell,
                   [_rows(pool[i % len(pool)], rows) for i in ids], dev,
                   limits)
    ref_s = time.perf_counter() - t_ref
    if not ids or not keep_ids <= set(ids):     # a sampled SR never came
        nums = {k: float("inf") for k in nums}
    checks = [Check(k, nums[k], float(limits[k])) for k in limits]
    return Outcome(attempted=n, failed=failed, metrics=metrics, checks=checks,
                   peak_bytes=peak, trace=trace, errors=errors,
                   notes={"reference_s": ref_s, "frames_compared":
                          len(ids) * len(rows), "request_ms": spread(lat)})


def spread(lat) -> dict:
    """How the window's request times spread, in ms: quantiles, the
    longest, and how many took over 1.5× the median (host stalls)."""
    if not lat:
        return {}
    ms = sorted(x * 1e3 for x in lat)
    med = ms[len(ms) // 2]
    return {"p50": med, "p90": ms[int(0.9 * (len(ms) - 1))],
            "p99": ms[int(0.99 * (len(ms) - 1))], "max": ms[-1],
            "over_1.5x_median": sum(x > 1.5 * med for x in ms)}


# numbers that measure the error in units of the stated precision's own:
# the RMS change that the plain reference shows under that rounding
UNITS = {
    # every SEAN's (γ, β) rounded to bf16 (bf16 maps in an fp32 net)
    "err_over_bf16_maps": lambda: Numerics("fp32", maps=torch.bfloat16),
    # every conv's and product's operands rounded to bf16
    "err_over_bf16_ref": lambda: Numerics("bf16"),
}


def compare(srs, params, cell, batches, device, limits) -> dict:
    """The numbers of ``limits`` for the SRs ``srs`` of host ``batches``:
    ``serve_numbers`` against the plain fp32 reference and each of
    ``UNITS`` that the limits name: the RMS error of all compared pixels
    over the RMS change that its rounding makes in the reference's SR of
    the same frames."""
    block = int(cell.traffic["ref_block"])
    refs = [reference_sr(params, cell, b, device, block) for b in batches]
    nums = serve_numbers(srs, refs)
    for name, numerics in UNITS.items():
        if name in limits:
            unit = [reference_sr(params, cell, b, device, block, numerics())
                    for b in batches]
            nums[name] = rms_ratio(srs, unit, refs)
    return {k: v for k, v in nums.items() if k in limits}


def rms_ratio(srs, units, refs) -> float:
    """RMS(sr − ref) ÷ RMS(unit − ref), over every pixel."""
    if any(s is None or tuple(s.shape) != tuple(r.shape)
           for s, r in zip(srs, refs)) or not refs:
        return float("inf")
    err = sum(float((s.double() - r.double()).square().sum())
              for s, r in zip(srs, refs))
    unit = sum(float((u.double() - r.double()).square().sum())
               for u, r in zip(units, refs))
    return (err / unit) ** 0.5 if unit > 0 else float("inf")


def control_numbers(ctx, numerics: str = "fp8"):
    """The comparison's numbers of the reference computed in ``numerics``
    put in the program's place, on this seed's pool and samples."""
    cell, t, dev = ctx.cell, ctx.cell.traffic, ctx.device
    params, model, pool = setup(ctx)
    del model
    ids, rows = sample_ids(ctx.seed, t)
    batches = [_rows(pool[i % len(pool)], rows) for i in ids]
    got = [reference_sr(params, cell, b, dev, int(t["ref_block"]),
                        Numerics(numerics)) for b in batches]
    return compare(got, params, cell, batches, dev, cell.spec["limits"])
