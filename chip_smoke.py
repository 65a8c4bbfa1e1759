#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``endosr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Takes no arguments and runs every phase (any failure raises and the script
exits non-zero):

1. device — the card's name and power limit; TF32 off for fp32 checks.
2. build — every kernel under ``endosr_torch/csrc`` with one ``nvcc`` per
   source, all started together, into ``build/endosr_torch/``; ``ptxas``'s
   registers, spills and static shared memory of every kernel are logged,
   those of the ``wgmma`` conv (in ``head_dot``, ``fused_tail`` and
   ``packed_chain``), ``fused_mod_wgmma``, ``style_dot_tc`` and
   ``style_blend_tc`` on lines of their own.
3. kernels — each of the twelve kernels against its plain PyTorch version
   at the shapes the full-width forwards give it, in bf16 (max|Δ|/max|ref|
   ≤ 1e-2) and fp32 (≤ 1e-5 against float64); ``in_stats`` ≤ 1e-5 against
   float64 sums in both; ``output_stage_x8`` (the ×8 HBWC and the ×4 BHWC
   shape), ``output_stage`` (r = 2, 3, 4) and ``mid_shuffle`` (forward,
   and its backward against the plain un-shuffle and ``torch.autograd`` of
   the plain version) must be bit-identical; ``fused_o_branch`` and
   ``fused_modulation`` are also checked on their ``wgmma`` route at B = 2,
   13×21, N = 3, 2C = 128, K = 10 (tiles cut by both edges), at 2C = 64
   (40×70) and with a large positive ``bm`` (a ``relu(bm)`` padding ring
   would show), and on the ``mma`` route at a ragged small shape (2C = 32,
   K = 4), ``head_dot`` and ``fused_tail`` at
   B = 3, 13×21 of 24 columns, C4 = 128 with and without ``pre_bias``,
   ``style_dot_hwbm`` at B = 2, 13×21, M = 264, ``style_blend_dot`` at
   B = 2, 13×21, c2 = 24, M = 264, and ``packed_g123`` at B = 3 on an
   up1-like x [13, 21, 3, 256] and a tail-like packed [8, 12, 3, 512]
   (9.0 and −9.0 planted in its dead row and column). ``fused_tail`` gets
   the raw g4 with its ``pre_bias``, as the ``pallas_tail`` path calls it.
   In bf16 the routed kernels take their fast routes (``head_dot``,
   ``fused_tail``, ``packed_g123``, ``fused_o_branch`` and
   ``fused_modulation``: ``wgmma``; ``style_dot_hwbm`` and
   ``style_blend_dot``: ``tc``), which sum in another order than the plain
   versions (16-deep ``mma`` steps, 64-channel slices outermost), hence the
   same 1e-2 as every bf16 kernel; in fp32 they take the exact CUDA-core
   routes; ``mid_shuffle`` takes ``vec16`` in both types. The route each
   took is asserted, and the earlier route of each
   (``head_dot.launch_igemm``, ``fused_tail.launch_igemm``,
   ``packed_chain.launch_igemm``, ``launch_cuda_core``,
   ``launch_blend_cuda_core``, the ``scalar`` shuffle, the ``launch_mma``
   of ``fused_o_branch`` and ``fused_modulation``) is timed beside it
   as ``previous_ms``. ``in_stats`` and ``fused_in_mod`` take route
   ``vec16`` at [8,128,128,64] in both types (``in_stats`` also on a
   channel slice of a [8,128,128,256] map), are held bit-equal over two
   calls, launch 1 and 2 device kernels a call (``torch.profiler``) and
   leave the ticket counters at 0 after B = 8 and then B = 3; their ``v1``
   route is ``previous_ms`` and takes a ragged case (C = 24, 13×21, every
   base one element past 16 bytes). Times: ``output_stage_x8``,
   ``output_stage``, ``in_stats``, ``fused_in_mod`` and ``mid_shuffle``
   (kernel, plain, library, previous) are device time, a CUDA graph of
   ≥ 20 launches over ≥ 3 input sets of ≥ 100 MB in all, in turn (so each
   launch finds its inputs out of the 50 MB L2) replayed between two events
   and divided by the launches, median of 5 replays (``graph_ms``), the kernel also
   once a call as ``call_ms``; the other kernels are CUDA-event medians
   of 20 single calls (5 for a call above 20 ms), ``call_ms`` = ``ms``. Beside
   them: the plain version's time, the
   bound (larger of bytes over 3.35 TB/s and operations over the bf16
   tensor-core peak), and one PyTorch call computing the same function
   where there is one.
4. small forwards — reduced DepthNets through the kernels in fp32 against
   the same weights on the CPU (plain versions), ≤ 2e-4 max abs: ×8, ×2,
   ×3, ×4, ×4 with the fused epilogue, ×8 with ``valid_hw`` on a
   zero-padded odd-sized input, and ×8 with ``pallas_obranch``,
   ``fused_modulation``, ``pallas_tail``, the dense tail
   (``packed_tail: false``), and ``preset: plain`` (also ×4 with a depth
   block at nb-1).
5. serving, seven full-width paths through ``FModelDepthCond`` (seeded
   weights, batch 8, bf16), the launch counts set to 0 before each and read
   after it; every output finite, of the right shape, in [0,1]; bf16 vs
   fp32 PSNR ≥ 40 dB on the same weights:
   - ×8 flagship, unbucketed, LQ 128² → SR 1024²: ``packed_g123`` 2
     (bf16: route ``wgmma`` on every ×8 path that runs it; fp32: ``fp32``),
     ``style_blend_dot`` 2 (bf16: route ``tc``; the fp32 request:
     ``cuda_core``), ``head_dot`` 1 (bf16: ``wgmma``; fp32: ``fp32``),
     ``output_stage_x8`` 1 per forward; the fp32 output equals that of
     ``preset: plain`` to ≤ 2e-4, and so does that of each of the next three;
   - the same with ``net_kw: {pallas_obranch: true}`` (hoisted trunk):
     ``fused_o_branch`` 1 (bf16: route ``wgmma``; fp32: ``fp32``),
     ``style_blend_dot`` 0, the tail as above;
   - with ``net_kw: {fused_modulation: true}``: ``fused_modulation`` 1
     (bf16: ``wgmma``; fp32: ``fp32``), ``style_blend_dot`` 0, the tail as
     above;
   - with ``net_kw: {pallas_tail: true}`` (lazy trunk): ``style_blend_dot``
     2 (``tc``), ``packed_g123`` 2, ``fused_tail`` 1 (``wgmma``; fp32:
     ``fp32``), ``head_dot`` 0, ``output_stage_x8`` 0;
   - ``preset: plain``: no kernel launch at all;
   - ×8 flagship with ``eval_bucket_multiple`` unset (bucket 32), LQ
     120×112 → SR 960×896 through the masked forward: ``style_dot_hwbm`` 2
     (bf16: route ``tc``; fp32: ``cuda_core``), ``output_stage`` 1, none of
     the packed kernels; the fp32 output equals the fp32 unbucketed output of
     the same request to ≤ 1e-4;
   - ×4 flagship with ``net_kw: {fused_epilogue: true, in_stats:
     kernel}``, LQ 128²
     → SR 512²: ``fused_in_mod`` 26, ``in_stats`` 26 (both route ``vec16``
     in both types), ``style_blend_dot`` 2 (``tc``), ``output_stage_x8`` 1;
     the fp32 output equals that of the chained
     epilogue (``fused_epilogue: false``) to ≤ 2e-4.

Prints the kernels JSON line (``launches`` summed over the paths,
``timing`` "graph" or "call";
``mid_shuffle`` is a kernel no forward calls, in the JAX package as here, so
its count is 0 and it is held to its plain version in phase 3 only), then the ``nvidia-smi`` name/power line, then ``{"ok": true, "device":
{...}}`` as the last line. Exits non-zero without a result when no CUDA
device is present or when run outside the repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BPS = 3.35e12       # H100 SXM device memory rate
BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
N_TIMED = 20


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, n=N_TIMED):
    """Median CUDA-event time of ``fn()`` over ``n`` runs, after warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.02:
        n = min(n, 5)
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


N_GRAPH = 20           # launches a timing graph holds at least
ROTATE_BYTES = 100e6   # input sets a timing graph rotates over hold this


def graph_ms(fn, sets, k_min=N_GRAPH):
    """Device ms of one call of ``fn``: a CUDA graph of K ≥ ``k_min`` calls
    ``fn(*inputs)`` with ``inputs`` running over ``sets`` in turn (so a call
    finds its inputs out of the L2 cache), replayed between two events and
    divided by K; the median of 5 replays after one warm-up replay. A
    capture that fails raises."""
    import torch

    k = -(-k_min // len(sets)) * len(sets)
    for inputs in sets:                 # warm-up, outside the capture
        fn(*inputs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(k):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    del graph
    times.sort()
    return times[len(times) // 2]


def rotation(first, more):
    """Input sets for :func:`graph_ms`: ``first`` and calls of ``more()``
    until their tensors' elements (:func:`nbytes`: a channel slice counts
    its own elements, not the bytes of the map it spans) hold
    ``ROTATE_BYTES``, at least three sets, so no set is still in the L2
    when its turn comes again."""
    sets = [first]
    while len(sets) < 3 or sum(nbytes(*s) for s in sets) < ROTATE_BYTES:
        sets.append(more())
    return sets


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(bytes_, flops):
    tb, tf = bytes_ / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(got, ref):
    """(max |Δ|, max |Δ| / max |ref|) of a tensor or a tuple of tensors
    (the worst of its members)."""
    if isinstance(got, tuple):
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
    got, ref = got.double(), ref.double()
    return (float((got - ref).abs().max()),
            float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)))


class KernelCase:
    """One kernel at one shape: its call, plain call, library call and the
    bytes/operations of the work. ``main``: its times enter the JSON row
    (the shapes of the first full-width path that runs the kernel); other
    shapes are checked and logged only. ``exact``: must equal the plain
    version bit for bit. ``ref64``: the float64 reference where the plain
    version cannot be fed float64. ``tol``: overrides the per-dtype
    tolerance. ``extra``: a further check of the case, run once per type.
    ``previous``: the kernel's earlier route on the same inputs, timed in
    bf16. ``route``: (wrapper, {dtype: route name}), the route the call must
    take. ``timed=False``: checked only. ``rotate``: (the case's own input
    set, a function making one more), where the call, plain, library and
    previous functions take an input set as positional arguments in place
    of their defaults; such a case is timed by :func:`graph_ms` over a
    :func:`rotation` of input sets (and once a call, as ``call_ms``)."""

    def __init__(self, name, kernel, plain, library, bytes_, flops, main=True,
                 exact=False, ref64=None, tol=None, extra=None, previous=None,
                 route=None, timed=True, rotate=None):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.library, self.bytes, self.flops = library, bytes_, flops
        self.main, self.exact, self.ref64, self.tol = main, exact, ref64, tol
        self.extra, self.previous, self.route = extra, previous, route
        self.timed, self.rotate = timed, rotate


def make_cases(torch, dt, gen):
    """The twelve kernels at the shapes the full-width forwards give them
    (B=8, LR 128; packed_g123, style_blend_dot and style_dot_hwbm twice)."""
    import torch.nn.functional as F

    from endosr_torch.kernels.fused_in_mod import (fused_in_mod,
                                                   fused_in_mod_plain)
    from endosr_torch.kernels.fused_in_mod import launch as in_mod_launch
    from endosr_torch.kernels.fused_mod import (fused_modulation,
                                                fused_modulation_plain)
    from endosr_torch.kernels.fused_mod import launch_mma as mod_mma
    from endosr_torch.kernels.fused_obranch import (fused_o_branch,
                                                    fused_o_branch_plain,
                                                    grouped_w2)
    from endosr_torch.kernels.fused_obranch import launch_mma as obranch_mma
    from endosr_torch.kernels.fused_tail import fused_tail, fused_tail_plain
    from endosr_torch.kernels.fused_tail import launch_igemm as tail_igemm
    from endosr_torch.kernels.head_dot import (head_dot, head_dot_plain,
                                               launch_igemm)
    from endosr_torch.kernels.in_stats import in_stats, in_stats_plain
    from endosr_torch.kernels.in_stats import launch as stats_launch
    from endosr_torch.kernels.output_stage import (output_stage,
                                                   output_stage_plain,
                                                   output_stage_x8,
                                                   output_stage_x8_plain)
    from endosr_torch.kernels.packed_chain import launch_igemm as packed_igemm
    from endosr_torch.kernels.packed_chain import packed_g123, packed_g123_plain
    from endosr_torch.kernels.shuffle_mid import launch as shuffle_launch
    from endosr_torch.kernels.shuffle_mid import (mid_shuffle,
                                                  mid_shuffle_plain,
                                                  mid_unshuffle_plain)
    from endosr_torch.kernels.style_dot import (launch_blend_cuda_core,
                                                launch_cuda_core,
                                                style_blend_dot,
                                                style_blend_plain,
                                                style_dot_hwbm, style_dot_plain)

    dev = "cuda"

    def rn(*shape, s=1.0, mean=0.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * s
                + mean).to(dtype)

    B = 8
    cases = {}

    # output_stage_x8: the ×8 forward's pre64 [256, 8, 256, 64] HBWC (the
    # JSON row) and the ×4 unmasked forward's [8, 128, 128, 64] BHWC
    xcs = []
    for label, shape, order, main in (("x8 hbwc", (256, B, 256, 64), "hbwc", True),
                                      ("x4 bhwc", (B, 128, 128, 64), "bhwc", False)):
        pre64 = rn(*shape, s=0.6, mean=0.5)
        xcs.append(KernelCase(
            f"output_stage_x8[{label}]",
            lambda p=pre64, o=order: output_stage_x8(p, 0.0, 1.0, o),
            lambda p=pre64, o=order: output_stage_x8_plain(p, 0.0, 1.0, o),
            None, nbytes(pre64) + pre64.numel() // 64 * 48 * 4, 0, main=main,
            exact=True,
            rotate=((pre64,), lambda s=shape: (rn(*s, s=0.6, mean=0.5),))))
    cases["output_stage_x8"] = xcs

    # output_stage: the bucketed ×8 forward's [8,256,256,48] r=4 (main path),
    # and the ×4 / ×2 / ×3 tails' shapes
    ocs = []
    for label, hw, r, main in (("x8 r=4", 256, 4, True), ("x4 r=4", 128, 4, False),
                               ("x2 r=2", 128, 2, False), ("x3 r=3", 128, 3, False)):
        pre = rn(B, hw, hw, 3 * r * r, s=0.6, mean=0.5)
        ocs.append(KernelCase(
            f"output_stage[{label}]",
            lambda p=pre, r=r: output_stage(p, r, 0.0, 1.0),
            lambda p=pre, r=r: output_stage_plain(p, r, 0.0, 1.0),
            None, nbytes(pre) + B * hw * hw * 3 * r * r * 4, 0, main=main,
            exact=True,
            rotate=((pre,), lambda s=pre.shape: (rn(*s, s=0.6, mean=0.5),))))
    cases["output_stage"] = ocs

    # in_stats and fused_in_mod: one trunk activation [8,128,128,64]; γ and β
    # are channel slices of a group's [8,128,128,M] map, as on the main path;
    # route vec16 in both types (on x and on a channel slice), v1 (forced)
    # timed as previous; a ragged case (C = 24, 13×21 pixels, every base one
    # element past 16 bytes) on v1
    def trunk_x():
        return rn(B, 128, 128, 64, s=1.5, mean=0.5)

    def in_mod_inputs():
        gb = rn(B, 128, 128, 256, s=0.3)
        return trunk_x(), gb[..., 64:128], gb[..., 128:192]

    def ragged(*shape):
        return rn(*shape[:-1], shape[-1] + 1, s=1.5, mean=0.5)[..., 1:]

    def sums64(x):
        return x.double().sum(dim=(1, 2)), x.double().square().sum(dim=(1, 2))

    def in_mod_64(x, g, b):
        x, g, b = x.double(), g.double(), b.double()
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * (1.0 + g) + b

    xs, gam, bet = in_mod_inputs()
    vec16 = {torch.bfloat16: "vec16", torch.float32: "vec16"}
    v1 = {torch.bfloat16: "v1", torch.float32: "v1"}
    xr = ragged(3, 13, 21, 24)
    cases["in_stats"] = [
        KernelCase(
            "in_stats", lambda x=xs: in_stats(x), lambda x=xs: in_stats_plain(x),
            lambda x=xs: torch.var_mean(x.float(), dim=(1, 2)),
            nbytes(xs) + 2 * B * 64 * 4, 3 * xs.numel(),
            ref64=lambda x=xs: sums64(x), tol=1e-5, route=(in_stats, vec16),
            previous=lambda x=xs: stats_launch(x, "v1")[0],
            extra=lambda x=xs: vec16_checks(
                torch, dt, "in_stats", lambda: in_stats(x),
                lambda: stats_launch(x[:3])[1], 1),
            rotate=((xs,), lambda: (trunk_x(),))),
        KernelCase(
            "in_stats[channel slice]",
            lambda x=gam: in_stats(x), lambda x=gam: in_stats_plain(x), None,
            nbytes(xs) + 2 * B * 64 * 4, 3 * xs.numel(), main=False,
            ref64=lambda x=gam: sums64(x), tol=1e-5, route=(in_stats, vec16),
            rotate=((gam,), lambda: in_mod_inputs()[1:2])),
        KernelCase(
            "in_stats[ragged 13×21, C=24, unaligned]",
            lambda x=xr: in_stats(x), lambda x=xr: in_stats_plain(x), None,
            0, 0, main=False, timed=False, ref64=lambda x=xr: sums64(x),
            tol=1e-5, route=(in_stats, v1))]
    rg = tuple(ragged(3, 13, 21, 24) for _ in range(3))
    cases["fused_in_mod"] = [
        KernelCase(
            "fused_in_mod", lambda x=xs, g=gam, b=bet: fused_in_mod(x, g, b),
            lambda x=xs, g=gam, b=bet: fused_in_mod_plain(x, g, b), None,
            4 * nbytes(xs), 8 * xs.numel(),
            ref64=lambda x=xs, g=gam, b=bet: in_mod_64(x, g, b),
            route=(fused_in_mod, vec16),
            previous=lambda x=xs, g=gam, b=bet: in_mod_launch(x, g, b,
                                                              route="v1")[0],
            extra=lambda x=xs, g=gam, b=bet: vec16_checks(
                torch, dt, "fused_in_mod", lambda: fused_in_mod(x, g, b),
                lambda: in_mod_launch(x[:3], g[:3], b[:3])[1], 2),
            rotate=((xs, gam, bet), in_mod_inputs)),
        KernelCase(
            "fused_in_mod[ragged 13×21, C=24, unaligned]",
            lambda a=rg: fused_in_mod(*a), lambda a=rg: fused_in_mod_plain(*a),
            None, 0, 0, main=False, timed=False,
            ref64=lambda a=rg: in_mod_64(*a), route=(fused_in_mod, v1))]

    # head_dot: g4 [257, 257, 8, 512] (HWNC view of the producer's BHWC)
    g4 = rn(B, 257, 257, 512, s=0.5).permute(1, 2, 0, 3)
    w64 = rn(3, 3, 512, 64, s=0.02)
    b64 = rn(64, s=0.1, dtype=torch.float32)
    pb = rn(512, s=0.1)
    # yardstick: one cuDNN conv over the already-activated NCHW input
    g4_act = F.leaky_relu(g4.permute(2, 3, 0, 1) + pb[None, :, None, None], 0.2)
    w64_oihw = w64.permute(3, 2, 0, 1).contiguous()

    def head_lib():
        return F.conv2d(g4_act, w64_oihw, padding=1)
    head_route = (head_dot, {torch.bfloat16: "wgmma", torch.float32: "fp32"})
    cases["head_dot"] = [KernelCase(
        "head_dot",
        lambda: head_dot(g4, w64, b64, 256, pb),
        lambda g=g4, w=w64, b=b64, p=pb: head_dot_plain(g, w, b, 256, p),
        head_lib,
        nbytes(g4, w64, b64, pb) + 256 * B * 256 * 64 * g4.element_size(),
        2 * B * 256 * 256 * 9 * 512 * 64,
        previous=lambda: launch_igemm(g4, w64, b64, 256, pb),
        route=head_route)]
    # ragged: tiles cut by both edges, dead columns in memory, two slices
    for label, with_pb in (("pre_bias", True), ("raw", False)):
        rg4 = rn(3, 14, 24, 128, s=0.5).permute(1, 2, 0, 3)
        rw, rb = rn(3, 3, 128, 64, s=0.03), rn(64, s=0.1, dtype=torch.float32)
        rpb = rn(128, s=0.1) if with_pb else None
        cases["head_dot"].append(KernelCase(
            f"head_dot[ragged 13×21 of 24, C4=128, {label}]",
            lambda a=(rg4, rw, rb, 21, rpb): head_dot(*a),
            lambda g=rg4, w=rw, b=rb, p=rpb: head_dot_plain(g, w, b, 21, p),
            None, 0, 0, main=False, route=head_route, timed=False))

    # packed_g123: up1 chain (x [128,128,8,256], pre_act) and tail chain
    # (packed producer [129,129,8,512], phases + pre_act + pre_bias); and
    # ragged ones at B = 3 (odd extents under one column tile, two and four
    # 64-channel slices), the tail-like one with data planted in the dead
    # packed row and column, which the interleave drops
    pcs = []
    packed_route = (packed_g123, {torch.bfloat16: "wgmma",
                                  torch.float32: "fp32"})
    for label, xshape, cin4, phases, main in (
            ("up1", (B, 128, 128, 256), 256, False, True),
            ("tail", (B, 129, 129, 512), 128, True, True),
            ("ragged up1-like 13×21, B=3", (3, 13, 21, 256), 256, False, False),
            ("ragged tail-like 8×12 packed, B=3", (3, 8, 12, 512), 128, True,
             False)):
        x = rn(*xshape, s=0.5)
        if phases and not main:
            x[:, -1] = 9.0
            x[:, :, -1] = -9.0
        x = x.permute(1, 2, 0, 3)
        k1 = rn(2, 2, cin4, 128, s=1.0 / math.sqrt(4 * cin4))
        k2 = rn(2, 2, 128, 128, s=1.0 / math.sqrt(512))
        k3 = rn(2, 2, 128, 128, s=1.0 / math.sqrt(512))
        b1, b2, b3 = (rn(128, s=0.1) for _ in range(3))
        pbias = rn(cin4, s=0.1) if phases else None
        bb, hh, ww = xshape[:3]
        n, m = ((2 * (hh - 1) + 1, 2 * (ww - 1) + 1) if phases
                else (hh + 1, ww + 1))
        args = (x, k1, b1, k2, b2, k3, b3)
        kw = dict(pre_act=True, pre_bias=pbias, phases=phases)
        flops = 2 * bb * n * m * 4 * (cin4 * 128 + 2 * 128 * 128)
        pcs.append(KernelCase(
            f"packed_g123[{label}]",
            lambda a=args, k=kw: packed_g123(*a, **k),
            lambda a=args, k=kw: packed_g123_plain(*a, **k),
            None,
            nbytes(x, k1, k2, k3, b1, b2, b3,
                   *([pbias] if pbias is not None else []))
            + n * m * bb * 128 * x.element_size(),
            flops, main=main, timed=main, route=packed_route,
            previous=lambda a=args, k=kw: packed_igemm(*a, **k)))
    cases["packed_g123"] = pcs

    # style_blend_dot: the 7- and 6-block groups (M = 1792 / 1536)
    scs = []
    masks = (torch.rand((B, 128, 128, 90), generator=gen, device=dev)
             > 0.8).to(dt)
    blend_route = (style_blend_dot, {torch.bfloat16: "tc",
                                     torch.float32: "cuda_core"})
    for nblk in (7, 6):
        m = nblk * 2 * 128
        v = rn(B, 90, m, s=0.05)
        convs = tuple(rn(B, 128, 128, 128, s=0.3).permute(1, 2, 0, 3)
                      for _ in range(2 * nblk))
        bias = rn(m, s=0.1, dtype=torch.float32)
        cat = torch.cat([c.permute(2, 0, 1, 3) for c in convs], dim=-1)
        cat = cat.reshape(B, 128 * 128, m)
        sflat = masks.reshape(B, 128 * 128, 90)
        bias_dt = bias.to(dt)
        scs.append(KernelCase(
            f"style_blend_dot[M={m}]",
            lambda s=masks, vv=v, c=convs, b=bias: style_blend_dot(s, vv, c, b),
            lambda s=masks, vv=v, c=convs, b=bias: style_blend_plain(s, vv, c, b),
            lambda c=cat, s=sflat, vv=v, b=bias_dt:
                torch.baddbmm(c, s, vv).add_(b),
            nbytes(masks, v, bias, *convs) + 128 * 128 * B * m * masks.element_size(),
            2 * B * 128 * 128 * 90 * m,
            previous=lambda s=masks, vv=v, c=convs, b=bias:
                launch_blend_cuda_core(s, vv, c, b),
            route=blend_route))
    # ragged: 13×21 (a last pixel tile of 17 rows), c2 = 24 (a 128-channel
    # tile spans six convs), M = 264 (the third tile cut to 8 channels)
    rsh = (torch.rand((2, 13, 21, 90), generator=gen, device=dev) > 0.7).to(dt)
    rv, rb = rn(2, 90, 264, s=0.05), rn(264, s=0.1, dtype=torch.float32)
    rconvs = tuple(rn(2, 13, 21, 24, s=0.3).permute(1, 2, 0, 3)
                   for _ in range(11))
    scs.append(KernelCase(
        "style_blend_dot[ragged 13×21, c2=24, M=264]",
        lambda s=rsh, vv=rv, c=rconvs, b=rb: style_blend_dot(s, vv, c, b),
        lambda s=rsh, vv=rv, c=rconvs, b=rb: style_blend_plain(s, vv, c, b),
        None, 0, 0, main=False, route=blend_route, timed=False))
    cases["style_blend_dot"] = scs

    # style_dot_hwbm: the same two groups on the masked path
    hcs = []
    style_route = (style_dot_hwbm, {torch.bfloat16: "tc",
                                    torch.float32: "cuda_core"})
    for nblk in (7, 6):
        m = nblk * 2 * 128
        v = rn(B, 90, m, s=0.05)
        sflat = masks.reshape(B, 128 * 128, 90)
        hcs.append(KernelCase(
            f"style_dot_hwbm[M={m}]",
            lambda s=masks, vv=v: style_dot_hwbm(s, vv),
            lambda s=masks, vv=v: style_dot_plain(s, vv),
            lambda s=sflat, vv=v: torch.bmm(s, vv),
            nbytes(masks, v) + 128 * 128 * B * m * masks.element_size(),
            2 * B * 128 * 128 * 90 * m,
            previous=lambda s=masks, vv=v: launch_cuda_core(s, vv),
            route=style_route))
    # ragged: a last pixel tile of 17 rows, an image base that is no multiple
    # of 16 bytes, the third N tile cut to 8 channels; dense values
    rsh, rv = rn(2, 13, 21, 90, s=0.5), rn(2, 90, 264, s=0.05)
    hcs.append(KernelCase(
        "style_dot_hwbm[ragged 13×21, M=264]",
        lambda s=rsh, vv=rv: style_dot_hwbm(s, vv),
        lambda s=rsh, vv=rv: style_dot_plain(s, vv),
        None, 0, 0, main=False, route=style_route, timed=False))
    cases["style_dot_hwbm"] = hcs

    # fused_o_branch and fused_modulation: the 13 trunk blocks' 26 SEANs on
    # one depth map [8,128,128,1] (hoist_chunk 0), K = 10 bins; checked
    # only: the wgmma route on tiles cut by both edges (B = 2, 13×21, N = 3,
    # 2C = 128), at 2C = 64 (40×70: a cut row tile and column tile), with a
    # large positive bm (a relu(bm) padding ring would show), and the mma
    # route at a ragged small shape (2C = 32, K = 4)
    ocs, mcs = [], []
    wg_routes = {torch.float32: "fp32", torch.bfloat16: "wgmma"}
    for label, (nb_, hh, ww), N, C2, K, bm_mean, want, main in (
            ("", (B, 128, 128), 26, 128, 10, 0.0, "wgmma", True),
            ("[ragged 13×21, 2C=128]", (2, 13, 21), 3, 128, 10, 0.0, "wgmma", False),
            ("[40×70, 2C=64]", (2, 40, 70), 5, 64, 10, 0.0, "wgmma", False),
            ("[large bm]", (1, 20, 30), 2, 128, 10, 5.0, "wgmma", False),
            ("[ragged 13×21]", (2, 13, 21), 3, 32, 4, 0.0, "mma", False)):
        d = torch.rand((nb_, hh, ww, 1), generator=gen, device=dev).to(dt)
        wm = rn(N, 9, C2, s=0.3)
        bm = (rn(N, C2, s=0.1).abs() + bm_mean).to(dt) if bm_mean else rn(N, C2, s=0.1)
        w2 = rn(N, 9, C2, C2, s=1.0 / math.sqrt(9 * C2))
        b2 = rn(N, C2, s=0.1)
        out_bytes = nb_ * hh * ww * N * C2 * d.element_size()
        wm_oihw = wm.permute(0, 2, 1).reshape(N * C2, 1, 3, 3).contiguous()
        w2_oihw = grouped_w2(w2, N, C2).contiguous()
        d_nchw = d.permute(0, 3, 1, 2)
        routes = {**wg_routes, torch.bfloat16: want}

        def obranch_lib(d_nchw=d_nchw, wm_oihw=wm_oihw, bm=bm, w2_oihw=w2_oihw,
                        b2=b2, N=N):
            a = F.relu(F.conv2d(d_nchw, wm_oihw, bm.reshape(-1), padding=1))
            return F.conv2d(a, w2_oihw, b2.reshape(-1), padding=1, groups=N)
        ocs.append(KernelCase(
            "fused_o_branch" + label,
            lambda a=(d, wm, bm, w2, b2): fused_o_branch(*a),
            lambda a=(d, wm, bm, w2, b2): fused_o_branch_plain(*a),
            obranch_lib, nbytes(d, wm, bm, w2, b2) + out_bytes,
            2 * nb_ * hh * ww * N * (9 * C2 + 9 * C2 * C2), main=main,
            route=(fused_o_branch, routes), timed=main,
            previous=(lambda a=(d, wm, bm, w2, b2): obranch_mma(*a)) if main else None))
        dmask = (torch.rand((nb_, hh, ww, K), generator=gen, device=dev)
                 > 0.8).to(dt)
        vmod = rn(nb_, N, 9 * K, C2, s=0.05)
        w2f = w2.reshape(N, 9 * C2, C2)
        margs = (d, dmask, wm, bm, w2f, vmod, b2)
        mcs.append(KernelCase(
            "fused_modulation" + label,
            lambda a=margs: fused_modulation(*a),
            lambda a=margs: fused_modulation_plain(*a),
            None, nbytes(d, dmask, wm, bm, w2f, vmod, b2) + out_bytes,
            2 * nb_ * hh * ww * N * (9 * C2 + (9 * C2 + 9 * K) * C2),
            main=main, route=(fused_modulation, routes), timed=main,
            previous=(lambda a=margs: mod_mma(*a)) if main else None))
    cases["fused_o_branch"], cases["fused_modulation"] = ocs, mcs

    # fused_tail: the raw g4 [257, 257, 8, 512] (HWBC view of the producer's
    # BHWC) with its producer bias, as the pallas_tail path calls it; the
    # dead last row and column hold data, which the kernel must gate
    t4 = rn(B, 257, 257, 512, s=0.5).permute(1, 2, 0, 3)
    wh = rn(3, 3, 512, 48, s=0.01)
    bh = rn(48, s=0.1, mean=0.5, dtype=torch.float32)
    tpb = rn(512, s=0.1)
    # yardstick: one cuDNN conv over the already-activated and gated input
    t4_act = F.leaky_relu(t4.permute(2, 3, 0, 1) + tpb[None, :, None, None], 0.2)
    t4_act[:, :, 256] = 0
    t4_act[:, :, :, 256] = 0
    t4_padded = F.pad(t4_act, (1, 0, 1, 0))
    del t4_act
    wh_oihw, bh_dt = wh.permute(3, 2, 0, 1).contiguous(), bh.to(dt)

    def tail_lib():
        pre = F.conv2d(t4_padded, wh_oihw, bh_dt)[..., :256]
        return F.pixel_shuffle(torch.clamp(pre, 0.0, 1.0), 4).float()
    tail_route = (fused_tail, {torch.bfloat16: "wgmma", torch.float32: "fp32"})
    cases["fused_tail"] = [KernelCase(
        "fused_tail",
        lambda a=(t4, wh, bh): fused_tail(*a, 0.0, 1.0, "hwbc", 256, tpb),
        lambda g=t4, w=wh, b=bh, p=tpb: fused_tail_plain(g, w, b, 0.0, 1.0,
                                                         "hwbc", 256, p),
        tail_lib, nbytes(t4, wh, bh, tpb) + B * 1024 * 3072 * 4,
        2 * B * 256 * 256 * 9 * 512 * 48,
        previous=lambda: tail_igemm(t4, wh, bh, 0.0, 1.0, "hwbc", 256, tpb),
        route=tail_route)]
    # ragged: h = 13 (not a multiple of 4) ≠ wout = 21 (not a multiple of
    # 64) of 24 columns in memory, C4 = 128 (two slices), B = 3
    for label, with_pb in (("pre_bias", True), ("raw", False)):
        rg4 = rn(3, 14, 24, 128, s=0.5)
        if not with_pb:        # activated and gated, as the function expects
            rg4 = torch.relu(rg4)
            rg4[:, 13] = 0
            rg4[:, :, 21:] = 0
        rg4 = rg4.permute(1, 2, 0, 3)
        rw, rbh = rn(3, 3, 128, 48, s=0.03), rn(48, s=0.1, mean=0.5, dtype=torch.float32)
        rpb = rn(128, s=0.1) if with_pb else None
        cases["fused_tail"].append(KernelCase(
            f"fused_tail[ragged 13×21 of 24, C4=128, {label}]",
            lambda a=(rg4, rw, rbh, 0.0, 1.0, "hwbc", 21, rpb): fused_tail(*a),
            lambda g=rg4, w=rw, b=rbh, p=rpb: fused_tail_plain(
                g, w, b, 0.0, 1.0, "hwbc", 21, p),
            None, 0, 0, main=False, route=tail_route, timed=False))

    # mid_shuffle: the ×8 tail's [8,128,128,512] → [8,256,256,128], and its
    # backward against the plain un-shuffle and autograd of the plain version
    zs = rn(B, 128, 128, 512)

    def shuffle_backward(z=zs):
        g = torch.randn((B, 256, 256, 128), generator=gen, device=dev).to(dt)
        mid_shuffle.routes = dict.fromkeys(mid_shuffle.routes, 0)
        with torch.enable_grad():
            za = z.clone().requires_grad_(True)
            mid_shuffle(za, 2).backward(g)
            zb = z.clone().requires_grad_(True)
            mid_shuffle_plain(zb, 2).backward(g)
        if not (torch.equal(za.grad, mid_unshuffle_plain(g, 2))
                and torch.equal(za.grad, zb.grad)):
            raise AssertionError(f"mid_shuffle backward {dt}: not bit-identical")
        if mid_shuffle.routes != {"vec16": 2, "scalar": 0}:
            raise AssertionError(f"mid_shuffle backward {dt}: routes "
                                 f"{mid_shuffle.routes}, want vec16")
        sc = shuffle_launch(g, 2, True, "scalar")[0]
        if not torch.equal(sc, za.grad):
            raise AssertionError(f"mid_shuffle scalar backward {dt}: differs")
        log(f"mid_shuffle backward {str(dt)[6:]}: route vec16, bit-identical "
            "to the plain un-shuffle, to autograd of the plain version and "
            "to the scalar route")
    cases["mid_shuffle"] = [KernelCase(
        "mid_shuffle", lambda z=zs: mid_shuffle(z, 2),
        lambda z=zs: mid_shuffle_plain(z, 2),
        lambda z=zs: mid_shuffle_plain(z, 2), 2 * nbytes(zs), 0, exact=True,
        extra=shuffle_backward,
        rotate=((zs,), lambda: (rn(B, 128, 128, 512),)),
        route=(mid_shuffle, {torch.bfloat16: "vec16", torch.float32: "vec16"}),
        previous=lambda z=zs: shuffle_launch(z, 2, False, "scalar")[0])]
    return cases


def device_kernels(torch, fn):
    """Names of the device kernels one call of ``fn`` launches, read by
    ``torch.profiler`` (after one call outside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def vec16_checks(torch, dt, name, call, b_view, n_kernels):
    """The vec16 route of ``in_stats`` or ``fused_in_mod``: ``n_kernels``
    device kernels a call, two calls bit-equal, and the ticket counters all
    0 after a call with B = 8 and then one with B = 3 (``b_view``)."""
    from endosr_torch.kernels.in_stats import tickets

    def flat(r):
        return r if isinstance(r, tuple) else (r,)

    first, second = flat(call()), flat(call())
    if not all(torch.equal(u, v) for u, v in zip(first, second)):
        raise AssertionError(f"{name} {dt}: two vec16 calls differ")
    route = b_view()
    torch.cuda.synchronize()
    t = tickets(first[0].device, 8)
    if route != "vec16" or bool(t.any()):
        raise AssertionError(f"{name} {dt}: route {route}, tickets {t.tolist()} "
                             "after B = 8 and B = 3")
    kernels = device_kernels(torch, call)
    if len(kernels) != n_kernels:
        raise AssertionError(f"{name} {dt}: {len(kernels)} device kernels a "
                             f"call ({kernels}), want {n_kernels}")
    log(f"{name} vec16 {str(dt)[6:]}: two calls bit-equal; tickets 0 after "
        f"B = 8 and B = 3; {n_kernels} device kernel(s) a call: "
        + ", ".join(k[:60] for k in kernels))


SOURCES = {
    "packed_g123": ("endosr_torch/csrc/packed_chain.cu",
                    "endosr/kernels/packed_chain.py:438"),
    "style_blend_dot": ("endosr_torch/csrc/style_dot.cu",
                        "endosr/kernels/style_dot.py:284"),
    "head_dot": ("endosr_torch/csrc/head_dot.cu",
                 "endosr/kernels/head_dot.py:283"),
    "output_stage_x8": ("endosr_torch/csrc/output_stage.cu",
                        "endosr/kernels/output_stage.py:275"),
    "output_stage": ("endosr_torch/csrc/output_stage.cu",
                     "endosr/kernels/output_stage.py:316"),
    "style_dot_hwbm": ("endosr_torch/csrc/style_dot.cu",
                       "endosr/kernels/style_dot.py:111"),
    "fused_in_mod": ("endosr_torch/csrc/fused_in_mod.cu",
                     "endosr/kernels/fused_in_mod.py:95"),
    "in_stats": ("endosr_torch/csrc/in_stats.cu",
                 "endosr/kernels/in_stats.py:47"),
    "fused_o_branch": ("endosr_torch/csrc/fused_mod.cu",
                       "endosr/kernels/fused_obranch.py:146"),
    "fused_modulation": ("endosr_torch/csrc/fused_mod.cu",
                         "endosr/kernels/fused_mod.py:152"),
    "fused_tail": ("endosr_torch/csrc/fused_tail.cu",
                   "endosr/kernels/fused_tail.py:238"),
    "mid_shuffle": ("endosr_torch/csrc/shuffle_mid.cu",
                    "endosr/kernels/shuffle_mid.py:94"),
}


def check_kernels(torch):
    """Phase 3: kernels against plain versions; returns the JSON rows
    (without launches)."""
    rows = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        cases = make_cases(torch, dt, gen)
        for name, cs in cases.items():
            worst_abs = 0.0
            tot = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0 if cs[0].library else None}
            if cs[0].previous:
                tot["previous_ms"] = 0.0
            for c in cs:
                if c.route:
                    fn, by_dt = c.route
                    fn.routes = dict.fromkeys(fn.routes, 0)
                got = c.kernel()
                torch.cuda.synchronize()
                if c.route and fn.routes != {**dict.fromkeys(fn.routes, 0),
                                             by_dt[dt]: 1}:
                    raise AssertionError(f"{c.name} {dt}: routes {fn.routes}, "
                                         f"want one launch on {by_dt[dt]}")
                ctol = c.tol or tol
                if c.exact:
                    ref = c.plain()
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{c.name} {dt}: not bit-identical "
                                             f"(max |Δ| {rel_err(got, ref)[0]})")
                    err_abs, err_rel = 0.0, 0.0
                elif dt == torch.float32 or c.tol:
                    # float64 on the same values: the plain version, or the
                    # case's own reference
                    ref = c.ref64() if c.ref64 else _plain_f64(torch, c)
                    err_abs, err_rel = rel_err(got, ref)
                else:
                    ref = c.plain()
                    err_abs, err_rel = rel_err(got, ref)
                log(f"{c.name} {str(dt)[6:]}: max|Δ| {err_abs:.3e} "
                    f"rel {err_rel:.3e} (tol {ctol:g})")
                if not err_rel <= ctol:
                    raise AssertionError(f"{c.name} {dt}: rel err {err_rel} > {ctol}")
                worst_abs = max(worst_abs, err_abs)
                del got, ref
                if c.extra:
                    c.extra()
                if dt == torch.bfloat16 and c.timed:
                    if c.rotate:
                        sets = rotation(*c.rotate)

                        def timer(f, sets=sets):
                            return graph_ms(f, sets)
                    else:
                        timer = cuda_ms
                    ms = timer(c.kernel)
                    call = cuda_ms(c.kernel) if c.rotate else ms
                    pms = timer(c.plain)
                    lms = timer(c.library) if c.library else None
                    prev = timer(c.previous) if c.previous else None
                    bms, by = bound_ms(c.bytes, c.flops)
                    how = (f"graph of ≥ {N_GRAPH} over {len(sets)} input sets"
                           if c.rotate else "one call")
                    log(f"  {c.name} bf16 ({how}): kernel {ms:.4f} ms, call "
                        f"{call:.4f} ms, plain {pms:.4f} ms, "
                        f"library {'-' if lms is None else f'{lms:.4f} ms'}, "
                        f"bound {bms:.4f} ms ({by}; {c.bytes / 1e6:.1f} MB, "
                        f"{c.flops / 1e9:.1f} GFLOP)"
                        + (f", previous route {prev:.4f} ms" if prev else ""))
                    if c.rotate:
                        del sets, timer
                    if not c.main:
                        continue
                    if prev is not None:
                        tot["previous_ms"] += prev
                    tot["ms"] += ms
                    tot["call_ms"] += call
                    tot["plain_ms"] += pms
                    tot["bound_ms"] += bms
                    if lms is not None:
                        tot["library_ms"] += lms
                    tot["bound_by"] = by
                    tot["timing"] = "graph" if c.rotate else "call"
            rows.setdefault(name, {"max_abs_err": {}})
            rows[name]["max_abs_err"][str(dt)[6:]] = worst_abs
            if dt == torch.bfloat16:
                rows[name].update(tot)
                if "previous_ms" in tot:
                    lib = tot["library_ms"]
                    vs_lib = ("no library call" if lib is None else
                              f"library_ms {lib:.4f}, {tot['ms'] / lib:.2f}× "
                              "the library call")
                    log(f"{name} bf16 at the main path's shapes: ms "
                        f"{tot['ms']:.4f}, previous_ms {tot['previous_ms']:.4f}, "
                        f"bound_ms {tot['bound_ms']:.4f}, plain_ms "
                        f"{tot['plain_ms']:.4f} ({vs_lib}, "
                        f"{tot['ms'] / tot['bound_ms']:.2f}× the bound)")
        del cases
        torch.cuda.empty_cache()
    return rows


def _plain_f64(torch, case):
    """Evaluate a case's plain version on float64 copies of its inputs."""
    fn = case.plain
    defaults = fn.__defaults__ or ()

    def up(a):
        if torch.is_tensor(a) and a.is_floating_point():
            return a.double()
        if isinstance(a, tuple):
            return tuple(up(x) for x in a)
        if isinstance(a, dict):
            return {k: up(v) for k, v in a.items()}
        return a

    return fn(*(up(d) for d in defaults))


def ptxas_usage(log_text, kernel):
    """What ``ptxas -v`` said of the entry function whose mangled name
    contains ``kernel``: registers, static shared memory, spills and any
    remark (its dynamic shared memory is set at launch)."""
    said = []
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        if kernel not in line:
            continue
        if "Compiling entry function" in line:
            said += [x.strip() for x in lines[i + 1:i + 4]
                     if "registers" in x or "spill" in x]
        elif "Compiling" not in line and "Function properties" not in line:
            said.append(line.strip())       # a remark that names the kernel
    if not said:
        raise AssertionError(f"no ptxas record of {kernel}")
    return " | ".join(x.replace("ptxas info    : ", "") for x in said)


def flagship_opt(precision, scale=8, bucket=0, **net):
    """The flagship DepthNet serving options; ``bucket=None`` leaves
    ``eval_bucket_multiple`` unset (the default, 32); ``net`` adds
    ``network_G`` keys."""
    opt = {
        "is_train": False, "model": "sftmd_depthCond", "scale": scale,
        "precision": precision,
        "datasets": {"test": {"depthMaskNum": 10}},
        "network_G": {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3,
                      "nf": 64, "nb": 16, "depth_latent_ch": 256,
                      "which_ResBlk_depth": list(range(14)),
                      "use_trainable_params": True, **net},
        "path": {}, "train": {"manual_seed": 0},
    }
    if bucket is not None:
        opt["eval_bucket_multiple"] = bucket
    return opt


def small_forwards(torch):
    """Phase 4: reduced DepthNets through the kernels (fp32) vs the same
    weights through the plain versions on the CPU."""
    import torch.nn.functional as F

    from endosr_torch.nn.depthnet import DepthNet
    from endosr_torch.nn.networks import DEPTHNET_PRESETS
    from endosr_torch.ops.masks import pool_mask_np
    from endosr_torch.utils.port_params import seeded_init

    plain = DEPTHNET_PRESETS["plain"]
    base = dict(nb=6, depth_latent_ch=16, depth_range_num=4, style_chunk=2)
    every = (0, 1, 2, 3, 4, 5)
    cases = [
        ("x8", dict(scale=8, which_resblk_depth=(0, 1, 2)), None),
        ("x2", dict(scale=2, which_resblk_depth=every), None),
        ("x3", dict(scale=3, which_resblk_depth=every), None),
        ("x4", dict(scale=4, which_resblk_depth=(0, 1, 2)), None),
        ("x4 fused_epilogue", dict(scale=4, which_resblk_depth=(0, 1, 2),
                                   fused_epilogue=True, in_stats="kernel"), None),
        ("x8 valid_hw", dict(scale=8, which_resblk_depth=(0, 1, 2)), (29, 26)),
        ("x8 pallas_obranch", dict(scale=8, which_resblk_depth=(0, 1, 2),
                                   pallas_obranch=True), None),
        ("x8 pallas_obranch valid_hw (the masked hoisted route)",
         dict(scale=8, which_resblk_depth=(0, 1, 2), pallas_obranch=True),
         (29, 26)),
        ("x8 fused_modulation", dict(scale=8, which_resblk_depth=(0, 1, 2),
                                     fused_modulation=True, hoist_chunk=2),
         None, (28, 20)),
        ("x8 pallas_tail", dict(scale=8, which_resblk_depth=(0, 1, 2),
                                pallas_tail=True), None, (32, 24)),
        ("x8 dense tail", dict(scale=8, which_resblk_depth=(0, 1, 2),
                               packed_tail=False), None),
        ("x8 preset plain", dict(scale=8, which_resblk_depth=(0, 1, 2),
                                 **plain), None),
        ("x4 preset plain, depth block at nb-1", dict(
            scale=4, which_resblk_depth=(0, 1, 5), **plain), None),
    ]
    g = torch.Generator().manual_seed(1)
    for label, kw, valid, *size in cases:   # size: an unpadded (h, w)
        kw = {**base, **kw}
        cpu = seeded_init(DepthNet(**kw, device="cpu"), 0)
        gpu = DepthNet(**kw, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        h, w = valid or (size[0] if size else (32, 32))
        x = torch.rand((2, h, w, 3), generator=g)
        d = torch.rand((2, h, w, 1), generator=g)
        m = (torch.rand((2, h, w, 4), generator=g) > 0.6).float()
        extra = {}
        if valid:
            pm = pool_mask_np(m.numpy(), (((h + 1) // 2 + 1) // 2,
                                          ((w + 1) // 2 + 1) // 2), (8, 8))
            pad = (0, 0, 0, 32 - w, 0, 32 - h)
            x, d, m = (F.pad(t, pad) for t in (x, d, m))
            extra = dict(valid_hw=valid, pool_mask=torch.from_numpy(pm))
        want = cpu(x, d, m, **extra)
        got = gpu(x.cuda(), d.cuda(), m.cuda(),
                  **{k: v.cuda() if torch.is_tensor(v) else v
                     for k, v in extra.items()}).cpu()
        s = kw["scale"]
        err = float((got - want)[:, :h * s, :w * s].abs().max())
        log(f"small DepthNet {label} fp32, kernels on the card vs plain on "
            f"the CPU: max|Δ| {err:.3e} (tol 2e-4)")
        if not err <= 2e-4:
            raise AssertionError(f"small forward {label} differs: {err}")


def psnr(a, b):
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")


EXACT_ROUTES = {"head_dot": "fp32", "style_dot_hwbm": "cuda_core",
                "fused_tail": "fp32", "style_blend_dot": "cuda_core",
                "packed_g123": "fp32", "mid_shuffle": "vec16",
                "fused_o_branch": "fp32", "fused_modulation": "fp32",
                "in_stats": "vec16", "fused_in_mod": "vec16"}


def zero_counts(counters):
    for c in counters:
        c.launches = 0
        if hasattr(c, "routes"):
            c.routes = dict.fromkeys(c.routes, 0)


def serve(torch, counters, label, opt16, opt32, lr_hw, want, on_host,
          n_requests=2, also32=None, want_routes=None):
    """Phase 5, one full-width path: ``n_requests`` batch-8 requests of LQ
    ``lr_hw`` through ``FModelDepthCond(opt16)`` (bf16) with the launch
    counts of ``counters`` set to 0 just before and read just after; then
    the first request through ``opt32`` (fp32, same weights) for the PSNR,
    and through ``also32`` = (label, options, tolerance), whose fp32 output
    must equal ``opt32``'s. ``want_routes``: {wrapper name: route} that all
    of that wrapper's launches of the bf16 requests must have taken; the
    fp32 request must take ``EXACT_ROUTES``. ``on_host``: requests are numpy
    arrays, as a data loader hands them over. Returns (per-request seconds,
    launches)."""
    import numpy as np

    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.ops.masks import depth_masks, depth_masks_np

    h, w = lr_hw
    s = opt16["scale"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)

    def request():
        if on_host:
            dep = rng.random((8, h, w, 1), dtype=np.float32)
            return {"LQ": rng.random((8, h, w, 3), dtype=np.float32),
                    "Depth": dep,
                    "DepthMaskList": np.stack(
                        [depth_masks_np(d, True, 10) for d in dep])}
        lq = torch.rand((8, h, w, 3), generator=gen, device="cuda")
        dep = torch.rand((8, h, w, 1), generator=gen, device="cuda")
        return {"LQ": lq, "Depth": dep,
                "DepthMaskList": depth_masks(dep[..., 0], True, 10)}

    t0 = time.perf_counter()
    model = FModelDepthCond(opt16)
    log(f"[{label}] FModelDepthCond bf16 built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.netG.parameters()):,} parameters)")
    reqs = [request() for _ in range(n_requests)]
    model.feed_data(reqs[0])
    model.test()                                   # warm-up request
    torch.cuda.synchronize()

    zero_counts(counters)
    lat, outs = [], []
    for r in reqs:
        t = time.perf_counter()
        model.feed_data(r)
        sr = model.test()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        outs.append(sr)
    launches = {c.__name__: c.launches for c in counters}
    routes = {c.__name__: dict(c.routes) for c in counters
              if hasattr(c, "routes")}

    shape = (8, h * s, w * s, 3)
    for k, sr in enumerate(outs):
        if tuple(sr.shape) != shape or sr.dtype != torch.float32:
            raise AssertionError(f"[{label}] request {k}: SR "
                                 f"{tuple(sr.shape)} {sr.dtype}")
        if not bool(torch.isfinite(sr).all()):
            raise AssertionError(f"[{label}] request {k}: non-finite SR")
        lo, hi = float(sr.min()), float(sr.max())
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"[{label}] request {k}: SR outside [0,1]: "
                                 f"{lo}, {hi}")
        log(f"[{label}] request {k}: SR {list(shape)} fp32, range "
            f"[{lo:.4f}, {hi:.4f}], mean {float(sr.mean()):.4f}")
    for c in counters:
        per = want.get(c.__name__, 0)
        if launches[c.__name__] != per * n_requests:
            raise AssertionError(
                f"[{label}] {c.__name__}: {launches[c.__name__]} launches in "
                f"{n_requests} forwards, want {per} each")

    for name, route in (want_routes or {}).items():
        took = {**dict.fromkeys(routes[name], 0), route: launches[name]}
        if routes[name] != took or not launches[name]:
            raise AssertionError(f"[{label}] {name} routes {routes[name]}, "
                                 f"want {took}")
        log(f"[{label}] {name}: {launches[name]} launches, all on route "
            f"{route!r}")

    sr16 = outs[0].clone()
    del outs
    sd = model.netG.state_dict()
    del model
    torch.cuda.empty_cache()

    def fp32_output(opt):
        m32 = FModelDepthCond(opt)
        m32.netG.load_state_dict(sd)
        m32.feed_data(reqs[0])
        return m32.test().clone()

    zero_counts(counters)
    sr32 = fp32_output(opt32)
    for c in counters:
        if not hasattr(c, "routes"):
            continue
        exact = EXACT_ROUTES[c.__name__]
        took = {**dict.fromkeys(c.routes, 0), exact: c.launches}
        if c.routes != took:
            raise AssertionError(f"[{label}] fp32 request: {c.__name__} routes "
                                 f"{c.routes}, want {took}")
    db = psnr(sr16, sr32)
    log(f"[{label}] bf16 vs fp32 SR PSNR on the same weights: {db:.2f} dB "
        f"(min 40)")
    if not db >= 40.0:
        raise AssertionError(f"[{label}] bf16 vs fp32 PSNR {db} < 40 dB")
    if also32:
        what, opt, tol = also32
        err = float((fp32_output(opt) - sr32).abs().max())
        log(f"[{label}] fp32 output vs {what}: max|Δ| {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"[{label}] differs from {what}: {err}")
    torch.cuda.empty_cache()
    med = sorted(lat)[len(lat) // 2]
    log(f"[{label}] batch 8, LQ {h}×{w} → SR {h * s}×{w * s}, bf16; "
        f"per-request latency " + ", ".join(f"{x * 1e3:.2f}" for x in lat)
        + f" ms; median {med * 1e3:.2f} ms = {8 / med:.2f} frames/s")
    return lat, launches


def serving_paths(torch, counters):
    """The full-width paths; returns {label: launches}."""
    fused = dict(net_kw={"fused_epilogue": True, "in_stats": "kernel"})
    plain32 = ("preset: plain", flagship_opt("fp32", preset="plain"), 2e-4)
    tail = {"packed_g123": 2, "head_dot": 1, "output_stage_x8": 1}

    def routes(want):
        fast = {"head_dot": "wgmma", "fused_tail": "wgmma",
                "style_blend_dot": "tc", "style_dot_hwbm": "tc",
                "packed_g123": "wgmma", "fused_o_branch": "wgmma",
                "fused_modulation": "wgmma", "in_stats": "vec16",
                "fused_in_mod": "vec16"}
        return {k: r for k, r in fast.items() if k in want}

    def x8(label, want, **net):
        return dict(label=label, opt16=flagship_opt("bf16", **net),
                    opt32=flagship_opt("fp32", **net), lr_hw=(128, 128),
                    on_host=False, want=want, also32=plain32,
                    want_routes=routes(want))
    paths = [
        dict(x8("x8 unbucketed", {"style_blend_dot": 2, **tail}), n_requests=3),
        x8("x8 pallas_obranch", {"fused_o_branch": 1, **tail},
           net_kw={"pallas_obranch": True}),
        x8("x8 fused_modulation", {"fused_modulation": 1, **tail},
           net_kw={"fused_modulation": True}),
        x8("x8 pallas_tail",
           {"style_blend_dot": 2, "packed_g123": 2, "fused_tail": 1},
           net_kw={"pallas_tail": True}),
        dict(label="x8 preset plain",
             opt16=flagship_opt("bf16", preset="plain"),
             opt32=flagship_opt("fp32", preset="plain"), lr_hw=(128, 128),
             on_host=False, want={}),
        dict(label="x8 bucketed", opt16=flagship_opt("bf16", bucket=None),
             opt32=flagship_opt("fp32", bucket=None), lr_hw=(120, 112),
             on_host=True, want={"style_dot_hwbm": 2, "output_stage": 1},
             want_routes=routes({"style_dot_hwbm"}),
             also32=("the unbucketed forward", flagship_opt("fp32"), 1e-4)),
        dict(label="x4 fused_epilogue",
             opt16=flagship_opt("bf16", 4, None, **fused),
             opt32=flagship_opt("fp32", 4, None, **fused), lr_hw=(128, 128),
             on_host=False,
             want={"fused_in_mod": 26, "in_stats": 26, "style_blend_dot": 2,
                   "output_stage_x8": 1},
             want_routes=routes({"style_blend_dot", "in_stats",
                                 "fused_in_mod"}),
             also32=("the chained epilogue", flagship_opt("fp32", 4, 0), 2e-4)),
    ]
    return {p["label"]: serve(torch, counters, **p)[1] for p in paths}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from endosr_torch.kernels import _build
    from endosr_torch.kernels.fused_in_mod import fused_in_mod
    from endosr_torch.kernels.fused_mod import fused_modulation
    from endosr_torch.kernels.fused_obranch import fused_o_branch
    from endosr_torch.kernels.fused_tail import fused_tail
    from endosr_torch.kernels.head_dot import head_dot
    from endosr_torch.kernels.in_stats import in_stats
    from endosr_torch.kernels.output_stage import output_stage, output_stage_x8
    from endosr_torch.kernels.packed_chain import packed_g123
    from endosr_torch.kernels.shuffle_mid import mid_shuffle
    from endosr_torch.kernels.style_dot import style_blend_dot, style_dot_hwbm

    t_start = time.perf_counter()
    gpu = gpu_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {gpu} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    times = _build.build_all()
    log(f"built kernels (seconds since the builds started): "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    for src in _build.SOURCES:
        txt = (_build.BUILD / f"{src}.log")
        if txt.exists():
            for line in txt.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {src}: {line.strip()}")

    for src, kern in (("head_dot", "conv_wgmma_kernel"),
                      ("fused_tail", "conv_wgmma_kernel"),
                      ("packed_chain", "conv_wgmma_kernel"),
                      ("fused_mod", "fused_mod_wgmma_kernel"),
                      ("style_dot", "style_dot_tc_kernel"),
                      ("style_dot", "style_blend_tc_kernel"),
                      ("in_stats", "in_stats_vec16_kernel"),
                      ("fused_in_mod", "in_mod_apply_vec16")):
        log(f"  {kern} ({src}): " + ptxas_usage((_build.BUILD / f"{src}.log").read_text(),
                                        kern))

    rows = check_kernels(torch)
    small_forwards(torch)
    counters = [packed_g123, style_blend_dot, head_dot, output_stage_x8,
                output_stage, style_dot_hwbm, fused_in_mod, in_stats,
                fused_o_branch, fused_modulation, fused_tail, mid_shuffle]
    by_path = serving_paths(torch, counters)

    out = []
    for kname, (src, repl) in SOURCES.items():
        r = rows[kname]
        out.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(p[kname] for p in by_path.values()),
            "launches_by_path": {k: p[kname] for k, p in by_path.items()},
            "max_abs_err": r["max_abs_err"]["bfloat16"],
            "max_abs_err_fp32": r["max_abs_err"]["float32"],
            "ms": r["ms"], "call_ms": r["call_ms"], "timing": r["timing"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"previous_ms": r["previous_ms"]} if "previous_ms" in r else {})})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
