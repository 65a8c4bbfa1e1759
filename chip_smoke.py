#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``endosr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — the card's name and power limit; TF32 off for fp32 checks.
2. build — every kernel under ``endosr_torch/csrc`` with one ``nvcc`` per
   source, all started together, into ``build/endosr_torch/``.
3. kernels — each kernel against its plain PyTorch version at the
   flagship shapes of the ×8 serving forward, in bf16 (max|Δ|/max|ref| ≤
   1e-2) and fp32 (≤ 1e-5, the plain version evaluated in float64);
   ``output_stage_x8`` must be bit-identical. Times are CUDA-event medians
   of 20 runs, beside the plain version's, the bound (larger of bytes over
   3.35 TB/s and operations over the bf16 tensor-core peak), and one
   PyTorch call computing the same function where there is one.
4. small forward — a reduced DepthNet through the kernels in fp32 against
   the same weights on the CPU (plain versions), ≤ 2e-4 max abs.
5. serving — ``FModelDepthCond`` at full flagship width (bf16, seeded
   weights) answers batch-8 requests (LQ 128² → SR 1024²): every output
   finite, [8,1024,1024,3], in [0,1]; launch counts 2/2/1/1 per forward;
   bf16 vs fp32 PSNR ≥ 40 dB on the same weights.

Prints the kernels JSON line, then the ``nvidia-smi`` name/power line,
then ``{"ok": true, "device": {...}}`` as the last line. Exits non-zero
without a result when no CUDA device is present or when run outside the
repository.
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
N_REQUESTS = 3


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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(bytes_, flops):
    tb, tf = bytes_ / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return (float((got - ref).abs().max()),
            float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)))


class KernelCase:
    """One kernel at one main-path shape: its call, plain call, library
    call and the bytes/operations of the work."""

    def __init__(self, name, kernel, plain, library, bytes_, flops):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.library, self.bytes, self.flops = library, bytes_, flops


def make_cases(torch, dt, gen):
    """The four kernels at the shapes one flagship forward gives them
    (B=8, LR 128 → SR 1024; packed_g123 and style_blend_dot twice)."""
    import torch.nn.functional as F

    from endosr_torch.kernels.head_dot import head_dot, head_dot_plain
    from endosr_torch.kernels.output_stage import (output_stage_x8,
                                                   output_stage_x8_plain)
    from endosr_torch.kernels.packed_chain import packed_g123, packed_g123_plain
    from endosr_torch.kernels.style_dot import style_blend_dot, style_blend_plain

    dev = "cuda"

    def rn(*shape, s=1.0, mean=0.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * s
                + mean).to(dtype)

    B = 8
    cases = {}

    # output_stage_x8: pre64 [256, 8, 256, 64] HBWC
    pre64 = rn(256, B, 256, 64, s=0.6, mean=0.5)
    cases["output_stage_x8"] = [KernelCase(
        "output_stage_x8",
        lambda: output_stage_x8(pre64, 0.0, 1.0, "hbwc"),
        lambda p=pre64: output_stage_x8_plain(p, 0.0, 1.0, "hbwc"),
        None, nbytes(pre64) + B * 1024 * 3072 * 4, 0)]

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
    cases["head_dot"] = [KernelCase(
        "head_dot",
        lambda: head_dot(g4, w64, b64, 256, pb),
        lambda g=g4, w=w64, b=b64, p=pb: head_dot_plain(g, w, b, 256, p),
        head_lib,
        nbytes(g4, w64, b64, pb) + 256 * B * 256 * 64 * g4.element_size(),
        2 * B * 256 * 256 * 9 * 512 * 64)]

    # packed_g123: up1 chain (x [128,128,8,256], pre_act) and tail chain
    # (packed producer [129,129,8,512], phases + pre_act + pre_bias)
    pcs = []
    for label, xshape, cin4, phases in (("up1", (B, 128, 128, 256), 256, False),
                                        ("tail", (B, 129, 129, 512), 128, True)):
        x = rn(*xshape, s=0.5).permute(1, 2, 0, 3)
        k1 = rn(2, 2, cin4, 128, s=1.0 / math.sqrt(4 * cin4))
        k2 = rn(2, 2, 128, 128, s=1.0 / math.sqrt(512))
        k3 = rn(2, 2, 128, 128, s=1.0 / math.sqrt(512))
        b1, b2, b3 = (rn(128, s=0.1) for _ in range(3))
        pbias = rn(cin4, s=0.1) if phases else None
        n = (2 * 128 if phases else 128) + 1
        args = (x, k1, b1, k2, b2, k3, b3)
        kw = dict(pre_act=True, pre_bias=pbias, phases=phases)
        flops = 2 * B * n * n * 4 * (cin4 * 128 + 2 * 128 * 128)
        pcs.append(KernelCase(
            f"packed_g123[{label}]",
            lambda a=args, k=kw: packed_g123(*a, **k),
            lambda a=args, k=kw: packed_g123_plain(*a, **k),
            None,
            nbytes(x, k1, k2, k3, b1, b2, b3,
                   *([pbias] if pbias is not None else []))
            + n * n * B * 128 * x.element_size(),
            flops))
    cases["packed_g123"] = pcs

    # style_blend_dot: the 7- and 6-block groups (M = 1792 / 1536)
    scs = []
    masks = (torch.rand((B, 128, 128, 90), generator=gen, device=dev)
             > 0.8).to(dt)
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
            2 * B * 128 * 128 * 90 * m))
    cases["style_blend_dot"] = scs
    return cases


SOURCES = {
    "packed_g123": ("endosr_torch/csrc/packed_chain.cu",
                    "endosr/kernels/packed_chain.py:438"),
    "style_blend_dot": ("endosr_torch/csrc/style_dot.cu",
                        "endosr/kernels/style_dot.py:284"),
    "head_dot": ("endosr_torch/csrc/head_dot.cu",
                 "endosr/kernels/head_dot.py:283"),
    "output_stage_x8": ("endosr_torch/csrc/output_stage.cu",
                        "endosr/kernels/output_stage.py:275"),
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
            tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0 if cs[0].library else None}
            for c in cs:
                got = c.kernel()
                torch.cuda.synchronize()
                if name == "output_stage_x8":
                    ref = c.plain()
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{c.name} {dt}: not bit-identical "
                                             f"(max |Δ| {rel_err(got, ref)[0]})")
                    err_abs, err_rel = 0.0, 0.0
                elif dt == torch.float32:
                    # the plain version evaluated in float64 on the same values
                    ref = _plain_f64(torch, c)
                    err_abs, err_rel = rel_err(got, ref)
                else:
                    ref = c.plain()
                    err_abs, err_rel = rel_err(got, ref)
                log(f"{c.name} {str(dt)[6:]}: max|Δ| {err_abs:.3e} "
                    f"rel {err_rel:.3e} (tol {tol:g})")
                if not err_rel <= tol:
                    raise AssertionError(f"{c.name} {dt}: rel err {err_rel} > {tol}")
                worst_abs = max(worst_abs, err_abs)
                del got, ref
                if dt == torch.bfloat16:
                    ms = cuda_ms(c.kernel)
                    pms = cuda_ms(c.plain)
                    lms = cuda_ms(c.library) if c.library else None
                    bms, by = bound_ms(c.bytes, c.flops)
                    log(f"  {c.name} bf16: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                        f"library {'-' if lms is None else f'{lms:.4f} ms'}, "
                        f"bound {bms:.4f} ms ({by}; {c.bytes / 1e6:.1f} MB, "
                        f"{c.flops / 1e9:.1f} GFLOP)")
                    tot["ms"] += ms
                    tot["plain_ms"] += pms
                    tot["bound_ms"] += bms
                    if lms is not None:
                        tot["library_ms"] += lms
                    tot["bound_by"] = by
            rows.setdefault(name, {"max_abs_err": {}})
            rows[name]["max_abs_err"][str(dt)[6:]] = worst_abs
            if dt == torch.bfloat16:
                rows[name].update(tot)
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


def flagship_opt(precision):
    return {
        "is_train": False, "model": "sftmd_depthCond", "scale": 8,
        "precision": precision, "eval_bucket_multiple": 0,
        "datasets": {"test": {"depthMaskNum": 10}},
        "network_G": {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3,
                      "nf": 64, "nb": 16, "depth_latent_ch": 256,
                      "which_ResBlk_depth": list(range(14)),
                      "use_trainable_params": True},
        "path": {}, "train": {"manual_seed": 0},
    }


def small_forward(torch):
    """Phase 4: a reduced DepthNet through the kernels (fp32) vs the same
    weights through the plain versions on the CPU."""
    from endosr_torch.nn.depthnet import DepthNet
    from endosr_torch.utils.port_params import seeded_init

    kw = dict(nb=6, which_resblk_depth=(0, 1, 2), depth_latent_ch=16,
              depth_range_num=4, style_chunk=2)
    cpu = seeded_init(DepthNet(**kw, device="cpu"), 0)
    gpu = DepthNet(**kw, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 32, 32, 3), generator=g)
    d = torch.rand((2, 32, 32, 1), generator=g)
    m = (torch.rand((2, 32, 32, 4), generator=g) > 0.6).float()
    want = cpu(x, d, m)
    got = gpu(x.cuda(), d.cuda(), m.cuda()).cpu()
    err = float((got - want).abs().max())
    log(f"small DepthNet fp32, kernels on the card vs plain on the CPU: "
        f"max|Δ| {err:.3e} (tol 2e-4)")
    if not err <= 2e-4:
        raise AssertionError(f"small forward differs: {err}")


def serve(torch, counters):
    """Phase 5: flagship serving. Returns (per-request seconds, launches)."""
    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.ops.masks import depth_masks

    gen = torch.Generator(device="cuda").manual_seed(2)

    def request():
        lq = torch.rand((8, 128, 128, 3), generator=gen, device="cuda")
        dep = torch.rand((8, 128, 128, 1), generator=gen, device="cuda")
        return {"LQ": lq, "Depth": dep,
                "DepthMaskList": depth_masks(dep[..., 0], True, 10)}

    t0 = time.perf_counter()
    model = FModelDepthCond(flagship_opt("bf16"))
    log(f"FModelDepthCond bf16 built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.netG.parameters()):,} parameters)")
    reqs = [request() for _ in range(N_REQUESTS)]
    model.feed_data(reqs[0])
    model.test()                                   # warm-up request
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    lat, outs = [], []
    for r in reqs:
        t = time.perf_counter()
        model.feed_data(r)
        sr = model.test()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        outs.append(sr)
    launches = {c.__name__: c.launches for c in counters}

    for k, sr in enumerate(outs):
        if tuple(sr.shape) != (8, 1024, 1024, 3) or sr.dtype != torch.float32:
            raise AssertionError(f"request {k}: SR {tuple(sr.shape)} {sr.dtype}")
        if not bool(torch.isfinite(sr).all()):
            raise AssertionError(f"request {k}: non-finite SR")
        lo, hi = float(sr.min()), float(sr.max())
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"request {k}: SR outside [0,1]: {lo}, {hi}")
        log(f"request {k}: SR [8,1024,1024,3] fp32, range [{lo:.4f}, {hi:.4f}], "
            f"mean {float(sr.mean()):.4f}")
    want = {"packed_g123": 2, "style_blend_dot": 2, "head_dot": 1,
            "output_stage_x8": 1}
    for name, per in want.items():
        if launches[name] != per * N_REQUESTS:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{N_REQUESTS} forwards, want {per} each")

    sr16 = outs[0]
    del outs
    sd = model.netG.state_dict()
    del model
    torch.cuda.empty_cache()
    m32 = FModelDepthCond(flagship_opt("fp32"))
    m32.netG.load_state_dict(sd)
    m32.feed_data(reqs[0])
    sr32 = m32.test()
    mse = float(((sr16.double() - sr32.double()) ** 2).mean())
    psnr = 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")
    log(f"bf16 vs fp32 SR PSNR on the same weights: {psnr:.2f} dB (min 40)")
    if not psnr >= 40.0:
        raise AssertionError(f"bf16 vs fp32 PSNR {psnr} < 40 dB")
    return lat, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from endosr_torch.kernels import _build
    from endosr_torch.kernels.head_dot import head_dot
    from endosr_torch.kernels.output_stage import output_stage_x8
    from endosr_torch.kernels.packed_chain import packed_g123
    from endosr_torch.kernels.style_dot import style_blend_dot

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

    rows = check_kernels(torch)
    small_forward(torch)
    counters = [packed_g123, style_blend_dot, head_dot, output_stage_x8]
    lat, launches = serve(torch, counters)
    med = sorted(lat)[len(lat) // 2]
    log(f"serving on {gpu}: batch 8, LQ 128² → SR 1024², bf16; per-request "
        f"latency " + ", ".join(f"{x * 1e3:.2f}" for x in lat)
        + f" ms; median {med * 1e3:.2f} ms = {8 / med:.2f} frames/s")

    out = []
    for kname, (src, repl) in SOURCES.items():
        r = rows[kname]
        out.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[kname],
            "max_abs_err": r["max_abs_err"]["bfloat16"],
            "max_abs_err_fp32": r["max_abs_err"]["float32"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
