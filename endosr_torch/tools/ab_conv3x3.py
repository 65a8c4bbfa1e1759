"""Time the ``wgmma`` conv of ``head_dot`` or ``fused_tail`` (3×3), of
``packed_g123``'s stages (2×2) or of ``fused_o_branch`` /
``fused_modulation`` at the flagship shapes, alone or against a variant of
its source, in one process on one card.

    python -m endosr_torch.tools.ab_conv3x3
        [--kernel head_dot|fused_tail|packed_chain|fused_mod]
        [--other path/to/variant.cu] [--rounds 7]

Times of one kernel differ by a few percent between calls and cards, so two
versions are compared only here: both are built (the variant, a copy of the
kernel's ``.cu`` with changes, as a second library with the same exported
functions), launched in turns (A, B, A, B, ...) through the exported
``*_wgmma`` function with and without ``pre_bias``, and held to the plain
version first. Each reading is ``chip_smoke.py``'s CUDA-event median of 20
launches; the table gives the median, minimum and maximum over the rounds.
Also timed: the wrapper (which adds the weight packing), the packing alone,
the warp-``mma`` route and one cuDNN ``conv2d`` on the activated input (for
``fused_tail`` with clamp and ``pixel_shuffle``). For ``packed_chain`` the
readings are the up1 and the tail chain, three stage launches each, through
``launch_wgmma``, beside the warp-``mma`` route and the packing of one
stage's weights. For ``fused_mod`` they are ``fused_o_branch`` and
``fused_modulation`` (B = 8, 128², N = 26, 2C = 128, K = 10) through
``launch_wgmma`` (which packs w2, and v), beside the warp-``mma`` route and
the packing alone. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import shutil
import statistics
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    import torch

    from endosr_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("head_dot", "fused_tail",
                                         "packed_chain", "fused_mod"),
                    default="head_dot")
    ap.add_argument("--other", type=Path, help="a variant of the kernel's .cu")
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_conv3x3: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_build.REPO))
    from chip_smoke import cuda_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs, variant = {"A": args.kernel}, None
    if args.other:
        # the variant builds beside the kernel's own source and is removed again
        variant = _build.CSRC / f"{args.kernel}_variant.cu"
        shutil.copy(args.other, variant)
        _build.SOURCES[variant.stem] = dict(_build.SOURCES[args.kernel])
        libs["B"] = variant.stem
    try:
        _build.build_all(list(libs.values()))
        fns = {"head_dot": _head_dot, "fused_tail": _fused_tail,
               "packed_chain": _packed_chain,
               "fused_mod": _fused_mod}[args.kernel](torch, _build, libs)
        times = {k: [] for k in fns}
        for _ in range(args.rounds):
            for k, f in fns.items():
                times[k].append(cuda_ms(f))
        for k, v in times.items():
            print(f"{k:30s} median {statistics.median(v):.4f} ms  min "
                  f"{min(v):.4f}  max {max(v):.4f}", flush=True)
        return 0
    finally:
        if variant:
            variant.unlink()


def _operands(torch, cout):
    dt, dev = torch.bfloat16, "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, s=1.0, mean=0.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * s + mean).to(dtype)

    g4 = rn(8, 257, 257, 512, s=0.5).permute(1, 2, 0, 3)
    w = rn(3, 3, 512, cout, s=0.02 if cout == 64 else 0.01)
    bias = rn(cout, s=0.1, mean=0.0 if cout == 64 else 0.5, dtype=torch.float32)
    pb = rn(512, s=0.1)
    return g4, w, bias, pb


def _check(torch, name, got, ref):
    err = float((got.float() - ref.float()).abs().max())
    print(f"{name}: max |Δ| vs the plain version {err:.3e}", flush=True)
    if not err <= 1e-2 * float(ref.float().abs().max()):
        raise AssertionError(f"{name} disagrees with the plain version")


def _head_dot(torch, _build, libs):
    import torch.nn.functional as F

    from endosr_torch.kernels import head_dot as hd

    g4, w64, b64, pb = _operands(torch, 64)
    wp = hd.head_dot_pack_weights(w64)
    out = torch.empty((256, 8, 256, 64), dtype=g4.dtype, device=g4.device)
    ref = hd.head_dot_plain(g4, w64, b64, 256, pb)

    def kernel(lib, bias):
        fn = _build.load(lib, "head_dot_wgmma")
        stream = _build.stream_ptr(g4.device)

        def launch():
            _build.check(lib, fn(
                g4.data_ptr(), g4.stride(0), g4.stride(1), g4.stride(2), 8, 512,
                256, 257, 256, wp.data_ptr(), b64.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                stream), "head_dot_wgmma")
        return launch

    g4_act = F.leaky_relu(g4.permute(2, 3, 0, 1) + pb[None, :, None, None], 0.2)
    w_oihw = w64.permute(3, 2, 0, 1).contiguous()
    fns = {}
    for tag, lib in libs.items():
        fns[f"{tag} kernel, pre_bias"] = kernel(lib, pb)
        fns[f"{tag} kernel, raw"] = kernel(lib, None)
        fns[f"{tag} kernel, pre_bias"]()
        torch.cuda.synchronize()
        _check(torch, f"{tag} ({lib})", out, ref)
    fns["wrapper (packs the weights)"] = lambda: hd.head_dot(g4, w64, b64, 256, pb)
    fns["weight packing"] = lambda: hd.head_dot_pack_weights(w64)
    fns["warp-mma route"] = lambda: hd.launch_igemm(g4, w64, b64, 256, pb)
    fns["conv2d (cuDNN)"] = lambda: F.conv2d(g4_act, w_oihw, padding=1)
    return fns


def _fused_tail(torch, _build, libs):
    import torch.nn.functional as F

    from endosr_torch.kernels import fused_tail as ft
    from endosr_torch.utils.device import device_constant

    g4, wh, bh, pb = _operands(torch, 48)
    wp = ft.fused_tail_pack_weights(wh)
    perm = device_constant(ft._row_major_channels, (), torch.int64, g4.device)
    bias = bh[perm].contiguous()
    out = torch.empty((8, 1024, 3072), dtype=torch.float32, device=g4.device)
    ref = ft.fused_tail_plain(g4, wh, bh, 0.0, 1.0, "hwbc", 256, pb)

    def kernel(lib, pre_bias):
        fn = _build.load(lib, "fused_tail_wgmma")
        stream = _build.stream_ptr(g4.device)

        def launch():
            _build.check(lib, fn(
                g4.data_ptr(), g4.stride(0), g4.stride(1), g4.stride(2), 8, 512,
                256, 257, 256, wp.data_ptr(), bias.data_ptr(),
                None if pre_bias is None else pre_bias.data_ptr(), 0.0, 1.0,
                out.data_ptr(), stream), "fused_tail_wgmma")
        return launch

    act = F.leaky_relu(g4.permute(2, 3, 0, 1) + pb[None, :, None, None], 0.2)
    act[:, :, 256] = 0
    act[:, :, :, 256] = 0
    act = F.pad(act, (1, 0, 1, 0))
    w_oihw, bh_dt = wh.permute(3, 2, 0, 1).contiguous(), bh.to(g4.dtype)

    def library():
        pre = F.conv2d(act, w_oihw, bh_dt)[..., :256]
        return F.pixel_shuffle(torch.clamp(pre, 0.0, 1.0), 4).float()
    fns = {}
    for tag, lib in libs.items():
        fns[f"{tag} kernel, pre_bias"] = kernel(lib, pb)
        fns[f"{tag} kernel, raw"] = kernel(lib, None)
        fns[f"{tag} kernel, pre_bias"]()
        torch.cuda.synchronize()
        _check(torch, f"{tag} ({lib})", out, ref)
    fns["wrapper (packs the weights)"] = lambda: ft.fused_tail(
        g4, wh, bh, 0.0, 1.0, "hwbc", 256, pb)
    fns["weight packing"] = lambda: ft.fused_tail_pack_weights(wh)
    fns["warp-mma route"] = lambda: ft.launch_igemm(
        g4, wh, bh, 0.0, 1.0, "hwbc", 256, pb)
    fns["conv2d + clamp + pixel_shuffle"] = library
    return fns


def _packed_chain(torch, _build, libs):
    import math

    from endosr_torch.kernels import packed_chain as pc

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, s=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(
            torch.bfloat16)

    fns = {}
    for label, xshape, cin4, phases in (("up1", (8, 128, 128, 256), 256, False),
                                        ("tail", (8, 129, 129, 512), 128, True)):
        x = rn(*xshape, s=0.5).permute(1, 2, 0, 3)
        ks = (rn(2, 2, cin4, 128, s=1 / math.sqrt(4 * cin4)),
              *(rn(2, 2, 128, 128, s=1 / math.sqrt(512)) for _ in range(2)))
        bs = [rn(128, s=0.1) for _ in range(3)]
        args = (x, ks[0], bs[0], ks[1], bs[1], ks[2], bs[2], True,
                rn(cin4, s=0.1) if phases else None, phases)
        ref = pc.packed_g123_plain(*args)
        for tag, lib in libs.items():
            fns[f"{tag} {label} chain"] = (
                lambda a=args, lib=lib: pc.launch_wgmma(*a, lib=lib))
            _check(torch, f"{tag} ({lib}) {label}", fns[f"{tag} {label} chain"](),
                   ref)
        fns[f"warp-mma route, {label}"] = lambda a=args: pc.launch_igemm(*a)
        fns[f"weight packing, {label} k1"] = (
            lambda k=ks[0]: pc.packed_stage_pack_weights(k))
    return fns


def _fused_mod(torch, _build, libs):
    import math

    from endosr_torch.kernels import fused_mod as fm
    from endosr_torch.kernels import fused_obranch as fo

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, s=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(
            torch.bfloat16)

    n, c2, k = 26, 128, 10
    d = torch.rand((8, 128, 128, 1), generator=gen, device="cuda").to(
        torch.bfloat16)
    wm, bm, b2 = rn(n, 9, c2, s=0.3), rn(n, c2, s=0.1), rn(n, c2, s=0.1)
    w2 = rn(n, 9, c2, c2, s=1 / math.sqrt(9 * c2))
    mask = (torch.rand((8, 128, 128, k), generator=gen, device="cuda")
            > 0.8).to(torch.bfloat16)
    v = rn(8, n, 9 * k, c2, s=0.05)
    o_args = (d, wm, bm, w2, b2)
    m_args = (d, mask, wm, bm, w2.reshape(n, 9 * c2, c2), v, b2)
    refs = {"fused_o_branch": fo.fused_o_branch_plain(*o_args),
            "fused_modulation": fm.fused_modulation_plain(*m_args)}
    fns = {}
    for tag, lib in libs.items():
        for name, launch, a in (("fused_o_branch", fo.launch_wgmma, o_args),
                                ("fused_modulation", fm.launch_wgmma, m_args)):
            fns[f"{tag} {name}"] = lambda f=launch, a=a, lib=lib: f(*a, lib=lib)
            _check(torch, f"{tag} ({lib}) {name}", fns[f"{tag} {name}"](),
                   refs[name])
    fns["warp-mma route, fused_o_branch"] = lambda: fo.launch_mma(*o_args)
    fns["warp-mma route, fused_modulation"] = lambda: fm.launch_mma(*m_args)
    fns["w2 packing"] = lambda: fo.o_branch_pack_weights(w2)
    fns["v packing"] = lambda: fm.style_pack_v(v)
    return fns


if __name__ == "__main__":
    sys.exit(main())

