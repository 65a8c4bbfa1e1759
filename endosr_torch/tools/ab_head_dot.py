"""Time ``head_dot``'s ``wgmma`` kernel at the flagship shape, alone or
against a variant of its source, in one process on one card.

    python -m endosr_torch.tools.ab_head_dot [--other path/to/variant.cu]
                                             [--rounds 7]

Times of one kernel differ by a few percent between calls and cards, so two
versions are compared only here: both are built (the variant as a second
library with the same exported functions), launched in turns (A, B, A, B,
...) through ``head_dot_wgmma`` with and without ``pre_bias``, and held to
the plain version first. Each reading is ``chip_smoke.py``'s CUDA-event
median of 20 launches; the table gives the median, minimum and maximum over
the rounds. Also timed: the wrapper (which adds the weight packing), the
packing alone, the warp-``mma`` route and cuDNN's ``conv2d`` on the
activated input. Prints the card's name and power limit first.
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
    import torch.nn.functional as F

    from endosr_torch.kernels import _build
    from endosr_torch.kernels import head_dot as hd

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="a variant of head_dot.cu")
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_head_dot: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_build.REPO))
    from chip_smoke import cuda_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs, variant = {"A": "head_dot"}, None
    if args.other:
        # the variant builds beside the kernel's own source and is removed again
        variant = _build.CSRC / "head_dot_variant.cu"
        shutil.copy(args.other, variant)
        _build.SOURCES["head_dot_variant"] = dict(_build.SOURCES["head_dot"])
        libs["B"] = "head_dot_variant"
    try:
        _build.build_all(list(libs.values()))
        return _time(torch, F, _build, hd, cuda_ms, libs, args.rounds)
    finally:
        if variant:
            variant.unlink()


def _time(torch, F, _build, hd, cuda_ms, libs, rounds):
    dt, dev = torch.bfloat16, "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, s=1.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    g4 = rn(8, 257, 257, 512, s=0.5).permute(1, 2, 0, 3)
    w64, b64 = rn(3, 3, 512, 64, s=0.02), rn(64, s=0.1, dtype=torch.float32)
    pb = rn(512, s=0.1)
    wp = hd.head_dot_pack_weights(w64)
    out = torch.empty((256, 8, 256, 64), dtype=dt, device=dev)
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
        err = float((out.float() - ref.float()).abs().max())
        print(f"{tag} ({lib}): max |Δ| vs the plain version {err:.3e}", flush=True)
        if not err <= 1e-2 * float(ref.abs().max()):
            raise AssertionError(f"{lib} disagrees with the plain version")
    fns["wrapper (packs the weights)"] = lambda: hd.head_dot(g4, w64, b64, 256, pb)
    fns["weight packing"] = lambda: hd.head_dot_pack_weights(w64)
    fns["warp-mma route"] = lambda: hd.launch_igemm(g4, w64, b64, 256, pb)
    fns["conv2d (cuDNN)"] = lambda: F.conv2d(g4_act, w_oihw, padding=1)

    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, f in fns.items():
            times[k].append(cuda_ms(f))
    for k, v in times.items():
        print(f"{k:30s} median {statistics.median(v):.4f} ms  min {min(v):.4f}"
              f"  max {max(v):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
