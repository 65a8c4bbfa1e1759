"""Where the packed stage's ``wgmma`` kernel spends a tile, on one GPU.

    python -m endosr_torch.tools.prof_conv [--chain up1|tail|both]

Builds ``csrc/packed_chain.cu`` a second time with ``CONV_PROFILE`` defined
(``clock64`` readings in ``conv_wgmma.cuh``, summed per block), runs the
flagship up1 and tail chains (bf16, B = 8, ``chip_smoke.py``'s operands)
through it once after a warm-up, and prints, per plan (the rectangular
stages, the phase-packed one), the cycles a tile: the first consumer
thread waiting for halo tiles, in the taps and in the epilogue; the first
activator waiting for TMA and activating; the issuing thread waiting for a
free halo stage. Cycles are SM clock ticks of one thread: phases of other
threads overlap them. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

_NAMES = ("halo wait", "taps", "epilogue", "total", "activator: TMA wait",
          "activator: pass", "issuer: stage wait")


def main(argv=None) -> int:
    import numpy as np
    import torch

    from endosr_torch.kernels import _build
    from endosr_torch.kernels import packed_chain as pc

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chain", choices=("up1", "tail", "both"), default="both")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_conv: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_build.REPO))
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = _build.CSRC / "packed_chain_prof.cu"
    src.write_text('#define CONV_PROFILE 1\n#include "packed_chain.cu"\n\n'
                   'extern "C" int conv_prof_read(void* dst) {\n'
                   '  return (int)cudaMemcpyFromSymbol(dst, conv_prof, '
                   'sizeof(conv_prof));\n}\n')
    _build.SOURCES[src.stem] = dict(_build.SOURCES["packed_chain"])
    try:
        _build.build_all([src.stem])
        _build.load(src.stem)
    finally:
        src.unlink()
    read = _build._LIBS[src.stem].conv_prof_read
    read.argtypes = [ctypes.c_void_p]

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = chip_smoke.make_cases(torch, torch.bfloat16, gen)["packed_g123"]
    for case in cases[:2]:
        label = "up1" if "up1" in case.name else "tail"
        if args.chain not in (label, "both"):
            continue
        a, kw = case.kernel.__defaults__
        pc.launch_wgmma(*a, **kw, lib=src.stem)
        torch.cuda.synchronize()
        before = np.zeros((2, 1024, 8), dtype=np.uint64)
        read(before.ctypes.data)
        pc.launch_wgmma(*a, **kw, lib=src.stem)
        torch.cuda.synchronize()
        after = np.zeros_like(before)
        read(after.ctypes.data)
        prof = (after - before).astype(np.float64)
        for slot, plan in ((0, "rectangular stages"), (1, "phase-packed stage")):
            blocks = prof[slot][prof[slot][:, 7] > 0]
            if not len(blocks):
                continue
            tile = blocks[:, :7].sum(0) / blocks[:, 7].sum()
            print(f"{label} chain, {plan}: {len(blocks)} blocks, "
                  f"{blocks[:, 7].mean():.1f} tiles a block; cycles a tile: "
                  + ", ".join(f"{n} {v:.0f}" for n, v in zip(_NAMES, tile)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
