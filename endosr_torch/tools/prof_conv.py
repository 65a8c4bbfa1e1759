"""Where a ``wgmma`` kernel spends a tile, on one GPU.

    python -m endosr_torch.tools.prof_conv [--kernel packed_chain|fused_mod]
                                           [--chain up1|tail|both]
                                           [--other path/to/variant.cu]

Builds the kernel's source a second time with its phase counters compiled
in (``clock64`` readings, summed per block), runs it at the flagship shape
(bf16, B = 8, ``chip_smoke.py``'s operands) once after a warm-up, and
prints the cycles a tile. Cycles are SM clock ticks of one thread: phases
of other threads overlap them. ``--other``: profile a variant of the
kernel's ``.cu`` (with the same counters) in its place. Prints the card's
name and power limit first.

- ``packed_chain`` (``CONV_PROFILE`` in ``csrc/conv_wgmma.cuh``): the up1
  and tail chains; per plan (the rectangular stages, the phase-packed one)
  the first consumer thread waiting for halo tiles, in the taps and in the
  epilogue; the first activator waiting for TMA and activating; the
  issuing thread waiting for a free halo stage.
- ``fused_mod`` (``FM_PROFILE`` in ``csrc/fused_mod.cu``): the ``wgmma``
  route of ``fused_o_branch`` and ``fused_modulation``; the first consumer
  thread waiting for halo stages and ring tiles, in conv2's taps (their
  waits included), in the style taps and in the epilogue; the first
  producer thread waiting for a free halo stage and computing conv1 (with
  the mask's halo tile); the weight issuer waiting for a free ring stage.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

_CONV_NAMES = ("halo wait", "taps", "epilogue", "total", "activator: TMA wait",
               "activator: pass", "issuer: stage wait")
_FM_NAMES = ("halo wait", "ring wait", "conv2 taps", "style taps", "epilogue",
             "total", None, "producer: stage wait", "producer: conv1",
             "issuer: ring wait", "producer: depth window",
             "producer: conv1 weights", "producer: mask")


def _build_profiled(src_name, define, counters):
    """Build csrc/<src_name>.cu with ``define`` set and an export that copies
    the ``counters`` array out; returns (library name, reader)."""
    from endosr_torch.kernels import _build

    src = _build.CSRC / f"{src_name}_prof.cu"
    src.write_text(f'#define {define} 1\n#include "{src_name}.cu"\n\n'
                   'extern "C" int prof_read(void* dst) {\n'
                   f'  return (int)cudaMemcpyFromSymbol(dst, {counters}, '
                   f'sizeof({counters}));\n}}\n')
    _build.SOURCES[src.stem] = dict(_build.SOURCES[src_name])
    try:
        _build.build_all([src.stem])
        _build.load(src.stem)
    finally:
        src.unlink()
    read = _build._LIBS[src.stem].prof_read
    read.argtypes = [ctypes.c_void_p]
    return src.stem, read


def _delta(read, shape, run):
    """Counters gained by one ``run()`` (after a warm-up run)."""
    import numpy as np
    import torch

    run()
    torch.cuda.synchronize()
    before = np.zeros(shape, dtype=np.uint64)
    read(before.ctypes.data)
    run()
    torch.cuda.synchronize()
    after = np.zeros_like(before)
    read(after.ctypes.data)
    return (after - before).astype(np.float64)


def _packed_chain(chip_smoke, src, chain):
    import torch

    from endosr_torch.kernels import packed_chain as pc

    lib, read = _build_profiled(src, "CONV_PROFILE", "conv_prof")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = chip_smoke.make_cases(torch, torch.bfloat16, gen)["packed_g123"]
    for case in cases[:2]:
        label = "up1" if "up1" in case.name else "tail"
        if chain not in (label, "both"):
            continue
        a, kw = case.kernel.__defaults__
        prof = _delta(read, (2, 1024, 8),
                      lambda: pc.launch_wgmma(*a, **kw, lib=lib))
        for slot, plan in ((0, "rectangular stages"), (1, "phase-packed stage")):
            blocks = prof[slot][prof[slot][:, 7] > 0]
            if not len(blocks):
                continue
            tile = blocks[:, :7].sum(0) / blocks[:, 7].sum()
            print(f"{label} chain, {plan}: {len(blocks)} blocks, "
                  f"{blocks[:, 7].mean():.1f} tiles a block; cycles a tile: "
                  + ", ".join(f"{n} {v:.0f}" for n, v in zip(_CONV_NAMES, tile)),
                  flush=True)


def _fused_mod(chip_smoke, src):
    import torch

    from endosr_torch.kernels import fused_mod as fm
    from endosr_torch.kernels import fused_obranch as fo

    lib, read = _build_profiled(src, "FM_PROFILE", "fm_prof")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = chip_smoke.make_cases(torch, torch.bfloat16, gen)
    for name, launch in (("fused_o_branch", fo.launch_wgmma),
                         ("fused_modulation", fm.launch_wgmma)):
        (args,) = cases[name][0].kernel.__defaults__
        prof = _delta(read, (1024, 16), lambda: launch(*args, lib=lib))
        blocks = prof[prof[:, 6] > 0]
        tile = blocks.sum(0) / blocks[:, 6].sum()
        print(f"{name}: {len(blocks)} blocks, {blocks[:, 6].mean():.1f} tiles "
              "a block; cycles a tile: "
              + ", ".join(f"{n} {v:.0f}" for n, v in zip(_FM_NAMES, tile) if n),
              flush=True)


def main(argv=None) -> int:
    import torch

    from endosr_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("packed_chain", "fused_mod"),
                    default="packed_chain")
    ap.add_argument("--chain", choices=("up1", "tail", "both"), default="both")
    ap.add_argument("--other", type=Path, help="a variant of the kernel's .cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_conv: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_build.REPO))
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src, variant = args.kernel, None
    if args.other:
        # the variant builds beside the kernel's own source and is removed again
        variant = _build.CSRC / f"{args.kernel}_variant.cu"
        shutil.copy(args.other, variant)
        _build.SOURCES[variant.stem] = dict(_build.SOURCES[args.kernel])
        src = variant.stem
    try:
        if args.kernel == "packed_chain":
            _packed_chain(chip_smoke, src, args.chain)
        else:
            _fused_mod(chip_smoke, src)
    finally:
        if variant:
            variant.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
