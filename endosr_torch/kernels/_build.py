"""Build and bind the port's CUDA kernels.

Each ``endosr_torch/csrc/<name>.cu`` (it may export several functions;
``*.cuh`` files are shared headers) compiles with ``nvcc`` for ``sm_90a``
into ``build/endosr_torch/lib<name>.so`` (a plain C interface, no PyTorch
headers, so a build takes seconds) and is loaded with ``ctypes``. Builds
happen at first use, from the repository's sources only; a library newer
than its sources is reused. :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.

Every exported function returns a ``cudaError_t`` from
``cudaGetLastError()`` right after its launch; :func:`check` raises on a
non-zero code, so a launch the device refused never passes silently.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["SOURCES", "build_all", "load", "check", "stream_ptr", "dtype_code"]

REPO = Path(__file__).resolve().parents[2]
CSRC = REPO / "endosr_torch" / "csrc"
BUILD = REPO / "build" / "endosr_torch"

P, I, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# library → {exported function: its argument types}; the first function
# of a library also names its ``<function>_error`` message export
SOURCES = {
    "output_stage": {
        "output_stage_x8": [I, P, I64, I64, I64, I, I, I, F32, F32, P, P],
        "output_stage_x8_vec16": [I, P, I64, I64, I64, I, I, I, F32, F32, P,
                                  P],
        "output_stage": [I, P, I64, I64, I64, I, I, I, I, I, F32, F32, P, P],
        "output_stage_vec16": [I, P, I64, I64, I64, I, I, I, I, I, F32, F32, P,
                               P]},
    "head_dot": {
        "head_dot": [I, P, I64, I64, I64, I, I, I, I, P, P, P, P, I, P],
        "head_dot_wgmma": [P, I64, I64, I64, I, I, I, I, I, P, P, P, P, P]},
    "packed_chain": {
        "packed_stage": [I, P, I64, I64, I64, I, I, I, I, I, I, I, P, I, P, P,
                         I, I, P, I64, I64, I64, I, P, I64, I64, I64, I, I, P],
        "packed_stage_wgmma": [P, I64, I64, I64, I, I, I, I, I, I, I, P, I, P,
                               P, I, P, I64, I64, I64, P, I64, I64, I64, I, I,
                               P]},
    "style_dot": {
        "style_blend_dot": [I, P, I64, I64, P, P, I64, I64, I64, I, P, P, I64,
                            I64, I64, I, I, I, I, I, P],
        "style_dot_hwbm": [I, P, P, P, I64, I64, I64, I, I, I, I, I, P],
        "style_dot_tc": [P, P, P, I, I, I, I, P],
        "style_blend_tc": [P, I64, I64, P, P, I64, I64, I64, I, P, P, I, I, I, I,
                           I, P]},
    "in_stats": {
        "in_stats": [I, P, I64, I64, I64, I, I, I, I, I, P, P, P],
        "in_stats_vec16": [I, P, I64, I64, I64, I, I, I, I, I, I, P, P, P, P]},
    "fused_in_mod": {
        "fused_in_mod": [I, P, I64, I64, I64, P, I64, I64, I64, P, I64, I64,
                         I64, I, I, I, I, I, F32, P, P, P, P],
        "fused_in_mod_vec16": [I, P, I64, I64, I64, P, I64, I64, I64, P, I64,
                               I64, I64, I, I, I, I, I, I, F32, P, P, P, P,
                               P]},
    "fused_mod": {
        "fused_modulation": [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
        "fused_o_branch": [I, P, P, P, P, P, P, I, I, I, I, I, P],
        "fused_mod_wgmma": [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]},
    "fused_tail": {
        "fused_tail": [I, P, I64, I64, I64, I, I, I, I, P, P, P, F32, F32, P, P],
        "fused_tail_wgmma": [P, I64, I64, I64, I, I, I, I, I, P, P, P, F32, F32, P,
                             P]},
    "shuffle_mid": {
        "mid_shuffle": [I, P, P, I, I, I, I, I, I, P],
        "mid_shuffle_vec16": [I, P, P, I, I, I, I, I, P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "endosr_torch's kernels")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    t = lib.stat().st_mtime
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(d.stat().st_mtime > t for d in deps)


def build_all(names=None) -> dict[str, float]:
    """Compile the given (default: all) kernel sources that are missing or
    stale, one ``nvcc`` process per source, all started together. Returns
    {name: seconds} for the sources built; raises with nvcc's output on a
    failure. ``ptxas`` resource usage goes to ``build/endosr_torch/<name>.log``."""
    import time

    names = [n for n in (names or SOURCES) if _stale(n)]
    if not names:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(_lib_path(n)) + ".tmp", str(CSRC / f"{n}.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    times, failed = {}, []
    for n, p in procs.items():
        out, _ = p.communicate()
        times[n] = time.perf_counter() - t0
        (BUILD / f"{n}.log").write_text(out)
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{out}")
        else:
            os.replace(str(_lib_path(n)) + ".tmp", _lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str, fn: str | None = None):
    """The bound C function ``fn`` (default: the first) of kernel library
    ``name``, which is built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn_name, argtypes in SOURCES[name].items():
            f = getattr(lib, fn_name)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        err = getattr(lib, next(iter(SOURCES[name])) + "_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return getattr(lib, fn or next(iter(SOURCES[name])))


def check(name: str, code: int, fn: str | None = None) -> None:
    """Raise if a launch of library ``name`` returned a CUDA error."""
    if code != 0:
        first = next(iter(SOURCES[name]))
        msg = getattr(_LIBS[name], first + "_error")(code)
        raise RuntimeError(f"{fn or first} launch failed: "
                           f"{msg.decode()} ({code})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dt: torch.dtype) -> int:
    if dt == torch.float32:
        return 0
    if dt == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dt}")
