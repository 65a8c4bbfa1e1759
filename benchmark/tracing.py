"""The traced run's profile and what the per-layer metrics read from it.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (host and device
activities) and returns a :class:`Trace`: the device's operations
(kernels, copies, sets) with their start and length, the host's operations
and the harness's own spans, all on the profiler's one clock. The
program's own kernels are told from library ones by name: a device kernel
is the program's when its name holds a ``__global__`` function defined
under ``endosr_torch/csrc``.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from pathlib import Path

from benchmark.harness import ROOT

__all__ = ["Trace", "profiled", "own_kernel_names", "union_s",
           "kernel_calls"]

_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"(?:void\s+)?(\w+)\s*\(")


def own_kernel_names(csrc: Path = ROOT / "endosr_torch" / "csrc") -> set:
    """Names of every ``__global__`` function in the program's sources."""
    names = set()
    for f in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(f.read_text(errors="replace")))
    return names


def kernel_calls() -> dict:
    """{kernel wrapper: calls so far} from the program's route counters
    (every function of ``endosr_torch.kernels`` with a ``routes`` dict)."""
    import importlib

    out = {}
    for f in sorted((ROOT / "endosr_torch" / "kernels").glob("[!_]*.py")):
        mod = importlib.import_module(f"endosr_torch.kernels.{f.stem}")
        for name, obj in vars(mod).items():
            routes = getattr(obj, "routes", None)
            if callable(obj) and isinstance(routes, dict):
                out[name] = sum(routes.values())
    return out


def union_s(intervals) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


@dataclass
class Trace:
    device_ops: list               # [(name, start_ns, end_ns, kind)]
    host_ops: list                 # [(name, start_ns, end_ns)]
    spans: list                    # harness spans [(name, start_ns, end_ns)]
    window_s: float                # host seconds of the traced window
    units: int = 0                 # requests or steps traced
    frames: int = 0                # SR frames or training images traced
    extra: dict = field(default_factory=dict)
    _own: set = field(default_factory=own_kernel_names)
    _own_token: re.Pattern | None = None

    def kernels(self):
        return [op for op in self.device_ops if op[3] == "kernel"]

    def is_own(self, name: str) -> bool:
        if self._own_token is None:
            self._own_token = re.compile(
                r"\b(" + "|".join(sorted(map(re.escape, self._own))) + r")\b"
                if self._own else r"(?!)")
        return bool(self._own_token.search(name))

    def per_unit(self, value):
        """``value`` a request or step, or None when there is nothing."""
        return value / self.units if value and self.units else None

    def ms_per_frame(self, own: bool):
        """Device ms a frame (or training image) of the program's own
        kernels (True) or the libraries' (False); None when there are none."""
        s = self.kernel_s(own=own)
        return s * 1e3 / self.frames if s and self.frames else None

    def idle_pct(self):
        """1 − the union of device operations ÷ the window, in %."""
        if self.window_s <= 0 or not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return union_s((s, e) for _, s, e, _ in self.device_ops)

    def kernel_s(self, own: bool | None = None) -> float:
        """Summed seconds of kernels: the program's own (True), the
        libraries' (False) or all (None)."""
        return sum(e - s for n, s, e, _ in self.kernels()
                   if own is None or self.is_own(n) == own) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        between device operations summed by the host operation that was
        running when the gap opened (the innermost one)."""
        by = {}
        for n, s, e, _ in self.device_ops:
            by[n] = by.get(n, 0) + (e - s)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], None
        for _, s, e, _ in sorted(self.device_ops, key=lambda o: o[1]):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host_ops + self.spans, key=lambda o: o[1])
        starts = [h[1] for h in host]
        idle = {}
        for g0, g1 in gaps:
            i = bisect.bisect_right(starts, g0)
            best = None
            for j in range(i - 1, max(-1, i - 200), -1):
                n, s, e = host[j]
                if s <= g0 < e and (best is None or e - s < best[2] - best[1]):
                    best = host[j]
            if best is None:
                best = next((sp for sp in self.spans if sp[1] <= g0 < sp[2]),
                            None)
            name = best[0] if best else "(no host operation)"
            idle[name] = idle.get(name, 0) + (g1 - g0)
        gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[n, v / 1e9] for n, v in gaps_top]}


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def profiled(fn, span_names=(), sync=None):
    """(fn's result, Trace of its run). ``span_names``: the harness's
    ``record_function`` names, kept apart from the host's operations;
    ``sync`` waits for the device (default: ``torch.cuda.synchronize``)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    before = kernel_calls()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        (sync or torch.cuda.synchronize)()
        window = time.perf_counter() - t0
    dev, host, spans = [], [], []
    names = set(span_names)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if on_device:
            if name in names or getattr(ev, "is_user_annotation",
                                        lambda: False)():
                continue
            dev.append((name, s, e, _kind(name)))
        elif name in names:
            spans.append((name, s, e))
        else:
            host.append((name, s, e))
    after = kernel_calls()
    calls = {k: after[k] - before.get(k, 0) for k in after}
    return result, Trace(dev, host, spans, window, extra={"calls": calls})
