"""The kernel wrappers' launch counters, moved for work that runs their
kernels without calling them.

Every public wrapper of ``endosr_torch.kernels`` that launches a ``csrc``
kernel counts its launches in ``fn.launches`` and per route in
``fn.routes``. A CUDA graph replays the kernels its capture recorded
without calling a wrapper again, and the capture itself launches nothing,
so the serving model (``models/serve_graph.py``) takes the counts a capture
added (:func:`snapshot`, :func:`since`), takes them back
(``advance(counts, -1)``) and adds them again at each replay
(:func:`advance`): the counters count launches that ran.
"""

from __future__ import annotations

import functools
import importlib
import pkgutil

__all__ = ["wrappers", "snapshot", "since", "advance"]


@functools.lru_cache(maxsize=1)
def wrappers() -> tuple:
    """Every counting wrapper (a function with a ``routes`` dict) of the
    modules of ``endosr_torch.kernels``."""
    import endosr_torch.kernels as pkg

    out = []
    for info in pkgutil.iter_modules(pkg.__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        out += [obj for obj in vars(mod).values()
                if callable(obj) and isinstance(getattr(obj, "routes", None),
                                                dict)]
    return tuple(out)


def snapshot(fns=None) -> list:
    """[(wrapper, launches, {route: launches})] of ``fns`` (default: every
    wrapper) now."""
    return [(fn, fn.launches, dict(fn.routes))
            for fn in (wrappers() if fns is None else fns)]


def since(snap) -> list:
    """The counts added since ``snap``: [(wrapper, launches, {route:
    launches})], the wrappers that counted something only."""
    out = []
    for fn, n, routes in snap:
        d = {r: fn.routes[r] - routes.get(r, 0) for r in fn.routes}
        if fn.launches != n or any(d.values()):
            out.append((fn, fn.launches - n, {r: v for r, v in d.items() if v}))
    return out


def advance(counts, times: int = 1) -> None:
    """Add ``times`` × ``counts`` (of :func:`since`) to the counters."""
    for fn, n, routes in counts:
        fn.launches += times * n
        for r, v in routes.items():
            fn.routes[r] += times * v
