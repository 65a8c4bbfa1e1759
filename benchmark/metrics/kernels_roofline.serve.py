"""The program's own kernels' share of their roofline, in %: Σ bound time
of their calls (``roofline/plan.py``, at the request's shapes) ÷ Σ their
device time. Nothing is read where the path has no plan or the counted
calls differ from it. Moves ``sr_frames_per_s``."""

from benchmark.roofline.plan import serve_plan


def read(trace, cell):
    plan = serve_plan(cell.config, cell.traffic, cell.spec.get("opt", {}))
    own = trace.kernel_s(own=True)
    if plan is None or not own or not trace.units:
        return None
    calls = trace.extra.get("calls", {})
    for name, n in calls.items():
        if n != len(plan.get(name, ())) * trace.units:
            return None
    bound = sum(sum(b) for b in plan.values()) * trace.units
    return 100.0 * bound / own
