"""Where the time of one flagship serving request, or one training step,
goes on one GPU.

    python -m endosr_torch.tools.profile_serving [--config x8] [--requests 2] [--top 25]

Builds the port's FModelDepthCond (bf16, seeded weights, full flagship
width) in one of its configurations, serves one warm-up batch-8 request,
then serves ``--requests`` more under ``torch.profiler`` and prints: the
host wall time per request, the summed device time per request, the
device's idle share of the window, and the kernels with the most device
time (name, calls, ms per request, share). Needs a CUDA device.

``--config train_x8`` profiles training steps in place of requests: the
flagship recipe (``models/recipes.py``: the ×8 YAML's ``train:`` block),
bf16, a seeded uint8 batch 8 of LQ 128² / GT 1024² on the card, one
warm-up step, then ``--requests`` steps; it also prints the peak device
memory of the steps.

``--config``: ``x8`` — ×8, ``eval_bucket_multiple: 0``, LQ 128² → SR 1024²;
``x2`` — the ×2 YAML's network (all 16 blocks depth blocks, latent 32),
``eval_bucket_multiple: 0``, LQ 512² → SR 1024²;
``x8_bucketed`` — ×8 with the key unset (bucket 32), LQ 120×112 fed from
the host → SR 960×896 through the masked forward; ``x4_fused`` — ×4 with
``net_kw: {fused_epilogue: true, in_stats: kernel}``, LQ 128² → SR 512²;
and the ×8 request of ``x8`` through ``net_kw``: ``x8_obranch``
(``pallas_obranch``, the
hoisted trunk through ``fused_o_branch``), ``x8_fused_mod``
(``fused_modulation``), ``x8_fused_tail`` (``pallas_tail``), ``x8_hoisted``
(``lazy_branches: false``, the hoisted trunk in plain PyTorch),
and ``x8_plain`` (``preset: plain``). ``--precision`` (default ``bf16``):
``fp32``, ``bf16``, ``mixed``, ``bf16c`` or ``bf16c3``.
"""

from __future__ import annotations

import argparse
import time


# name → (scale, LQ height and width, requests fed from the host, top-level
# options, network_G options)
_X8 = (8, (128, 128), False, {"eval_bucket_multiple": 0})
_CONFIGS = {
    "x8": (*_X8, {}),
    "x8_obranch": (*_X8, {"net_kw": {"pallas_obranch": True}}),
    "x8_fused_mod": (*_X8, {"net_kw": {"fused_modulation": True}}),
    "x8_fused_tail": (*_X8, {"net_kw": {"pallas_tail": True}}),
    "x8_hoisted": (*_X8, {"net_kw": {"lazy_branches": False}}),
    "x8_plain": (*_X8, {"preset": "plain"}),
    "x8_bucketed": (8, (120, 112), True, {}, {}),
    "x4_fused": (4, (128, 128), False, {},
                 {"net_kw": {"fused_epilogue": True, "in_stats": "kernel"}}),
    "x2": (2, (512, 512), False, {"eval_bucket_multiple": 0},
           {"depth_latent_ch": 32, "which_ResBlk_depth": list(range(16))}),
    "train_x8": None,
}


def _train_model(torch):
    """The flagship training model and one step's seeded uint8 batch."""
    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.models.recipes import x8_train_opt
    from endosr_torch.ops.masks import depth_masks

    model = FModelDepthCond(x8_train_opt("bf16"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=torch.uint8)

    dep = torch.rand((8, 128, 128, 1), generator=gen, device="cuda")
    model.feed_data({"LQ": u8(8, 128, 128, 3), "GT": u8(8, 1024, 1024, 3),
                     "Depth": dep, "DepthMaskList": depth_masks(
                         dep[..., 0], False, 10).to(torch.uint8)})
    return model, model.optimize_parameters


def device_kernels(torch, run, n):
    """``run()`` ``n`` times under ``torch.profiler``, synchronised. Returns
    (host seconds per call, [(device µs, calls, kernel name)] of the device
    kernels, largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    rows = []
    for e in prof.key_averages():
        # device kernels only: a user annotation's row (the optimizer's
        # ``Optimizer.step#Adam.step``) spans kernels already counted
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    return wall, rows


def main(argv=None) -> int:
    import torch

    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.ops.masks import depth_masks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="x8", choices=sorted(_CONFIGS))
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--precision", default="bf16",
                    choices=["fp32", "bf16", "mixed", "bf16c", "bf16c3"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")

    what = "step" if args.config == "train_x8" else "request"
    if args.config == "train_x8":
        model, run = _train_model(torch)
    else:
        scale, (h, w), on_host, top, net = _CONFIGS[args.config]
        opt = {"is_train": False, "scale": scale,
               "precision": args.precision, **top,
               "datasets": {"test": {"depthMaskNum": 10}},
               "network_G": {"which_model_G": "DepthNet", "nf": 64, "nb": 16,
                             "depth_latent_ch": 256,
                             "which_ResBlk_depth": list(range(14)), **net},
               "path": {}}
        model = FModelDepthCond(opt)
        gen = torch.Generator(device="cuda").manual_seed(0)
        lq = torch.rand((8, h, w, 3), generator=gen, device="cuda")
        dep = torch.rand((8, h, w, 1), generator=gen, device="cuda")
        batch = {"LQ": lq, "Depth": dep,
                 "DepthMaskList": depth_masks(dep[..., 0], True, 10)}
        if on_host:     # as a data loader hands a request over
            batch = {k: v.cpu().numpy() for k, v in batch.items()}

        def run():
            model.feed_data(batch)
            model.test()
    run()
    run()       # a serving request's second call captures its CUDA graph
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    n = args.requests
    wall, rows = device_kernels(torch, run, n)
    total = sum(r[0] for r in rows) / n / 1e3
    print(f"config {args.config} {args.precision}; device "
          f"{torch.cuda.get_device_name(0)}; "
          f"per {what}: wall "
          f"{wall * 1e3:.3f} ms, device busy {total:.3f} ms, idle share "
          f"{max(0.0, 1 - total / (wall * 1e3)):.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{'ms/' + what:>10} {'share':>6} {'calls/' + what[:3]:>9}  kernel")
    for dev_us, count, key in rows[:args.top]:
        ms = dev_us / n / 1e3
        print(f"{ms:10.3f} {ms / total:6.3f} {count / n:9.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
