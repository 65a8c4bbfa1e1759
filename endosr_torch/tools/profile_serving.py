"""Where the time of one flagship serving request goes, on one GPU.

    python -m endosr_torch.tools.profile_serving [--config x8] [--requests 2] [--top 25]

Builds the port's FModelDepthCond (bf16, seeded weights, full flagship
width) in one of three configurations, serves one warm-up batch-8 request,
then serves ``--requests`` more under ``torch.profiler`` and prints: the
host wall time per request, the summed device time per request, the
device's idle share of the window, and the kernels with the most device
time (name, calls, ms per request, share). Needs a CUDA device.

``--config``: ``x8`` — ×8, ``eval_bucket_multiple: 0``, LQ 128² → SR 1024²;
``x8_bucketed`` — ×8 with the key unset (bucket 32), LQ 120×112 fed from
the host → SR 960×896 through the masked forward; ``x4_fused`` — ×4 with
``fused_epilogue`` and ``in_stats: kernel``, LQ 128² → SR 512².
"""

from __future__ import annotations

import argparse
import time


# name → (scale, LQ height and width, requests fed from the host, top-level
# options, network_G options)
_CONFIGS = {
    "x8": (8, (128, 128), False, {"eval_bucket_multiple": 0}, {}),
    "x8_bucketed": (8, (120, 112), True, {}, {}),
    "x4_fused": (4, (128, 128), False, {},
                 {"fused_epilogue": True, "in_stats": "kernel"}),
}


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.ops.masks import depth_masks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="x8", choices=sorted(_CONFIGS))
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")

    scale, (h, w), on_host, top, net = _CONFIGS[args.config]
    opt = {"is_train": False, "scale": scale, "precision": "bf16", **top,
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
    model.feed_data(batch)
    model.test()
    torch.cuda.synchronize()

    n = args.requests
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            model.feed_data(batch)
            model.test()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:   # device kernels only
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows) / n / 1e3
    print(f"config {args.config}; device {torch.cuda.get_device_name(0)}; "
          f"per request: wall "
          f"{wall * 1e3:.3f} ms, device busy {total:.3f} ms, idle share "
          f"{max(0.0, 1 - total / (wall * 1e3)):.3f}")
    print(f"{'ms/request':>10} {'share':>6} {'calls/req':>9}  kernel")
    for dev_us, count, key in rows[:args.top]:
        ms = dev_us / n / 1e3
        print(f"{ms:10.3f} {ms / total:6.3f} {count / n:9.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
