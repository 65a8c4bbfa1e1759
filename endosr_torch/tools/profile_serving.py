"""Where the time of one flagship ×8 serving request goes, on one GPU.

    python -m endosr_torch.tools.profile_serving [--requests 2] [--top 25]

Builds the port's FModelDepthCond (bf16, seeded weights, full flagship
width), serves one warm-up batch-8 request (LQ 128² → SR 1024²), then
serves ``--requests`` more under ``torch.profiler`` and prints: the host
wall time per request, the summed device time per request, the device's
idle share of the window, and the kernels with the most device time
(name, calls, ms per request, share). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.ops.masks import depth_masks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")

    opt = {"is_train": False, "scale": 8, "precision": "bf16",
           "eval_bucket_multiple": 0,
           "datasets": {"test": {"depthMaskNum": 10}},
           "network_G": {"which_model_G": "DepthNet", "nf": 64, "nb": 16,
                         "depth_latent_ch": 256,
                         "which_ResBlk_depth": list(range(14))},
           "path": {}}
    model = FModelDepthCond(opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lq = torch.rand((8, 128, 128, 3), generator=gen, device="cuda")
    dep = torch.rand((8, 128, 128, 1), generator=gen, device="cuda")
    batch = {"LQ": lq, "Depth": dep,
             "DepthMaskList": depth_masks(dep[..., 0], True, 10)}
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
    print(f"device {torch.cuda.get_device_name(0)}; per request: wall "
          f"{wall * 1e3:.3f} ms, device busy {total:.3f} ms, idle share "
          f"{max(0.0, 1 - total / (wall * 1e3)):.3f}")
    print(f"{'ms/request':>10} {'share':>6} {'calls/req':>9}  kernel")
    for dev_us, count, key in rows[:args.top]:
        ms = dev_us / n / 1e3
        print(f"{ms:10.3f} {ms / total:6.3f} {count / n:9.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
