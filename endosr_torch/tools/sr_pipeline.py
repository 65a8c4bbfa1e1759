"""One-command SR serving pipeline of the port: LR frames → depth maps →
masks → SR PNGs (counterpart of ``scripts/sr_pipeline.py``).

    python -m endosr_torch.tools.sr_pipeline --input LR_dir --output out_dir \\
        --model latest_G.pth (or a .npz of JAX parameters) --scale 8 \\
        [--depth_weights weights_19_dir | --depth_dir npy_dir] \\
        [--precision bf16] [--batch 8] [--mask_num 10] [--device cpu]

With ``--depth_weights`` the depth maps are made first with the port's
monodepth2 producer (``depth/infer.py::run_folder``, into
``<output>/depth``); with ``--depth_dir`` existing ``<stem>_disp.npy``
files are read. Frames of one shape are served together, ``--batch`` at a
time, through ``FModelDepthCond.test`` (the flagship DepthNet: every block
a depth block; ``--bucket`` pads to a multiple, 0 serves each shape as it
is). The masks are ``ops/masks.py::depth_masks_np`` of each depth map.

It runs on CUDA unless ``--device cpu`` is given, and raises without a
CUDA device; on CUDA it turns TF32 off, as the entry points do.

``--spatial`` splits each frame's height across the ranks of a
``torchrun`` launch (``python -m torch.distributed.run --nproc_per_node N
-m endosr_torch.tools.sr_pipeline --spatial ...``): every rank reads the
same frames and serves its slab of rows through
``parallel/spatial.py::spatial_forward`` (DepthNet's unmasked forward, as
``scripts/sr_pipeline.py`` serves it: H a multiple of N and ≥ 4·N);
rank 0 alone writes the depth maps and the PNGs.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import numpy as np

__all__ = ["main", "build_model", "ensure_depth", "parse_args"]


def build_model(args, device):
    """The serving model of the flags (``scripts/sr_pipeline.py:29-49``)."""
    from endosr_torch.models.f_depthcond import FModelDepthCond

    opt = {
        "is_train": False,
        "model": "sftmd_depthCond",
        "scale": args.scale,
        "precision": args.precision,
        "eval_bucket_multiple": args.bucket,
        "datasets": {"test": {"phase": "test", "depthMaskNum": args.mask_num,
                              "LR_size": 32}},
        "network_G": {
            "which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3,
            "nf": args.nf, "nb": args.nb, "depth_latent_ch": args.latent,
            "use_trainable_params": True,
            "which_ResBlk_depth": list(range(14)),
        },
        "path": {"pretrain_model_G": args.model, "strict_load": True},
    }
    return FModelDepthCond(opt, device=device)


def ensure_depth(args, names, device):
    """{stem: the path of its ``_disp.npy``}, made first with
    ``--depth_weights``."""
    stems = [os.path.splitext(os.path.basename(n))[0] for n in names]
    if args.depth_dir:
        out = {s: os.path.join(args.depth_dir, s + "_disp.npy") for s in stems}
        for p in out.values():
            if not os.path.exists(p):
                sys.exit(f"missing depth map: {p}")
        return out
    if not args.depth_weights:
        sys.exit("need --depth_weights or --depth_dir")
    from endosr_torch.depth.infer import run_folder

    depth_out = os.path.join(args.output, "depth")
    os.makedirs(depth_out, exist_ok=True)
    run_folder(args.input, args.depth_weights, output_dir=depth_out,
               save_colormap=False, device=device)
    return {s: os.path.join(depth_out, s + "_disp.npy") for s in stems}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True, help="LR image folder")
    ap.add_argument("--output", required=True)
    ap.add_argument("--model", required=True,
                    help="generator .pth (state_dict) or .npz (JAX params)")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--depth_weights", help="monodepth2 weights folder")
    ap.add_argument("--depth_dir", help="folder with existing *_disp.npy")
    ap.add_argument("--precision", default=None, choices=[None, "bf16"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mask_num", type=int, default=10)
    ap.add_argument("--bucket", type=int, default=0,
                    help="pad eval shapes to this multiple (0 = exact)")
    ap.add_argument("--nf", type=int, default=64)
    ap.add_argument("--nb", type=int, default=16)
    ap.add_argument("--latent", type=int, default=256)
    ap.add_argument("--fixed_range", action="store_true", default=True)
    ap.add_argument("--spatial", action="store_true",
                    help="shard each frame's height across the ranks of a "
                         "torchrun launch (needs H >= 4x the rank count)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the pipeline; returns {stem: the SR PNG's path}."""
    from endosr_torch.data import util as dutil
    from endosr_torch.ops.masks import depth_masks_np
    from endosr_torch.utils.device import resolve_device, true_fp32
    from endosr_torch.utils.misc import save_img, tensor2img

    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh, started = None, False
    if args.spatial:
        import torch.distributed as dist

        from endosr_torch.parallel.mesh import get_mesh, maybe_init_distributed

        started = not dist.is_initialized()
        if not maybe_init_distributed(device=device):
            raise RuntimeError("--spatial shards a frame over the ranks of a "
                               "torchrun launch: run it under "
                               "python -m torch.distributed.run")
        mesh = get_mesh()
    writes = mesh is None or mesh.get_local_rank() == 0
    true_fp32(device)
    names = dutil.get_image_paths("img", args.input)
    if writes:
        os.makedirs(args.output, exist_ok=True)
        depth_paths = ensure_depth(args, names, device)
    if mesh is not None:
        depth_paths = [depth_paths if writes else None]
        dist.broadcast_object_list(depth_paths, src=0)
        depth_paths = depth_paths[0]
    model = build_model(args, device)

    # same-shape frames are served together
    groups: dict = collections.defaultdict(list)
    for p in names:
        img = dutil.read_img(None, p)                    # HWC BGR [0, 1]
        stem = os.path.splitext(os.path.basename(p))[0]
        dm = np.squeeze(np.load(depth_paths[stem]), axis=1)[0]
        masks = depth_masks_np(dm, args.fixed_range, args.mask_num)
        groups[img.shape].append((stem, img[:, :, ::-1], dm[..., None], masks))

    written = {}
    for items in groups.values():
        for i in range(0, len(items), args.batch):
            chunk = items[i:i + args.batch]
            batch = {
                "LQ": np.stack([c[1] for c in chunk]).astype(np.float32),
                "Depth": np.stack([c[2] for c in chunk]).astype(np.float32),
                "DepthMaskList": np.stack([c[3] for c in chunk]).astype(
                    np.float32)}
            if mesh is not None:
                from endosr_torch.parallel.spatial import spatial_forward

                sr = model.fake_SR = spatial_forward(
                    model.netG, None, batch["LQ"], batch["Depth"],
                    batch["DepthMaskList"], mesh=mesh)
            else:
                model.feed_data(batch)
                sr = model.test()
            for j, (stem, *_) in enumerate(chunk):
                written[stem] = os.path.join(args.output, stem + ".png")
                if writes:
                    save_img(tensor2img(sr[j]), written[stem])
    if started:
        dist.destroy_process_group()
    print(f"wrote {len(written)} SR frames to {args.output}")
    return written


if __name__ == "__main__":
    main()
