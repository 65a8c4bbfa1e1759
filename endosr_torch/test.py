"""Evaluation entry point of the port (counterpart of the root ``test.py``).

    python -m endosr_torch.test -opt_F options/test/test_depthNet.yml [--device cpu]
    python -m torch.distributed.run --nproc_per_node N -m endosr_torch.test -opt_F <yaml with spatial_shard: N>

Loads ``path.pretrain_model_G``, serves every image of every test set
through ``FModelDepthCond.test`` (bucketed unless the YAML sets
``eval_bucket_multiple: 0``), writes the SR images as
``results/<name>/x<scale>/<image><suffix>.png`` and the scores as
``results/<name>/result_x<scale>.tsv``: a header, one row an image (PSNR
and SSIM on RGB and on Y, a ``scale`` border cropped, MATLAB protocol) and
an ``Average`` row. Without ``precision`` in the YAML, ×4 and ×8 serve in
bf16 and ×2 and ×3 in ``bf16c3`` (3-pass centered bf16 convs, unbucketed),
as the JAX ``test.py`` selects.

It runs on CUDA, and raises without a CUDA device; ``--device cpu`` runs the
plain PyTorch path on the CPU. On CUDA it turns TF32 off for the process
before it builds the model (``utils/device.py::true_fp32``), so that fp32
work is the JAX package's fp32.

Under ``torchrun`` with ``spatial_shard: N`` in the YAML, the N ranks
serve every image together, each the rows of its slab
(``parallel/spatial.py``); each rank ends with the whole SR, and only
rank 0 writes the images, the TSV and the log file.
"""

from __future__ import annotations

import logging
import os
import os.path as osp

import torch.distributed as dist

from endosr_torch.config import options as option
from endosr_torch.data import create_dataloader, create_dataset
from endosr_torch.metrics.psnr_ssim import calculate_psnr, calculate_ssim
from endosr_torch.models import create_model
from endosr_torch.ops.color import bgr2ycbcr
from endosr_torch.parallel.mesh import get_mesh, maybe_init_distributed
from endosr_torch.train import parse_args
from endosr_torch.utils import misc as util
from endosr_torch.utils.device import resolve_device, true_fp32

__all__ = ["main"]

logger = logging.getLogger("base")


def _scores(sr_img, gt_img, crop):
    """(PSNR, SSIM, PSNR_Y, SSIM_Y) of two uint8 BGR images."""
    sr_c, gt_c = sr_img[crop:-crop, crop:-crop], gt_img[crop:-crop, crop:-crop]
    sr_y = bgr2ycbcr(sr_img.astype("float64") / 255.0, only_y=True) * 255
    gt_y = bgr2ycbcr(gt_img.astype("float64") / 255.0, only_y=True) * 255
    sr_yc, gt_yc = sr_y[crop:-crop, crop:-crop], gt_y[crop:-crop, crop:-crop]
    return (calculate_psnr(sr_c, gt_c), calculate_ssim(sr_c, gt_c),
            calculate_psnr(sr_yc, gt_yc), calculate_ssim(sr_yc, gt_yc))


def _evaluate(opt, device, mesh=None):
    if opt.get("precision") is None:
        opt["precision"] = "bf16" if int(opt["scale"]) >= 4 else "bf16c3"
        logger.info("precision auto-selected: %s (x%d serving)",
                    opt["precision"], int(opt["scale"]))
    pin = device.type == "cuda"
    test_loaders = []
    for _, dataset_opt in sorted(opt["datasets"].items()):
        test_set = create_dataset(dataset_opt)
        test_loaders.append((dataset_opt, create_dataloader(
            test_set, dataset_opt, pin_memory=pin)))
        logger.info("Number of test images in [%s]: %d", dataset_opt["name"],
                    len(test_set))

    model = create_model(opt, device=device, mesh=mesh)
    writes = mesh is None or mesh.get_local_rank() == 0
    scale = opt["scale"]
    for dataset_opt, test_loader in test_loaders:
        logger.info("Testing [%s]...", dataset_opt["name"])
        dataset_dir = osp.join(opt["path"]["results_root"], f"x{scale}")
        tsv_path = osp.join(opt["path"]["results_root"], f"result_x{scale}.tsv")
        if writes:
            util.mkdir(dataset_dir)
        else:
            tsv_path = os.devnull
        sums = [0.0] * 4
        count = 0
        with open(tsv_path, "w") as tsv:
            tsv.write("Name\tPSNR\tSSIM\tPSNR_Y\tSSIM_Y\n")
            for data in test_loader:
                model.feed_data(data)
                model.test()
                visuals = model.get_current_visuals()
                sr_img = util.tensor2img(visuals["SR"])
                img_name = osp.splitext(osp.basename(data["LQ_path"][0]))[0]
                if writes:
                    util.save_img(sr_img, osp.join(
                        dataset_dir,
                        img_name + (opt.get("suffix") or "") + ".png"))
                if data.get("GT") is None:
                    tsv.write("\t".join([img_name, "0", "0", "0", "0"]) + "\n")
                    logger.info("%s (no GT)", img_name)
                    continue
                scores = _scores(sr_img, util.tensor2img(visuals["GT"]), scale)
                sums = [a + b for a, b in zip(sums, scores)]
                count += 1
                tsv.write("\t".join([img_name] + [f"{v:.6f}" for v in scores])
                          + "\n")
                logger.info("%s - PSNR: %.6f dB; SSIM: %.6f; PSNR_Y: %.6f dB; "
                            "SSIM_Y: %.6f.", img_name, *scores)
            if count:
                means = [v / count for v in sums]
                tsv.write("\t".join(["Average"] + [f"{v:.6f}" for v in means])
                          + "\n")
                logger.info("----Average PSNR/SSIM results for %s----\n\t"
                            "PSNR: %.6f dB; SSIM: %.6f; PSNR_Y: %.6f dB; "
                            "SSIM_Y: %.6f.", dataset_opt["name"], *means)
    return model


def main(argv=None):
    """Evaluate from ``-opt_F``; returns the model. Under ``torchrun``
    every rank runs it (the process group it brings up is taken down at
    the end)."""
    args = parse_args(argv, "Evaluate the port from a test YAML.")
    device = resolve_device(args.device)
    own_group = not dist.is_initialized()
    maybe_init_distributed(device=device)
    own_group = own_group and dist.is_initialized()
    mesh = get_mesh()
    rank = 0 if mesh is None else mesh.get_local_rank()
    true_fp32(device)
    opt = option.parse(args.opt_F, is_train=False)
    if rank == 0:
        util.mkdirs(
            path for key, path in opt["path"].items()
            if key != "experiments_root" and "pretrain_model" not in key
            and "resume" not in key and isinstance(path, str))
    handlers = util.setup_logger("base", opt["path"]["log"],
                                 "test_" + opt["name"], screen=True,
                                 tofile=rank == 0)
    try:
        logger.info(option.dict2str(opt))
        util.set_random_seed(0)
        return _evaluate(option.dict_to_nonedict(opt), device, mesh)
    finally:
        util.close_logger("base", handlers)
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
