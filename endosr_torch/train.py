"""Training entry point of the port (counterpart of the root ``train.py``).

    python -m endosr_torch.train -opt_F options/train/train_depthNet_SEAN_depthMask_x8.yml [--device cpu]
    python -m torch.distributed.run --nproc_per_node N -m endosr_torch.train -opt_F <yaml> [--device cpu]

Reads the JAX package's training YAML, seeds (``train.manual_seed``),
resolves ``path.resume_state`` (``auto``: the newest ``<iter>.state`` of the
experiment), builds the experiment tree and its ``train_*``/``val_*`` logs,
the loaders and the model, and runs the epoch and step loop:

- every ``logger.print_freq`` steps, the log line (epoch, iteration, LR,
  every loss);
- every ``train.val_freq`` steps, validation over the val set (at most
  ``val_max_images``): PSNR of ``tensor2img`` images with a ``scale``
  border cropped, SSIM on the tensors (pytorch_ssim protocol), the SR
  images saved under ``path.val_images/<image>/<image>_<iter>.png``;
- every ``logger.save_checkpoint_freq`` steps, ``{iter}_G.pth`` and
  ``{iter}.state``;
- at the end, ``latest_G.pth``.

``logger.profile_iter: N`` traces steps N to N+2 with ``torch.profiler``
(``utils/prof.py::trace``) into ``<experiment>/profile/trace_N.json``.
``use_tb_logger`` writes scalars through ``tensorboardX`` when it is
installed.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N
...``) it trains data-parallel, as the JAX ``train.py`` trains over its
mesh: the process group comes up first (``parallel/mesh.py``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``), ``opt["dist"]`` is
world > 1, each rank loads its shard of the index space at
``batch_size // world`` a batch, and the model's step is the global
batch's (``models/base.py``). Only rank 0 sets up the experiment tree,
the file logs and tensorboard, validates, saves and traces; the other
ranks log to the screen. A resume reads rank 0's files on every rank.

It runs on CUDA, and raises without a CUDA device; ``--device cpu`` runs the
plain PyTorch path on the CPU. On CUDA it turns TF32 off for the process
before it builds the model (``utils/device.py::true_fp32``), so that fp32
work is the JAX package's fp32. Resume follows the JAX ``train.py``: the
run restarts the saved epoch from its first batch, and the step count
carries on, so the batches after a resume differ from those of an
uninterrupted run, even when the save ended its epoch. The host RNG of the
mask loss's bin is not saved (as in JAX): it restarts from
``manual_seed``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import logging
import math
import os
import random
import time

import torch
import torch.distributed as dist

from endosr_torch.config import options as option
from endosr_torch.data import (create_dataloader, create_dataset,
                               prefetch_to_device)
from endosr_torch.metrics.psnr_ssim import calculate_psnr, ssim
from endosr_torch.models import create_model
from endosr_torch.parallel.mesh import get_mesh, maybe_init_distributed
from endosr_torch.utils import misc as util
from endosr_torch.utils.device import resolve_device, true_fp32
from endosr_torch.utils.prof import trace

__all__ = ["main", "validate"]

logger = logging.getLogger("base")


def parse_args(argv, description):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-opt_F", type=str, required=True,
                        help="Path to the option YAML of the SR model.")
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a CUDA "
                        "device) or cpu")
    return parser.parse_args(argv)


@torch.no_grad()
def validate(model, val_loader, opt, current_step):
    """Serve the val set (at most ``val_max_images``) and save the SR
    images; returns (mean PSNR, mean SSIM, images)."""
    cap = (opt["datasets"].get("val") or {}).get("val_max_images")
    crop = opt["scale"]
    psnr_sum = ssim_sum = 0.0
    n = 0
    for val_data in val_loader:
        n += 1
        model.feed_data(val_data)
        model.test()
        visuals = model.get_current_visuals()
        sr_img = util.tensor2img(visuals["SR"])
        gt_img = util.tensor2img(visuals["GT"])
        img_name = os.path.splitext(os.path.basename(val_data["LQ_path"][0]))[0]
        img_dir = os.path.join(opt["path"]["val_images"], img_name)
        util.mkdir(img_dir)
        util.save_img(sr_img, os.path.join(img_dir,
                                           f"{img_name}_{current_step}.png"))
        psnr_sum += calculate_psnr(sr_img[crop:-crop, crop:-crop],
                                   gt_img[crop:-crop, crop:-crop])
        sr = visuals["SR"]
        ssim_sum += float(ssim(sr[None], visuals["GT"].to(sr.device)[None])[0])
        if cap and n >= int(cap):
            break
    return psnr_sum / max(1, n), ssim_sum / max(1, n), n


def _tb_logger(opt, rank):
    if not opt.get("use_tb_logger") or "debug" in opt["name"] or rank:
        return None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logger.warning("tensorboardX unavailable; scalar logs go to file only")
        return None
    return SummaryWriter(log_dir=os.path.join(opt["path"]["root"], "tb_logger",
                                              opt["name"]))


def _train(opt, device, mesh, resume_path, resume_iter):
    rank = 0 if mesh is None else mesh.get_local_rank()
    tb = _tb_logger(opt, rank)
    opt = option.dict_to_nonedict(opt)
    pin = device.type == "cuda"

    train_loader = val_loader = None
    total_iters = int(opt["train"]["niter"])
    total_epochs = 0
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            train_set = create_dataset(dataset_opt)
            train_loader = create_dataloader(train_set, dataset_opt, opt, pin)
            train_size = len(train_loader)
            total_epochs = int(math.ceil(total_iters / max(1, train_size)))
            logger.info("Number of train images: %d, iters per epoch: %d",
                        len(train_set), train_size)
            logger.info("Total epochs needed: %d for iters %d", total_epochs,
                        total_iters)
        elif phase == "val":
            val_set = create_dataset(dataset_opt)
            val_loader = create_dataloader(val_set, dataset_opt, opt, pin)
            logger.info("Number of val images in [%s]: %d", dataset_opt["name"],
                        len(val_set))
    if train_loader is None:
        raise ValueError("the options have no datasets.train block")

    model = create_model(opt, device=device, mesh=mesh)
    model.sync_replicas()
    logger.info("Network G: %s", model.get_network_description(model.netG)[0])

    start_epoch = current_step = 0
    if resume_path:
        logger.info("Resuming training from iter: %d.", resume_iter)
        start_epoch, current_step = model.resume_training(resume_path)

    logger.info("Start training from epoch: %d, iter: %d", start_epoch,
                current_step)
    print_freq = int(opt["logger"]["print_freq"])
    val_freq = int(opt["train"]["val_freq"])
    save_freq = int(opt["logger"]["save_checkpoint_freq"])
    profile_iter = int(opt["logger"].get("profile_iter") or 0) \
        if rank == 0 else 0
    profile_dir = os.path.join(opt["path"]["experiments_root"], "profile")
    tracing = contextlib.ExitStack()

    try:
        for epoch in range(start_epoch, total_epochs + 1):
            if current_step >= total_iters:
                break
            train_loader.set_epoch(epoch)
            # ask the loader for the batches the run will step on only
            # (the prefetch reads one ahead)
            batches = itertools.islice(train_loader, total_iters - current_step)
            for batch in prefetch_to_device(batches, device):
                current_step += 1
                if profile_iter and current_step == profile_iter:
                    tracing.enter_context(trace(
                        profile_dir, f"trace_{profile_iter}",
                        cuda=device.type == "cuda"))
                elif profile_iter and current_step == profile_iter + 3:
                    tracing.close()
                    logger.info("profiler trace written to %s", profile_dir)

                model.feed_data(batch)
                model.optimize_parameters(current_step)

                if current_step % print_freq == 0 and rank == 0:
                    logs = model.get_current_log()
                    lr = model.get_current_learning_rate(current_step)
                    message = (f"<epoch:{epoch:3d}, iter:{current_step:8,d}, "
                               f"lr:{lr:.3e}> ")
                    for k, v in logs.items():
                        message += f"{k:s}: {v:.4e} "
                        if tb is not None:
                            tb.add_scalar(k, v, current_step)
                    if tb is not None:
                        tb.add_scalar("lr", lr, current_step)
                    logger.info(message)

                if (val_loader is not None and current_step % val_freq == 0
                        and rank == 0):
                    t0 = time.perf_counter()
                    psnr, ssim_v, n = validate(model, val_loader, opt,
                                               current_step)
                    ms = (time.perf_counter() - t0) * 1e3 / max(1, n)
                    logger.info("# Validation # PSNR: %.4e SSIM: %.4e "
                                "(%d images, %.1f ms an image)", psnr, ssim_v,
                                n, ms)
                    logging.getLogger("val").info(
                        "<epoch:%3d, iter:%8d> psnr: %.4e ssim: %.4e", epoch,
                        current_step, psnr, ssim_v)
                    if tb is not None:
                        tb.add_scalar("val_psnr", psnr, current_step)
                        tb.add_scalar("val_ssim", ssim_v, current_step)

                if current_step % save_freq == 0 and rank == 0:
                    logger.info("Saving models and training states.")
                    model.save(current_step)
                    model.save_training_state(epoch, current_step)

                if current_step >= total_iters:
                    break
    finally:
        tracing.close()
        if tb is not None:
            tb.close()

    if rank == 0:
        logger.info("Saving the final model.")
        model.save("latest")
    logger.info("End of training.")
    return model


def main(argv=None):
    """Train from ``-opt_F``; returns the trained model. Under ``torchrun``
    every rank runs it (the process group it brings up is taken down at
    the end)."""
    args = parse_args(argv, "Train the port from a training YAML.")
    device = resolve_device(args.device)
    own_group = not dist.is_initialized()
    maybe_init_distributed(device=device)
    own_group = own_group and dist.is_initialized()
    mesh = get_mesh()
    rank = 0 if mesh is None else mesh.get_local_rank()
    true_fp32(device)
    opt = option.parse(args.opt_F, is_train=True)

    seed = opt["train"].get("manual_seed")
    if seed is None:
        # every rank draws the seed rank 0 drew
        seed = [random.randint(1, 10000)]
        if mesh is not None:
            dist.broadcast_object_list(seed, src=0)
        seed = opt["train"]["manual_seed"] = seed[0]
    util.set_random_seed(seed)
    opt["dist"] = mesh is not None and mesh.size() > 1

    resume_iter = 0
    resume_path = option.resolve_resume_state(opt)
    if resume_path:
        resume_iter = int(os.path.basename(resume_path).split(".")[0])
        option.check_resume(opt, resume_iter)

    if rank == 0:
        option.setup_experiment_dirs(opt)
        handlers = util.setup_logger("base", opt["path"]["log"],
                                     "train_" + opt["name"], screen=True,
                                     tofile=True)
        handlers_val = util.setup_logger("val", opt["path"]["log"],
                                         "val_" + opt["name"], tofile=True)
    else:
        handlers = util.setup_logger("base", opt["path"]["log"], "train",
                                     screen=True)
        handlers_val = []
    if mesh is not None:
        dist.barrier()          # the tree is up before any rank reads it
    try:
        logger.info(option.dict2str(opt))
        return _train(opt, device, mesh, resume_path, resume_iter)
    finally:
        util.close_logger("base", handlers)
        util.close_logger("val", handlers_val)
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
