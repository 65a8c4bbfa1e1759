"""The self-supervised monodepth2 trainer (counterpart of
``endosr/depth/trainer.py``).

A depth encoder and decoder and a pose encoder and decoder (or a PoseCNN)
are trained by view synthesis: each source frame is warped into the
target through the predicted depth and pose (back-projection, projection,
bilinear ``grid_sample``), and the loss is the per-pixel minimum of the
SSIM + L1 reprojection errors, with auto-masking by the unwarped frames'
errors and an edge-aware smoothness term (:func:`monodepth_loss`).

Supported, as in the JAX trainer: monocular frames [0, -1, 1],
``separate_resnet`` (``shared`` builds a separate encoder too) or
``posecnn`` pose, auto-masking on or off, minimum or average
reprojection, SSIM on or off, ``v1_multiscale``, and stereo training
(``use_stereo`` or an ``'s'`` frame takes its camera transform from the
dataset's ``stereo_T``; stereo alone, [0, 's'], runs without pose
networks).

What the port keeps of the JAX trainer, on purpose:

- In training the encoders' BatchNorms normalise by the batch's
  statistics and their running statistics never change (momentum 0,
  ``nn/monodepth.py::freeze_running_stats``): JAX discards the statistics
  it computes (``ROADMAP.md`` C8), so evaluation and every saved encoder
  keep the initial ones.
- The LR is ``learning_rate · 0.1^(step // (steps_per_epoch ·
  scheduler_step_size))`` with ``steps_per_epoch = len(dataset) //
  batch_size``, set by :meth:`Trainer.run_epoch`; Adam (β 0.9 / 0.999,
  ε 1e-8) covers every parameter, the BatchNorms' too.
- The auto-mask's tie-break noise, N(0, 1)·1e-5, is drawn once a scale
  from the source :meth:`Trainer.noise` gives for the step (a
  ``torch.Generator`` seeded with it; JAX splits ``PRNGKey(step)``).
- Batches: an epoch's order is a permutation from the trainer's
  ``numpy.random.RandomState(seed)`` (JAX: the global ``np.random``), the
  last partial batch dropped; flips and jitter come from the dataset's
  ``rng``. With ``num_workers`` 0 the items are made in this process in
  that order, as JAX makes them; with workers (spawned once, kept from
  epoch to epoch, never touching CUDA), batch i of an epoch goes to
  worker i mod n, and each worker draws from its copy of the dataset's
  ``rng`` reseeded with ``seed · 1000003 + worker id``.

Checkpoints are monodepth2's files: ``weights_{epoch}/encoder.pth`` (with
``height``, ``width``, ``use_stereo``), ``depth.pth``, ``pose_encoder.pth``,
``pose.pth`` and ``adam.pth`` (the optimizer state and the step).
``utils/port_params.py::load_monodepth``, ``depth/infer.py::run_folder``
and the JAX package's porters read them. Under ``ENDOSR_CKPT_BACKEND=
msgpack`` (or ``orbax``) the trainer writes JAX's folder instead
(``endosr/depth/trainer.py:386-407``): ``{encoder,depth,pose_encoder,
pose}.ckpt`` (each network's flax variables), ``meta.json`` (the feed
size, the stereo flag, the step) and ``adam.ckpt`` (optax's Adam and
schedule states), each ``.ckpt`` a file or, under ``orbax``, a
directory.
:meth:`Trainer.load_model` reads either folder.

The trainer runs on CUDA unless the options say ``--no_cuda``, and raises
without a CUDA device (``utils/device.py::resolve_device``); on CUDA it
turns TF32 off for the process (``true_fp32``). Everything here is plain
PyTorch (cuDNN convolutions, ``F.grid_sample``): the JAX package computes
it outside any Pallas kernel.
"""

from __future__ import annotations

import json
import os
import random
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.data import DataLoader, get_worker_info

from endosr_torch.data import collate
from endosr_torch.depth.layers import (backproject_depth, disp_to_depth,
                                       get_smooth_loss, grid_sample,
                                       project_3d, ssim_monodepth,
                                       transformation_from_parameters)
from endosr_torch.nn.layers import torch_conv_init_
from endosr_torch.nn.monodepth import (DepthDecoder, PoseCNN, PoseDecoder,
                                       ResnetEncoder, freeze_running_stats)
from endosr_torch.utils import checkpoint as ckpt
from endosr_torch.utils import optim_state as ost
from endosr_torch.utils.device import resolve_device, true_fp32
from endosr_torch.utils.port_params import (from_flax_depth_trainer,
                                            load_monodepth_file,
                                            to_flax_depth_trainer)

__all__ = ["Trainer", "monodepth_loss"]


def monodepth_loss(models, inputs, opt, noise=None):
    """Outputs and losses of one batch.

    ``models``: {"encoder", "depth" and, with pose networks, "pose" (a
    PoseDecoder over "pose_encoder", or a PoseCNN)}, in the mode the
    caller set (``train()``: BatchNorm by batch statistics). ``inputs``:
    ('color', f, s) and ('color_aug', f, 0) NCHW images for f in the
    frame ids, ('K', s) / ('inv_K', s) [B, 4, 4] and, for an 's' frame,
    "stereo_T". ``opt``: :meth:`Trainer.loss_opt`'s dict. ``noise``: a
    callable (NCHW shape) → tensor of N(0, 1) draws, called once a scale
    unless auto-masking is off. Returns (total loss, {"loss/<s>", "loss"},
    outputs)."""
    frame_ids = tuple(opt["frame_ids"])
    scales = tuple(opt["scales"])
    height, width = opt["height"], opt["width"]
    v1 = opt.get("v1_multiscale")
    automask = not opt.get("disable_automasking")

    outputs = dict(models["depth"](models["encoder"](
        inputs[("color_aug", 0, 0)])))

    # poses: pairs in temporal order; the stereo frame's "pose" is the
    # rig's fixed extrinsic from the dataset
    for f_i in frame_ids[1:]:
        if f_i == "s":
            outputs[("cam_T_cam", 0, "s")] = inputs["stereo_T"]
            continue
        pair = [inputs[("color_aug", f_i, 0)], inputs[("color_aug", 0, 0)]]
        if f_i > 0:
            pair.reverse()
        stacked = torch.cat(pair, 1)
        if opt.get("pose_model_type", "separate_resnet") == "posecnn":
            axisangle, translation = models["pose"](stacked)
        else:
            axisangle, translation = models["pose"](
                [models["pose_encoder"](stacked)])
        outputs[("axisangle", 0, f_i)] = axisangle
        outputs[("translation", 0, f_i)] = translation
        outputs[("cam_T_cam", 0, f_i)] = transformation_from_parameters(
            axisangle[:, 0], translation[:, 0], invert=f_i < 0)

    # view synthesis
    for scale in scales:
        disp = outputs[("disp", scale)]
        if v1:
            source_scale = scale
        else:
            disp = F.interpolate(disp, (height, width), mode="bilinear",
                                 align_corners=False)
            source_scale = 0
        _, depth = disp_to_depth(disp, opt["min_depth"], opt["max_depth"])
        outputs[("depth", 0, scale)] = depth
        h_s, w_s = height >> source_scale, width >> source_scale
        cam_points = backproject_depth(depth, inputs[("inv_K", source_scale)])
        for f_i in frame_ids[1:]:
            pix = project_3d(cam_points, inputs[("K", source_scale)],
                             outputs[("cam_T_cam", 0, f_i)], h_s, w_s)
            outputs[("color", f_i, scale)] = grid_sample(
                inputs[("color", f_i, source_scale)], pix)

    def reprojection(pred, target):
        l1 = torch.abs(target - pred).mean(1, keepdim=True)
        if opt.get("no_ssim"):
            return l1
        ssim = ssim_monodepth(pred, target).mean(1, keepdim=True)
        return 0.85 * ssim + 0.15 * l1

    losses = {}
    total = 0.0
    for scale in scales:
        source_scale = scale if v1 else 0
        disp = outputs[("disp", scale)]
        color = inputs[("color", 0, scale)]
        target = inputs[("color", 0, source_scale)]
        reproj = torch.cat([reprojection(outputs[("color", f_i, scale)], target)
                            for f_i in frame_ids[1:]], 1)
        if automask:
            ident = torch.cat(
                [reprojection(inputs[("color", f_i, source_scale)], target)
                 for f_i in frame_ids[1:]], 1)
            ident = ident + noise(ident.shape) * 1e-5
        if opt.get("avg_reprojection"):
            reproj = reproj.mean(1, keepdim=True)
            if automask:
                ident = ident.mean(1, keepdim=True)
        combined = torch.cat([ident, reproj], 1) if automask else reproj
        to_optimise = (combined[:, 0] if combined.shape[1] == 1
                       else combined.min(1).values)
        loss = to_optimise.mean()

        mean_disp = disp.mean((2, 3), keepdim=True)
        smooth = get_smooth_loss(disp / (mean_disp + 1e-7), color)
        loss = loss + opt["disparity_smoothness"] * smooth / (2 ** scale)
        total = total + loss
        losses[f"loss/{scale}"] = loss
    total = total / len(scales)
    losses["loss"] = total
    return total, losses, outputs


class _SeedWorker:
    """``worker_init_fn``: reseed the worker's copy of the dataset's
    ``rng`` with ``seed · 1000003 + worker id``."""

    def __init__(self, seed: int):
        self.seed = seed

    def __call__(self, wid: int) -> None:
        get_worker_info().dataset.rng = random.Random(
            self.seed * 1000003 + wid)


class _EpochBatches:
    """A ``batch_sampler``: each pass draws an epoch's order from
    ``np_rng`` and yields ``batch_size`` indices a batch, the last partial
    batch dropped."""

    def __init__(self, np_rng, n: int, batch_size: int):
        self.np_rng, self.n, self.batch_size = np_rng, n, batch_size

    def __len__(self):
        return self.n // self.batch_size

    def __iter__(self):
        order = self.np_rng.permutation(self.n).tolist()
        for s in range(0, self.n - self.batch_size + 1, self.batch_size):
            yield order[s:s + self.batch_size]


def _image_key(k) -> bool:
    return k == "depth_gt" or (isinstance(k, tuple)
                               and k[0] in ("color", "color_aug"))


def _init_(modules, gen):
    """The JAX trainer's init in distribution (its numbers differ): every
    conv weight and bias U(±1/√fan_in) from ``gen``; BatchNorms at
    PyTorch's defaults (scale 1, bias 0, statistics 0 / 1)."""
    for m in modules:
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            torch_conv_init_(m.weight, fan_in, gen)
            if m.bias is not None:
                torch_conv_init_(m.bias, fan_in, gen)


class Trainer:
    """monodepth2's trainer on ``options`` (``depth/options.py``), over
    ``dataset`` (and ``val_dataset`` for :meth:`val`). ``seed`` gives the
    networks' init, the epochs' batch order and the workers' seeds."""

    def __init__(self, options, dataset=None, val_dataset=None,
                 seed: int = 0):
        o = options
        self.opt = o
        self.device = resolve_device(
            "cpu" if getattr(o, "no_cuda", False) else None)
        true_fp32(self.device)
        self.log_path = os.path.join(o.log_dir, o.model_name)
        os.makedirs(self.log_path, exist_ok=True)

        if o.frame_ids[0] != 0:
            raise ValueError("frame_ids must start with 0")
        # use_stereo appends the 's' frame; stereo alone ([0] + 's') needs
        # no pose networks
        self.frame_ids = [f for f in o.frame_ids if f != "s"]
        self.use_stereo = bool(getattr(o, "use_stereo", False)
                               or "s" in o.frame_ids)
        if self.use_stereo:
            self.frame_ids.append("s")
        self.use_pose_net = not (self.use_stereo and self.frame_ids == [0, "s"])

        enc = ResnetEncoder(o.num_layers)
        self.models = {"encoder": enc,
                       "depth": DepthDecoder(enc.num_ch_enc, scales=o.scales)}
        if self.use_pose_net:
            if o.pose_model_type == "posecnn":
                self.models["pose"] = PoseCNN(num_input_frames=2)
            else:
                pose_enc = ResnetEncoder(o.num_layers, num_input_images=2)
                self.models["pose_encoder"] = pose_enc
                self.models["pose"] = PoseDecoder(
                    pose_enc.num_ch_enc, num_input_features=1,
                    num_frames_to_predict_for=2)
        gen = torch.Generator().manual_seed(int(seed))
        for name, m in self.models.items():
            _init_(m.modules(), gen)
            self.models[name] = freeze_running_stats(m).to(self.device)

        self.parameters = [p for m in self.models.values()
                           for p in m.parameters()]
        self.optimizer = torch.optim.Adam(self.parameters, lr=o.learning_rate)
        self.schedule_epoch_steps = None
        self.step = 0
        self.epoch = 0
        self.seed = int(seed)
        self.np_rng = np.random.RandomState(self.seed)
        self.dataset = dataset
        self.val_dataset = val_dataset
        self._loader = None
        if o.load_weights_folder:
            self.load_model()

    # ------------------------------------------------------------------
    def lr(self, step: int) -> float:
        """The step's learning rate (see the module docstring)."""
        eps = self.schedule_epoch_steps or 10 ** 9
        return self.opt.learning_rate * 0.1 ** (
            step // (eps * self.opt.scheduler_step_size))

    def noise(self, step: int):
        """The auto-mask noise source of ``step``: N(0, 1) draws from a
        generator on the trainer's device seeded with ``step``."""
        gen = torch.Generator(device=self.device).manual_seed(int(step))
        return lambda shape: torch.randn(shape, generator=gen,
                                         device=self.device)

    def loss_opt(self) -> dict:
        o = self.opt
        return {
            "frame_ids": tuple(self.frame_ids), "scales": tuple(o.scales),
            "height": o.height, "width": o.width,
            "min_depth": o.min_depth, "max_depth": o.max_depth,
            "disparity_smoothness": o.disparity_smoothness,
            "v1_multiscale": o.v1_multiscale,
            "avg_reprojection": o.avg_reprojection,
            "disable_automasking": o.disable_automasking,
            "no_ssim": o.no_ssim, "pose_model_type": o.pose_model_type,
        }

    def set_train(self):
        for m in self.models.values():
            m.train()

    def set_eval(self):
        for m in self.models.values():
            m.eval()

    def to_device(self, batch: dict) -> dict:
        """A collated batch → the trainer's device, images (and
        ``depth_gt``) NHWC → NCHW, once."""
        out = {}
        for k, v in batch.items():
            v = v.to(self.device, non_blocking=True)
            out[k] = v.permute(0, 3, 1, 2).contiguous() if _image_key(k) else v
        return out

    # ------------------------------------------------------------------
    def train_step(self, inputs: dict, noise=None) -> dict:
        """One Adam step on a device batch at the LR of ``self.step``;
        returns the losses (device tensors, detached)."""
        for g in self.optimizer.param_groups:
            g["lr"] = self.lr(self.step)
        self.set_train()
        total, losses, _ = monodepth_loss(
            self.models, inputs, self.loss_opt(),
            noise or self.noise(self.step))
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def process_batch(self, inputs: dict, noise=None):
        """Eval-mode forward and losses of a device batch (BatchNorm by
        running statistics); returns (outputs, losses)."""
        self.set_eval()
        with torch.no_grad():
            _, losses, outputs = monodepth_loss(
                self.models, inputs, self.loss_opt(),
                noise or self.noise(self.step))
        return outputs, losses

    def _writer(self):
        if not hasattr(self, "_tb"):
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(self.log_path, "train"))
            except ImportError:
                self._tb = None
        return self._tb

    def log_scalars(self, mode: str, losses) -> None:
        """Scalars to TensorBoard when ``tensorboardX`` is installed."""
        tb = self._writer()
        if tb is None:
            return
        for k, v in losses.items():
            tb.add_scalar(f"{mode}/{k}", float(v), self.step)

    def val(self):
        """One validation batch (the first ``batch_size`` items of
        ``val_dataset``, without ``depth_gt``): its losses as floats, or
        None without a validation set."""
        if self.val_dataset is None or len(self.val_dataset) == 0:
            return None
        bs = min(self.opt.batch_size, len(self.val_dataset))
        items = [self.val_dataset[i] for i in range(bs)]
        batch = collate([{k: v for k, v in it.items() if k != "depth_gt"}
                         for it in items])
        _, losses = self.process_batch(self.to_device(batch))
        losses = {k: float(v) for k, v in losses.items()}
        self.log_scalars("val", losses)
        return losses

    def train(self):
        """``num_epochs`` epochs, each followed by :meth:`val`, saving every
        ``save_frequency`` epochs."""
        if self.dataset is None:
            raise ValueError("construct Trainer with a dataset")
        self.start_time = time.time()
        for self.epoch in range(self.opt.num_epochs):
            self.run_epoch()
            self.val()
            if (self.epoch + 1) % self.opt.save_frequency == 0:
                self.save_model()

    def loader(self) -> DataLoader:
        """The trainer's loader: each pass is an epoch, its order drawn
        then from ``np_rng``, ``batch_size`` items a batch, the last
        partial batch dropped. ``num_workers`` spawned processes, started
        at the first pass and kept for the next (0: the items are made in
        this process)."""
        if self._loader is None:
            workers = int(self.opt.num_workers)
            self._loader = DataLoader(
                self.dataset, collate_fn=collate,
                batch_sampler=_EpochBatches(self.np_rng, len(self.dataset),
                                            self.opt.batch_size),
                num_workers=workers, pin_memory=self.device.type == "cuda",
                worker_init_fn=_SeedWorker(self.seed) if workers else None,
                multiprocessing_context="spawn" if workers else None,
                persistent_workers=workers > 0)
        return self._loader

    def close(self):
        """Stop the loader's worker processes."""
        self._loader = None

    def run_epoch(self):
        """One pass over the dataset in :meth:`loader`'s batches."""
        self.schedule_epoch_steps = max(
            1, len(self.dataset) // self.opt.batch_size)
        for batch in self.loader():
            losses = self.train_step(self.to_device(batch))
            if self.step % self.opt.log_frequency == 0:
                host = {k: float(v) for k, v in losses.items()}
                print(f"epoch {self.epoch} | step {self.step} | "
                      f"loss {host['loss']:.4f}", flush=True)
                self.log_scalars("train", host)

    # ------------------------------------------------------------------
    def _named_parameters(self):
        """(``<network>.<parameter>``, parameter) in the optimizer's
        order."""
        return [(f"{name}.{k}", p) for name, m in self.models.items()
                for k, p in m.named_parameters()]

    def _flax_tree(self, named):
        """{``<network>.<key>``: tensor} → ``{network: params tree}``
        (the tree of JAX's optimizer state)."""
        by = {name: {} for name in self.models}
        for k, v in named.items():
            name, key = k.split(".", 1)
            by[name][key] = v.detach().float().cpu()
        return {name: v["params"] for name, v in
                to_flax_depth_trainer(by).items()}

    def _from_flax_tree(self, tree):
        sds = from_flax_depth_trainer({name: {"params": p}
                                       for name, p in tree.items()})
        return {f"{name}.{k}": v for name, sd in sds.items()
                for k, v in sd.items()}

    def save_model(self) -> str:
        """Write ``log_path/models/weights_{epoch}/``: the networks'
        ``.pth`` files (the encoder's with ``height``, ``width`` and
        ``use_stereo``) and ``adam.pth``, or JAX's ``.ckpt`` files,
        ``meta.json`` and ``adam.ckpt`` under the ``msgpack`` or ``orbax``
        backend. Returns the folder."""
        folder = os.path.join(self.log_path, "models",
                              f"weights_{self.epoch}")
        os.makedirs(folder, exist_ok=True)
        if ckpt.backend_of() is not None:
            variables = to_flax_depth_trainer({
                name: {k: v.detach().float().cpu()
                       for k, v in m.state_dict().items()}
                for name, m in self.models.items()})
            for name, v in variables.items():
                ckpt.save_pytree(v, os.path.join(folder, f"{name}.ckpt"))
            with open(os.path.join(folder, "meta.json"), "w") as f:
                json.dump({"height": self.opt.height, "width": self.opt.width,
                           "use_stereo": self.use_stereo, "step": self.step},
                          f)
            ckpt.save_pytree(ost.chain(
                ost.adam_state(self.optimizer, self._named_parameters(),
                               self._flax_tree),
                {"count": ost.count(self.step)}),
                os.path.join(folder, "adam.ckpt"))
            return folder
        for name, m in self.models.items():
            sd = {k: v.detach().cpu() for k, v in m.state_dict().items()}
            if name == "encoder":
                sd.update(height=self.opt.height, width=self.opt.width,
                          use_stereo=self.use_stereo)
            torch.save(sd, os.path.join(folder, f"{name}.pth"))
        torch.save({"optimizer": self.optimizer.state_dict(),
                    "step": self.step},
                   os.path.join(folder, "adam.pth"))
        return folder

    def load_model(self):
        """Load ``load_weights_folder``'s ``<name>.pth`` (monodepth2's) or
        ``<name>.ckpt`` (JAX's flax variables, through
        ``from_flax_depth_trainer``) for each of ``models_to_load`` this
        trainer has and whose file exists, then ``adam.pth`` (the optimizer
        state and the step) or ``adam.ckpt`` (optax's Adam state; the step
        from ``meta.json``) if present."""
        folder = os.path.expanduser(self.opt.load_weights_folder)
        names = [n for n in self.opt.models_to_load if n in self.models]
        for name in names:
            p = os.path.join(folder, f"{name}.pth")
            if os.path.exists(p):
                load_monodepth_file(self.models[name], p)
            elif os.path.exists(p[:-len(".pth")] + ".ckpt"):
                tree = ckpt.load_pytree(p[:-len(".pth")] + ".ckpt")
                self.models[name].load_state_dict(
                    from_flax_depth_trainer({name: tree})[name])
        adam = os.path.join(folder, "adam.pth")
        if os.path.exists(adam):
            state = torch.load(adam, map_location="cpu", weights_only=True)
            self.optimizer.load_state_dict(state["optimizer"])
            self.step = int(state["step"])
        elif os.path.exists(adam[:-len(".pth")] + ".ckpt"):
            tree = ckpt.load_pytree(adam[:-len(".pth")] + ".ckpt")
            ost.load_adam(self.optimizer, self._named_parameters(),
                          ost.find_adam(tree), self._from_flax_tree)
            with open(os.path.join(folder, "meta.json")) as f:
                self.step = int(json.load(f)["step"])
