"""YAML options (counterpart of ``endosr/config/options.py``).

The same schema and the same paths as the JAX package: ordered-YAML
parse, scale and phase carried into every dataset block, ``data_type``
detected from a root ending in ``lmdb``, the experiment tree
(``experiments/<name>/{models,training_state,val_images}``, or
``results/<name>`` for evaluation) archived on a name collision, the debug
overrides, ``NoneDict`` (a missing key reads as None), ``resume_state:
auto`` and ``check_resume``. ``root`` defaults to ``path.root`` of the
YAML, else the repository root.

One difference: :func:`check_resume` points ``pretrain_model_G`` at
``{iter}_G.pth``, the port's weight file, where JAX reads ``.ckpt``; it
takes ``.ckpt`` under the ``msgpack`` checkpoint backend, or where only the
``.ckpt`` is there (a JAX run's folder).
"""

from __future__ import annotations

import logging
import os
import os.path as osp
from collections import OrderedDict

import yaml

__all__ = ["parse", "dict2str", "NoneDict", "dict_to_nonedict", "check_resume",
           "ordered_yaml", "resolve_resume_state", "setup_experiment_dirs"]

logger = logging.getLogger("base")

REPO_ROOT = osp.abspath(osp.join(osp.dirname(osp.abspath(__file__)), "..", ".."))


def ordered_yaml():
    """Ordered-mapping YAML Loader and Dumper."""
    try:
        from yaml import CDumper as Dumper
        from yaml import CLoader as Loader
    except ImportError:
        from yaml import Dumper, Loader

    _mapping_tag = yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG

    def dict_representer(dumper, data):
        return dumper.represent_dict(data.items())

    def dict_constructor(loader, node):
        return OrderedDict(loader.construct_pairs(node))

    Dumper.add_representer(OrderedDict, dict_representer)
    Loader.add_constructor(_mapping_tag, dict_constructor)
    return Loader, Dumper


def parse(opt_path: str, is_train: bool = True, root: str | None = None) -> dict:
    """Parse a train or test YAML into the option dict."""
    with open(opt_path, mode="r") as f:
        loader, _ = ordered_yaml()
        opt = yaml.load(f, Loader=loader)

    opt["is_train"] = is_train
    scale = opt.get("scale")

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        dataset["scale"] = scale
        is_lmdb = False
        for key in ("dataroot_GT", "dataroot_LQ"):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])
                if dataset[key].endswith("lmdb"):
                    is_lmdb = True
        dataset["data_type"] = "lmdb" if is_lmdb else "img"
        if dataset.get("mode", "").endswith("mc"):
            dataset["data_type"] = "mc"
            dataset["mode"] = dataset["mode"].replace("_mc", "")

    opt.setdefault("path", {})
    for key, path in list(opt["path"].items()):
        if path and ("resume" in key or "pretrain" in key or "root" in key):
            opt["path"][key] = osp.expanduser(path)
    if root is None:
        root = opt["path"].get("root") or REPO_ROOT
    opt["path"]["root"] = root

    if is_train:
        experiments_root = osp.join(root, "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_state"] = osp.join(experiments_root, "training_state")
        opt["path"]["log"] = experiments_root
        opt["path"]["val_images"] = osp.join(experiments_root, "val_images")

        if "debug" in opt["name"]:
            opt["train"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(root, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root

    if "network_G" in opt and opt["network_G"] is not None:
        opt["network_G"]["scale"] = scale

    return opt


def dict2str(opt: dict, indent_l: int = 1) -> str:
    """The option dict as indented text, for the log."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg


class NoneDict(dict):
    """A dict whose missing keys read as None."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    """``opt`` with every dict in it a :class:`NoneDict`."""
    if isinstance(opt, dict):
        return NoneDict(**{key: dict_to_nonedict(sub) for key, sub in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(sub) for sub in opt]
    return opt


def resolve_resume_state(opt: dict):
    """``path.resume_state``, with ``auto`` resolved to the newest
    ``<iter>.state`` in the experiment's ``training_state`` directory (None
    on a fresh run). The resolved path is written back into ``opt``."""
    resume_path = opt["path"].get("resume_state")
    if resume_path == "auto":
        state_dir = opt["path"].get("training_state") or osp.join(
            opt["path"]["experiments_root"], "training_state")
        states = sorted(
            (f for f in os.listdir(state_dir) if f.endswith(".state")
             and f.split(".")[0].isdigit()),
            key=lambda f: int(f.split(".")[0]),
        ) if osp.isdir(state_dir) else []
        resume_path = osp.join(state_dir, states[-1]) if states else None
        opt["path"]["resume_state"] = resume_path
    return resume_path


def _weights(opt: dict, name: str) -> str:
    """``path.models/<name>.pth``, or ``.ckpt`` under the ``msgpack``
    backend or where only the ``.ckpt`` exists."""
    base = osp.join(opt["path"]["models"], name)
    backend = (opt["path"].get("checkpoint_backend")
               or os.environ.get("ENDOSR_CKPT_BACKEND"))
    if backend == "msgpack" or (not osp.exists(base + ".pth")
                                and osp.exists(base + ".ckpt")):
        return base + ".ckpt"
    return base + ".pth"


def check_resume(opt: dict, resume_iter: int) -> None:
    """When resuming, point the pretrained weights at the resumed
    iteration's ``{iter}_G.pth`` (``.ckpt``, see the module docstring; and
    ``_D`` for a GAN model)."""
    if opt["path"].get("resume_state"):
        if opt["path"].get("pretrain_model_G") or opt["path"].get("pretrain_model_D"):
            logger.warning(
                "pretrain_model path will be ignored when resuming training.")
        opt["path"]["pretrain_model_G"] = _weights(opt, f"{resume_iter}_G")
        logger.info("Set [pretrain_model_G] to %s", opt["path"]["pretrain_model_G"])
        if "gan" in opt.get("model", ""):
            opt["path"]["pretrain_model_D"] = _weights(opt, f"{resume_iter}_D")
            logger.info("Set [pretrain_model_D] to %s", opt["path"]["pretrain_model_D"])


def setup_experiment_dirs(opt: dict) -> None:
    """Create the experiment tree; an existing one is archived first
    (training from scratch) or kept (resuming)."""
    from endosr_torch.utils.misc import mkdir_and_rename, mkdirs

    if opt["is_train"]:
        if not opt["path"].get("resume_state"):
            mkdir_and_rename(opt["path"]["experiments_root"])
        mkdirs(
            path for key, path in opt["path"].items()
            if key not in ("experiments_root", "root", "pretrain_model_G",
                           "pretrain_model_D", "resume_state", "strict_load")
            and isinstance(path, str)
        )
    else:
        mkdir_and_rename(opt["path"]["results_root"])
