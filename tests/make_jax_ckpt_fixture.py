"""Write ``tests/data/jax_ckpt/``: files the JAX package itself wrote.

    JAX_PLATFORMS=cpu python tests/make_jax_ckpt_fixture.py [--out DIR]
    JAX_PLATFORMS=cpu python tests/make_jax_ckpt_fixture.py --backend orbax

A small ×8 DepthNet (the flagship training YAML's ``network_G`` with nb 2,
no depth block, latent 16, K 4; its widths are 64 whatever ``nf`` says, as
``head_0`` and the upscale convs are built at 64 in JAX) in the JAX
``FModelDepthCond``, its weights the seeded leaves of
``tests/torch_models_common.py``, trains two steps on the CPU on seeded
batches (LR 8², batch 2). Then JAX's own
``save`` and ``save_training_state`` write ``2_G.ckpt`` and ``2.state``
(flax msgpack), and the saved weights' fp32 forward of a seeded input
(LR 8×12, batch 2) goes to ``output.npy`` beside that input
(``input.npz``). ``opt.json`` holds the model's options, so that the port
(``chip_smoke.py`` phase 15d, ``tests/test_torch_checkpoint.py``) builds
the same model. The files take 5.8 MB (351,363 parameters: the weights
once in the ``.ckpt``, three times in the ``.state`` with Adam's moments).

With ``--backend orbax`` the same model and steps write
``tests/data/jax_orbax/``: ``2_G.ckpt/`` and ``2.state/``, the orbax
directories (tensorstore's OCDBT layout, zstd-compressed zarr chunks) that
JAX's ``path.checkpoint_backend: orbax`` writes; the input, the output and
the options are ``jax_ckpt/``'s, which the same weights give.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from pathlib import Path

import numpy as np
import yaml

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "jax_ckpt"
OUT_ORBAX = REPO / "tests" / "data" / "jax_orbax"
TRAIN_YAML = REPO / "options/train/train_depthNet_SEAN_depthMask_x8.yml"
NET = {"nf": 64, "nb": 2, "which_ResBlk_depth": [], "depth_latent_ch": 16}
K, LR, B, SCALE, STEPS = 4, 8, 2, 8, 2
EVAL_LR = (8, 12)


def fixture_opt(out_dir: str, backend: str | None = None) -> dict:
    """The model's options: the ×8 YAML's network and train block, cut;
    ``backend``: the ``path.checkpoint_backend`` its saves take."""
    y = yaml.safe_load(TRAIN_YAML.read_text())
    path = {"models": out_dir, "training_state": out_dir}
    if backend:
        path["checkpoint_backend"] = backend
    return {"is_train": True, "model": y["model"], "scale": SCALE,
            "network_G": {**y["network_G"], **NET},
            "datasets": {"train": {"phase": "train", "LR_size": LR,
                                   "GT_size": LR * SCALE, "batch_size": B,
                                   "depthMaskNum": K}},
            "path": path, "train": y["train"]}


def batch(seed: int, hw=(LR, LR)) -> dict:
    """A seeded training batch (or, with ``hw``, an eval input)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    return {"LQ": rng.random((B, h, w, 3), dtype=np.float32),
            "GT": rng.random((B, h * SCALE, w * SCALE, 3), dtype=np.float32),
            "Depth": rng.random((B, h, w, 1), dtype=np.float32),
            "DepthMaskList": (rng.random((B, h, w, K)) > 0.6).astype(
                np.float32)}


def train_jax(out_dir: str, backend: str | None = None):
    """The JAX model after its two steps, saved to ``out_dir`` (with
    ``backend``); returns (model, the eval input, its forward)."""
    sys.path.insert(0, str(REPO))
    import jax

    import endosr.models as jmodels
    from endosr.config.options import dict_to_nonedict
    from tests.torch_models_common import jax_model

    os.makedirs(out_dir, exist_ok=True)
    jm = jax_model(jmodels.create_model,
                   dict_to_nonedict(copy.deepcopy(fixture_opt(out_dir,
                                                              backend))))
    for n in range(1, STEPS + 1):
        jm.feed_data(batch(n))
        jm.optimize_parameters(n)
    jm.save(STEPS)
    jm.save_training_state(0, STEPS)
    ev = batch(100, EVAL_LR)
    out = np.asarray(jm.netG.apply(
        {"params": jax.device_get(jm.state.params["netG"])}, ev["LQ"],
        ev["Depth"], ev["DepthMaskList"]))
    return jm, {k: ev[k] for k in ("LQ", "Depth", "DepthMaskList")}, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--backend", choices=("msgpack", "orbax"),
                    default="msgpack")
    args = ap.parse_args(argv)
    if args.backend == "orbax":
        out = args.out or str(OUT_ORBAX)
        train_jax(out, "orbax")
        print("wrote", sorted(os.listdir(out)))
        return
    out = args.out or str(OUT)
    _, ev, y = train_jax(out)
    np.savez(os.path.join(out, "input.npz"), **ev)
    np.save(os.path.join(out, "output.npy"), y)
    opt = fixture_opt(".")
    del opt["path"]
    with open(os.path.join(out, "opt.json"), "w") as f:
        json.dump(opt, f, indent=1, sort_keys=True)
    print("wrote", sorted(os.listdir(out)))


if __name__ == "__main__":
    main()
