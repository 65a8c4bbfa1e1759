"""Port a reference or port ``.pth`` generator checkpoint to JAX's flax
``.ckpt`` (counterpart of ``tools/port_torch_checkpoint.py``, the same
CLI)::

    python -m endosr_torch.tools.port_checkpoint \\
        --pth latest_G.pth --opt options/test/test_depthNet.yml \\
        --out latest_G.ckpt [--is_train] [--device cuda] \\
        [--backend msgpack|orbax]

Builds the generator from the YAML (``nn/networks.py::define_G``), fits the
``state_dict`` strictly (``utils/port_params.py::fit_state_dict``: keys of
modules the network does not build, such as a reference file's dead
``depth-residual14``, are dropped and logged; every key of the network
must be there, shapes must match) and writes its parameters as the flax
tree the JAX package's ``pretrain_model_G`` reads (``utils/checkpoint.py``,
``utils/port_params.py::to_flax``). ``--pth`` may also be a JAX weights
file: a ``.ckpt`` or an orbax directory (``models/base.py::
load_weights``). ``--out`` is written as JAX's ``save_pytree`` writes it:
a msgpack file, or with ``--backend orbax`` (default: the
``ENDOSR_CKPT_BACKEND`` variable, as in JAX, else ``msgpack``) an orbax
directory. Runs on the CPU unless ``--device`` says otherwise; it needs no
card.
"""

from __future__ import annotations

import argparse


def port_checkpoint(pth: str, opt_path: str, out: str, is_train=False,
                    device="cpu", backend=None) -> int:
    """Write ``out`` from ``pth``; returns the number of tensors written."""
    import os

    from endosr_torch.config import options as option
    from endosr_torch.models.base import load_weights, params_tree_of
    from endosr_torch.nn.networks import define_G
    from endosr_torch.utils.checkpoint import backend_of, save_pytree
    from endosr_torch.utils.port_params import fit_state_dict, load_params

    opt = option.dict_to_nonedict(option.parse(opt_path, is_train=is_train))
    net = define_G(opt, device=device)
    if pth.endswith(".ckpt") or os.path.isdir(pth):
        load_weights(pth, net, strict=True)
    else:
        net.load_state_dict(fit_state_dict(load_params(pth), net, True, pth))
    tree = params_tree_of(net)
    save_pytree(tree, out, backend_of(backend) or "msgpack")
    return sum(1 for _ in net.parameters())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pth", required=True)
    ap.add_argument("--opt", required=True, help="train or test YAML")
    ap.add_argument("--out", required=True)
    ap.add_argument("--is_train", action="store_true")
    ap.add_argument("--device", default="cpu",
                    help="where the network is built (default: the CPU)")
    ap.add_argument("--backend", choices=("msgpack", "orbax"), default=None,
                    help="msgpack file or orbax directory (default: "
                         "ENDOSR_CKPT_BACKEND, else msgpack)")
    args = ap.parse_args(argv)
    n = port_checkpoint(args.pth, args.opt, args.out, args.is_train,
                        args.device, args.backend)
    print(f"ported {n} tensors → {args.out}")
    return n


if __name__ == "__main__":
    main()
