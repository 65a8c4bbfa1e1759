"""Checkpoint surgery: a target ``.pth`` with every tensor a donor
``.pth`` has under the same name and shape — or, failing that, the one
donor tensor of the same last name segment and shape, where there is
exactly one — the rest kept: ``python -m
endosr_torch.scripts.transfer_params --donor D.pth --target T.pth --out
O.pth`` (counterpart of ``scripts/transfer_params.py``, which writes a flax
``.ckpt``; the port reads and writes ``state_dict`` files)."""

from __future__ import annotations

import argparse

import torch

from endosr_torch.utils.port_params import load_params


def transfer_params(donor_path: str, target_path: str, out_path: str) -> int:
    """Writes the merged ``state_dict`` to ``out_path``; returns the number
    of tensors taken from the donor."""
    donor = load_params(donor_path)
    target = load_params(target_path)
    by_leaf: dict = {}
    for k, v in donor.items():
        by_leaf.setdefault((k.rsplit(".", 1)[-1], tuple(v.shape)), []).append(v)
    out, n = {}, 0
    for k, v in target.items():
        exact = donor.get(k)
        cands = by_leaf.get((k.rsplit(".", 1)[-1], tuple(v.shape)), [])
        if exact is not None and exact.shape == v.shape:
            out[k], n = exact.clone(), n + 1
        elif len(cands) == 1:
            out[k], n = cands[0].clone(), n + 1
        else:
            out[k] = v
    torch.save(out, out_path)
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--donor", required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    n = transfer_params(args.donor, args.target, args.out)
    print(f"transferred {n} parameter tensors")


if __name__ == "__main__":
    main()
