"""Time the port's orbax reader (``endosr_torch/utils/orbax_io.py``, pure
Python and numpy) on a full-width ×8 training state, as JAX writes it.

The tree is what the flagship ×8 model (``models/recipes.py::
x8_train_opt``, fp32) saves as ``{iter}.state``: its generator's seeded
parameters and an Adam chain whose moments are drawn from a seed (a model
that has trained has non-zero moments, which compress as little as
weights do). The JAX package's ``save_pytree`` writes it with the orbax
backend (tensorstore: OCDBT, zarr chunks compressed by zstd at level 1);
the port then reads it back, timed, and the values are checked equal.

    JAX_PLATFORMS=cpu python -m tests.time_orbax_read [--dir DIR]

prints one JSON line: the leaves' count and bytes, the directory's bytes,
the read's seconds and MB/s of leaf bytes, and the shares of a second,
profiled read spent in the zstd decoder and in its XXH64 checksums. The
model is only built, never run.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def flagship_state(seed: int = 0) -> dict:
    """The ×8 flagship's ``{iter}.state`` tree (numpy leaves), moments
    drawn from ``seed``."""
    from endosr_torch.models import create_model
    from endosr_torch.models.recipes import x8_train_opt
    from endosr_torch.utils.port_params import seeded_init

    tm = create_model(x8_train_opt("fp32"), device="cpu")
    seeded_init(tm.netG, seed)
    rng = np.random.default_rng(seed)

    def leaves(t, path=""):
        if isinstance(t, dict):
            return {k: leaves(v, f"{path}/{k}") for k, v in t.items()}
        a = np.asarray(t.detach().cpu() if torch.is_tensor(t) else t)
        if path.startswith("/opt_state") and a.dtype == np.float32 \
                and a.ndim:
            a = rng.standard_normal(a.shape).astype(np.float32) * 1e-3
            if "/nu" in path:
                a = a * a
        return a

    return leaves({"epoch": np.asarray(0, np.int64),
                   "iter": np.asarray(2, np.int64),
                   **tm._flax_training_state()})


def _flat(t, path=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, t


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=None,
                    help="where to write the state (default: a temporary "
                         "directory)")
    args = ap.parse_args(argv)
    import endosr.utils.checkpoint as jckpt
    from endosr_torch.utils import orbax_io

    tree = flagship_state()
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        path = str(Path(tmp) / "2.state")
        jckpt.save_pytree(tree, path, "orbax")
        on_disk = sum(f.stat().st_size for f in Path(path).rglob("*")
                      if f.is_file())
        t0 = time.perf_counter()
        got = orbax_io.read_pytree(path)
        seconds = time.perf_counter() - t0
        # the shares from a second, profiled read
        prof = cProfile.Profile()
        prof.enable()
        orbax_io.read_pytree(path)
        prof.disable()
    want = dict(_flat(tree))
    have = dict(_flat(got))
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        g = have[k]
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.tobytes() == v.tobytes(), k
    stats = pstats.Stats(prof)
    cum = {f"{Path(f).name}:{name}": row[3]
           for (f, _, name), row in stats.stats.items()}
    profiled = stats.total_tt
    total = sum(v.nbytes for v in want.values())
    print(json.dumps({
        "leaves": len(want),
        "parameters": int(sum(v.size for k, v in want.items()
                              if k.startswith("/params"))),
        "leaf_bytes": int(total), "dir_bytes": int(on_disk),
        "read_s": seconds, "MB_per_s": total / seconds / 1e6,
        "zstd_share": cum.get("zstd.py:decompress_many", 0.0) / profiled,
        "xxh64_share": cum.get("zstd.py:xxh64", 0.0) / profiled}))


if __name__ == "__main__":
    main()
