"""optax optimizer states ↔ the port's optimizer states.

The JAX package's ``{iter}.state`` and ``adam.ckpt`` hold optax states as
``flax.serialization.to_state_dict`` gives them: a chain is ``{"0": ...,
"1": ...}``, ``scale_by_adam`` is ``{"count", "mu", "nu"}`` (the moments
in the parameter tree's shape), ``add_decayed_weights`` is ``{}``,
``scale_by_learning_rate`` is ``{"count"}``, ``scale_by_rms`` is
``{"nu"}``, ``trace`` is ``{"trace"}``, and ``lr_schedule.clear_state_at``
wraps Adam as ``{"0": count, "1": adam}``. The port's optimizers:

- ``torch.optim.Adam``: per parameter ``step`` (optax's Adam count),
  ``exp_avg`` (``mu``) and ``exp_avg_sq`` (``nu``); no state before the
  first update, which is optax's count 0 with zero moments;
- ``models/sftgan_model.py::AdamMoments``: ``count``, ``m``, ``v`` lists;
- ``models/f_depthseg.py::RMSChain``: per parameter ``nu`` and
  ``trace``.

A parameter is named by the key its tree's ``from_flax*`` gives it
(``named``: (name, parameter) pairs); ``to_tree`` / ``from_tree`` map
{name: tensor} to the flax tree and back. The schedule counts are the
updates made, which the models keep themselves.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["count", "adam_state", "load_adam", "moments_state",
           "load_moments", "rms_state", "load_rms", "find_adam", "chain"]


def count(n: int) -> np.ndarray:
    """An optax count leaf as JAX writes it (an int32 0-d array)."""
    return np.asarray(int(n), np.int32)


def chain(*states) -> dict:
    """An ``optax.chain`` state: ``{"0": states[0], "1": ...}``."""
    return {str(i): s for i, s in enumerate(states)}


def _slot(state: Mapping, p, key):
    st = state.get(p) or {}
    return st[key] if key in st else torch.zeros_like(p)


def adam_state(optimizer: torch.optim.Optimizer, named, to_tree) -> dict:
    """A ``torch.optim.Adam``'s state over the ``named`` parameters →
    optax's ``{"count", "mu", "nu"}``."""
    st = optimizer.state
    steps = {int(st[p]["step"]) for _, p in named if st.get(p)}
    if len(steps) > 1:
        raise ValueError(f"the parameters were updated unequally: {steps}")
    return {"count": count(steps.pop() if steps else 0),
            "mu": to_tree({k: _slot(st, p, "exp_avg") for k, p in named}),
            "nu": to_tree({k: _slot(st, p, "exp_avg_sq") for k, p in named})}


def _by_name(tree, from_tree, named, what):
    got = from_tree(tree)
    missing = [k for k, _ in named if k not in got]
    if missing:
        raise KeyError(f"{what}: no state for {len(missing)} parameters, "
                       f"e.g. {missing[:3]}")
    return got


def load_adam(optimizer: torch.optim.Optimizer, named, adam: Mapping,
              from_tree) -> None:
    """Set a ``torch.optim.Adam``'s state from optax's ``{"count", "mu",
    "nu"}`` (count 0: no state, as before a first update)."""
    n = int(np.asarray(adam["count"]))
    optimizer.state.clear()
    if n == 0:
        return
    mu = _by_name(adam["mu"], from_tree, named, "mu")
    nu = _by_name(adam["nu"], from_tree, named, "nu")
    for k, p in named:
        optimizer.state[p] = {
            "step": torch.tensor(float(n), dtype=torch.float32),
            "exp_avg": mu[k].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[k].to(p.device, p.dtype).clone()}


def moments_state(moments, names, to_tree) -> dict:
    """``AdamMoments`` (``count`` and the ``m`` / ``v`` lists in the order
    of ``names``) → optax's ``{"count", "mu", "nu"}``."""
    return {"count": count(moments.count),
            "mu": to_tree(dict(zip(names, moments.m))),
            "nu": to_tree(dict(zip(names, moments.v)))}


def load_moments(moments, names, adam: Mapping, from_tree) -> None:
    """Set ``AdamMoments`` from optax's ``{"count", "mu", "nu"}``."""
    named = [(k, None) for k in names]
    mu = _by_name(adam["mu"], from_tree, named, "mu")
    nu = _by_name(adam["nu"], from_tree, named, "nu")
    moments.count = int(np.asarray(adam["count"]))
    with torch.no_grad():
        for k, m, v in zip(names, moments.m, moments.v):
            m.copy_(mu[k])
            v.copy_(nu[k])


def rms_state(optimizer: torch.optim.Optimizer, named, to_tree,
              momentum: bool) -> list[dict]:
    """An ``RMSChain``'s state → optax's ``scale_by_rms`` ``{"nu"}`` and,
    with ``momentum``, ``trace``'s ``{"trace"}``."""
    st = optimizer.state
    out = [{"nu": to_tree({k: _slot(st, p, "nu") for k, p in named})}]
    if momentum:
        out.append({"trace": to_tree({k: _slot(st, p, "trace")
                                      for k, p in named})})
    return out


def load_rms(optimizer: torch.optim.Optimizer, named, rms: Mapping,
             trace: Mapping | None, from_tree) -> None:
    """Set an ``RMSChain``'s state from optax's ``{"nu"}`` (and
    ``{"trace"}``)."""
    nu = _by_name(rms["nu"], from_tree, named, "nu")
    tr = None if trace is None else _by_name(trace["trace"], from_tree,
                                             named, "trace")
    optimizer.state.clear()
    for k, p in named:
        s = {"nu": nu[k].to(p.device, p.dtype).clone()}
        if tr is not None:
            s["trace"] = tr[k].to(p.device, p.dtype).clone()
        optimizer.state[p] = s


def find_adam(tree: Mapping) -> Mapping:
    """The first ``scale_by_adam`` state (a map holding ``mu`` and ``nu``)
    in an optax chain's state, depth first in key order."""
    if isinstance(tree, Mapping):
        if "mu" in tree and "nu" in tree:
            return tree
        for k in sorted(tree, key=lambda s: (len(s), s)):
            got = find_adam(tree[k])
            if got is not None:
                return got
    return None
