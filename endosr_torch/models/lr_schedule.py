"""Learning-rate schedules (counterpart of ``endosr/models/lr_schedule.py``).

Closed-form ``step → lr`` functions of the reference's per-iteration
schedulers: ``CosineAnnealingLR_Restart``, ``MultiStepLR_Restart``, torch's
``MultiStepLR`` and ``StepLR``, and the linear warmup of
``base_model.py:57-63``. Update n (counting from 0) uses ``schedule(n)``.
Each is evaluated in float32 on the host, as the JAX twins evaluate it
inside the jitted step, and returned as a Python float for the
optimizer's param groups; the cosine is the correctly rounded one, so
near a period's end, where 1 + cos cancels, a value may differ from
JAX's by up to ~6e-8 of the base LR. :func:`clear_state_at` is the torch
form of ``MultiStepLR_Restart(clear_state=True)``.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

__all__ = ["cosine_annealing_restart", "multistep_restart", "multistep",
           "step_lr", "with_warmup", "build_schedule", "clear_state_at"]

_F = np.float32


def clear_state_at(restarts: Sequence[int]):
    """``clear(optimizer, count)``: before update ``count`` (counting from
    0), when ``count`` is a restart step, drop every parameter's optimizer
    state, so Adam's moments and its bias-correction count start again at
    zero (reference ``lr_scheduler.py:22-23``; JAX ``lr_schedule.py:34-66``
    zeroes the same state)."""
    steps = {int(r) for r in restarts}

    def clear(optimizer, count):
        if int(count) in steps:
            optimizer.state.clear()

    return clear


def _segment(step, starts):
    """Index of the restart segment ``step`` lies in."""
    idx = int(np.sum(step >= starts)) - 1
    return min(max(idx, 0), len(starts) - 1)


def cosine_annealing_restart(base_lr: float, t_period: Sequence[int],
                             restarts: Sequence[int] = (),
                             restart_weights: Sequence[float] = (),
                             eta_min: float = 0.0):
    """lr(t) = η_min + (base·w_seg − η_min)·(1 + cos(π·(t−r_seg)/T_seg))/2."""
    assert len(restarts) == len(restart_weights), \
        "restarts and their weights do not match."
    assert len(t_period) == len(restarts) + 1
    starts = np.concatenate([[0], np.asarray(restarts, np.int64)]).astype(_F)
    weights = np.concatenate([[1.0], np.asarray(restart_weights,
                                                np.float64)]).astype(_F)
    periods = np.asarray(t_period, np.float64).astype(_F)

    def schedule(step):
        s = _F(step)
        i = _segment(s, starts)
        # the cosine of the fp32 angle, correctly rounded to fp32; XLA's
        # fp32 cos is not, and differs from it by one ulp at a few per cent
        # of the angles
        cos = _F(np.cos(np.float64(_F(np.pi) * (s - starts[i]) / periods[i])))
        lr = _F(eta_min) + (_F(base_lr) * weights[i] - _F(eta_min)) * (
            _F(1.0) + cos) / _F(2.0)
        return float(lr)

    return schedule


def multistep_restart(base_lr: float, milestones: Sequence[int],
                      gamma: float = 0.1, restarts: Sequence[int] = (),
                      restart_weights: Sequence[float] = ()):
    """lr(t) = base·w_seg·γ^(#milestones in (r_seg, t])."""
    if restarts:
        assert len(restarts) == len(restart_weights)
    starts = np.concatenate([[0], np.asarray(restarts or (), np.int64)])
    weights = np.concatenate([[1.0], np.asarray(restart_weights or (),
                                                np.float64)]).astype(_F)
    ms = np.asarray(milestones, np.int64)

    def schedule(step):
        s = int(step)
        i = _segment(s, starts)
        n = int(np.sum((ms > starts[i]) & (ms <= s)))
        return float(_F(base_lr) * weights[i] * _F(gamma) ** _F(n))

    return schedule


def multistep(base_lr: float, milestones: Sequence[int], gamma: float = 0.1):
    return multistep_restart(base_lr, milestones, gamma)


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1):
    """torch ``StepLR``: lr = base·γ^(t // step_size)."""

    def schedule(step):
        return float(_F(base_lr) * _F(gamma) ** _F(int(step) // int(step_size)))

    return schedule


def with_warmup(schedule, init_lr: float, warmup_iter: int):
    """Linear warmup over the first ``warmup_iter`` updates; none if ≤ 0."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def s(step):
        if _F(step) < _F(warmup_iter):
            return float(_F(step) * _F(init_lr) / _F(warmup_iter))
        return schedule(step)

    return s


def build_schedule(train_opt: dict):
    """The schedule of a reference-schema ``train:`` block."""
    lr = float(train_opt["lr_G"])
    scheme = train_opt.get("lr_scheme", "MultiStepLR")
    gamma = float(train_opt.get("lr_gamma", 0.1) or 0.1)
    if scheme == "CosineAnnealingLR_Restart":
        sched = cosine_annealing_restart(
            lr, train_opt["T_period"], train_opt.get("restarts") or (),
            train_opt.get("restart_weights") or (),
            float(train_opt.get("eta_min", 0) or 0))
    elif scheme == "MultiStepLR_Restart":
        sched = multistep_restart(
            lr, train_opt.get("lr_steps", ()), gamma,
            train_opt.get("restarts") or (),
            train_opt.get("restart_weights") or ())
    else:
        sched = multistep(lr, train_opt.get("lr_steps", ()) or (), gamma)
    return with_warmup(sched, lr, int(train_opt.get("warmup_iter") or -1))
