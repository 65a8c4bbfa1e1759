"""The port's spans (``endosr_torch/utils/prof.py::annotate``) on the CPU.

Outside a profiler a span is one flag check and makes no
``record_function``. Under ``torch.profiler`` a served request opens
``serve.inputs`` then ``serve.forward`` with every ``net.*`` span inside
the forward and one ``net.prepare`` span per weight preparation; a
training step opens ``train.inputs`` … ``train.logs`` in order, and on two
gloo ranks ``dp.*`` around the collectives.
"""

from __future__ import annotations

import copy
import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import endosr_torch.nn.depthnet as depthnet
import endosr_torch.nn.layers as layers
import endosr_torch.nn.sean as sean
import endosr_torch.utils.prof as prof
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.models.recipes import x8_train_opt
from tests.torch_dist_common import run_ranks

K = 4
SERVE = {
    "is_train": False, "model": "sftmd_depthCond", "scale": 8,
    "precision": None, "eval_bucket_multiple": 0,
    "datasets": {"test": {"depthMaskNum": K, "LR_size": 8}},
    "network_G": {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3,
                  "nf": 64, "nb": 6, "depth_latent_ch": 16,
                  "which_ResBlk_depth": [0, 1, 2],
                  "use_trainable_params": True},
    "path": {},
}
TRAIN_NET = {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3, "nf": 64,
             "nb": 4, "depth_latent_ch": 16, "which_ResBlk_depth": [0],
             "use_trainable_params": True}
TRAIN_STEPS = ("train.inputs", "train.forward", "train.losses",
               "train.backward", "train.update", "train.logs")


def _batch(b, h, w, scale=None, seed=3):
    rng = np.random.default_rng(seed)
    out = {"LQ": rng.random((b, h, w, 3), dtype=np.float32),
           "Depth": rng.random((b, h, w, 1), dtype=np.float32),
           "DepthMaskList": (rng.random((b, h, w, K)) > 0.6).astype(
               np.float32)}
    if scale:
        out["GT"] = rng.random((b, h * scale, w * scale, 3), dtype=np.float32)
    return out


def train_opt():
    return {"is_train": True, "model": "sftmd_depthCond", "scale": 8,
            "precision": None,
            "datasets": {"train": {"depthMaskNum": K, "LR_size": 8}},
            "network_G": dict(TRAIN_NET), "path": {},
            "train": copy.deepcopy(x8_train_opt()["train"])}


@pytest.fixture(scope="module")
def server():
    torch.manual_seed(0)
    return FModelDepthCond(copy.deepcopy(SERVE), device="cpu")


def _annotations(fn):
    """(fn's result, [(name, start_ns, end_ns)] of the user spans it opened,
    in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in p.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def test_annotate_outside_a_profiler_makes_no_record_function(monkeypatch,
                                                              server):
    def refuse(*a, **k):
        raise AssertionError("record_function outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with prof.annotate("serve.inputs") as got:
        assert got is None
    server.feed_data(_batch(2, 8, 8))
    assert server.test().shape == (2, 64, 64, 3)
    src = inspect.getsource(prof)
    assert "nvtx" not in src.lower()


def test_annotate_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.annotate("net.prepare"):
            torch.ones(3).sum()
    names = [e.name() for e in p.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names == ["net.prepare"]


def _count_preparations(monkeypatch):
    """Wrap every weight preparation the forward can make; returns the
    list their calls are appended to."""
    calls = []

    def counting(fn, label, when=lambda *a, **k: True):
        def wrapped(*a, **k):
            if when(*a, **k):
                calls.append(label)
            return fn(*a, **k)
        return wrapped

    wn, branches = (counting(layers.wn_effective_kernel, "wn"),
                    counting(sean.branch_weights, "branches"))
    for mod in (layers, depthnet):
        monkeypatch.setattr(mod, "wn_effective_kernel", wn)
    for mod in (sean, depthnet):
        monkeypatch.setattr(mod, "branch_weights", branches)
    monkeypatch.setattr(depthnet, "_fold_wb", counting(
        depthnet._fold_wb, "fold", lambda w, b, r: r != 1))
    monkeypatch.setattr(depthnet, "_packed_wb", counting(
        depthnet._packed_wb, "packed"))
    monkeypatch.setattr(layers.WNConvTranspose, "effective_weight", counting(
        layers.WNConvTranspose.effective_weight, "wn_t"))
    net = depthnet.DepthNet
    for name in ("_head_wb", "_folded_head", "_phase_split_head"):
        # the head fold, the folded head's channel order, the phase-split
        # head's per-phase weights
        monkeypatch.setattr(net, name, counting(getattr(net, name), name))
    # the packed tail's head weights for the head kernels
    monkeypatch.setattr(net, "_packed_tail", counting(
        net._packed_tail, "_packed_tail",
        lambda self, *a, **k: self.out_nc == 3 and (
            self.pallas_tail or self.pallas_head or self.pallas_output)))
    return calls


@pytest.mark.parametrize("bucket", [0, 8], ids=["unbucketed", "bucketed"])
def test_served_request_spans(monkeypatch, server, bucket):
    monkeypatch.setitem(server.opt, "eval_bucket_multiple", bucket)
    calls = _count_preparations(monkeypatch)
    server.feed_data(_batch(2, 7, 9))
    sr, spans = _annotations(server.test)
    assert sr.shape == (2, 56, 72, 3)
    names = [n for n, _, _ in spans]
    assert names.count("serve.inputs") == names.count("serve.forward") == 1
    (_, i0, i1), = [s for s in spans if s[0] == "serve.inputs"]
    (_, f0, f1), = [s for s in spans if s[0] == "serve.forward"]
    assert i1 <= f0
    net = [s for s in spans if s[0].startswith("net.")]
    assert {"net.encoder", "net.branches", "net.trunk", "net.tail",
            "net.prepare"} <= {n for n, _, _ in net}
    assert all(f0 <= s and e <= f1 for _, s, e in net)
    prepares = [s for s in net if s[0] == "net.prepare"]
    # one span a preparation, none inside another
    assert len(prepares) == len(calls) > 10
    ends = [e for _, _, e in prepares]
    assert all(s >= e for (_, s, _), e in zip(prepares[1:], ends))
    kernels = {n for n, _, _ in spans if n.startswith("kernel.")}
    assert kernels == ({"kernel.packed_g123", "kernel.head_dot",
                        "kernel.output_stage_x8", "kernel.style_blend_dot"}
                       if not bucket else
                       {"kernel.style_dot_hwbm", "kernel.output_stage"})


def test_training_step_spans_in_order():
    torch.manual_seed(0)
    model = FModelDepthCond(train_opt(), device="cpu")
    model.feed_data(_batch(2, 8, 8, scale=8))
    logs, spans = _annotations(lambda: model.optimize_parameters(1))
    assert np.isfinite(logs["l_all"])
    steps = [s for s in spans if s[0].startswith("train.")]
    assert [n for n, _, _ in steps] == list(TRAIN_STEPS)
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))
    names = {n for n, _, _ in spans}
    assert "net.prepare" in names and "kernel.output_stage_x8_vjp" in names
    assert not any(n.startswith("dp.") for n in names)     # no mesh


def test_data_parallel_step_opens_dp_spans(tmp_path):
    ranks = run_ranks("traced_step", 2,
                      {"opt": train_opt(), "batch": _batch(4, 8, 8, scale=8)},
                      tmp_path)
    for names in ranks:
        assert [n for n in names if n.startswith("train.")] == \
            list(TRAIN_STEPS)
        assert {"dp.allreduce_grads", "dp.global_sum",
                "dp.mean_over_ranks"} <= set(names)
