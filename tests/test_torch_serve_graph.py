"""CUDA-graph serving (``endosr_torch/models/serve_graph.py``) on the CPU.

The graphs themselves run on the card only (``chip_smoke.py --p17``); here:
``test()`` on the CPU stays eager and ``graph_stats`` counts it so; when a
call engages; what a key tells apart; a key's first call runs eager and its
second gets static inputs holding its arrays, the last ``KEPT`` keys are
kept and moved weights drop them; the launch counters' snapshot, undo and
advance; the tensors a capture holds; the blend's pointer table.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from endosr_torch.kernels import _counters
from endosr_torch.kernels import style_dot as sd
from endosr_torch.models import serve_graph as sg
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.utils.device import device_constant, held

K = 4
SERVE = {
    "is_train": False, "model": "sftmd_depthCond", "scale": 4,
    "precision": None, "eval_bucket_multiple": 0,
    "datasets": {"test": {"depthMaskNum": K, "LR_size": 8}},
    "network_G": {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3,
                  "nf": 64, "nb": 4, "depth_latent_ch": 16,
                  "which_ResBlk_depth": [0], "use_trainable_params": True},
    "path": {},
}


def _batch(b=1, h=8, w=8, seed=3):
    rng = np.random.default_rng(seed)
    return {"LQ": rng.random((b, h, w, 3), dtype=np.float32),
            "Depth": rng.random((b, h, w, 1), dtype=np.float32),
            "DepthMaskList": (rng.random((b, h, w, K)) > 0.6).astype(
                np.float32)}


def test_cpu_serving_stays_eager_and_counts_every_call():
    m = FModelDepthCond(SERVE, device="cpu")
    m.feed_data(_batch())
    first = m.test().clone()
    again = m.test()
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    m.test_x8()
    m.opt["eval_bucket_multiple"] = 4
    m.test()
    assert m.graph_stats == {"eager": 11, "captures": 0, "replays": 0}


@pytest.mark.parametrize("device, bucket, nsp, optimizer, want", [
    ("cuda", 0, 0, None, True),
    ("cuda:1", 0, 0, None, True),
    ("cuda", 32, 0, None, False),          # bucketed: the masked forward
    ("cuda", 32, 2, None, False),          # sharded
    ("cuda", 0, 0, object(), False),       # a training run's validation
    ("cpu", 0, 0, None, False),
])
def test_engaged_only_unbucketed_unsharded_on_cuda_without_optimizer(
        device, bucket, nsp, optimizer, want):
    assert sg.engaged(torch.device(device), bucket, nsp, optimizer) is want


def _x(h=8, w=8, dtype=torch.float32):
    return [torch.zeros(2, h, w, c, dtype=dtype) for c in (3, 1, K)]


@pytest.mark.parametrize("change", [
    lambda x: _x(h=16),                                        # shape
    lambda x: _x(dtype=torch.bfloat16),                        # dtype
    lambda x: [x[0].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
               *x[1:]],                                        # strides
    lambda x: [x[0], x[1], x[2][:1]],                          # one batch
])
def test_key_changes_with_shape_dtype_and_strides(change):
    x = _x()
    key = sg.graph_key(x, "cuda", 8)
    assert sg.graph_key(_x(), "cuda", 8) == key
    assert sg.graph_key(change(x), "cuda", 8) != key
    assert sg.graph_key(x, "cuda", 4) != key
    assert sg.graph_key(x, "cuda:1", 8) != key


def test_fill_eager_first_then_static_inputs_lru_and_moved_weights():
    net = torch.nn.Linear(2, 2)
    graphs = sg.ServingGraphs(net, None, 8, "cpu")
    x = [torch.full((1, 4, 4, c), float(c)) for c in (3, 1, K)]
    assert graphs.fill(x) is None                      # first sighting
    g = graphs.fill(x)
    assert g is not None and g.graph is None
    for s, t in zip(g.inputs, x):
        assert s.data_ptr() != t.data_ptr() and torch.equal(s, t)
    y = [t + 1 for t in x]
    assert graphs.fill(y) is g                         # the same buffers
    assert all(torch.equal(s, t) for s, t in zip(g.inputs, y))
    # KEPT other keys, each seen once, push the graph out
    for i in range(sg.KEPT):
        assert graphs.fill(_x(h=16 + 4 * i)) is None
    assert graphs.fill(x) is None
    assert graphs.fill(x) is not g
    # weights in new storage drop every graph
    net.weight = torch.nn.Parameter(net.weight.detach().clone())
    assert graphs.fill(x) is None


class _Fake:
    def __init__(self, **routes):
        self.launches = sum(routes.values())
        self.routes = dict(routes)

    def __call__(self):
        pass

    def hit(self, route, n=1):
        self.launches += n
        self.routes[route] += n


def test_counter_snapshot_undo_and_advance():
    a, b, c = _Fake(tc=3, cuda_core=1), _Fake(vec16=2, v1=0), _Fake(x=5)
    snap = _counters.snapshot([a, b, c])
    a.hit("tc", 2)
    a.hit("cuda_core")
    b.hit("v1")
    counts = _counters.since(snap)
    assert [(fn, n, r) for fn, n, r in counts] == [
        (a, 3, {"tc": 2, "cuda_core": 1}), (b, 1, {"v1": 1})]
    _counters.advance(counts, -1)                      # a capture's undone
    assert (a.launches, a.routes) == (4, {"tc": 3, "cuda_core": 1})
    assert (b.launches, b.routes) == (2, {"vec16": 2, "v1": 0})
    _counters.advance(counts)
    _counters.advance(counts)                          # two replays
    assert (a.launches, a.routes) == (10, {"tc": 7, "cuda_core": 3})
    assert (b.launches, b.routes) == (4, {"vec16": 2, "v1": 2})
    assert (c.launches, c.routes) == (5, {"x": 5})


def test_counter_wrappers_are_the_thirteen_counting_kernels():
    names = {fn.__name__ for fn in _counters.wrappers()}
    assert names == {
        "packed_g123", "style_blend_dot", "style_dot_hwbm", "head_dot",
        "output_stage_x8", "output_stage", "fused_in_mod",
        "fused_in_mod_stats", "in_stats", "fused_o_branch",
        "fused_modulation", "fused_tail", "mid_shuffle"}


def _arange(n):
    return np.arange(n, dtype=np.float32)


def test_held_keeps_the_constants_handed_out_inside():
    outside = device_constant(_arange, (3,), torch.float32, "cpu")
    with held() as kept:
        got = device_constant(_arange, (5,), torch.float32, "cpu")
        again = device_constant(_arange, (3,), torch.float32, "cpu")
    device_constant(_arange, (7,), torch.float32, "cpu")
    assert again is outside
    assert len(kept) == 2 and kept[0] is got and kept[1] is outside
    device_constant.cache_clear()
    assert device_constant(_arange, (5,), torch.float32, "cpu") is not got


def test_blend_passes_its_conv_pointers_as_a_host_table():
    b, h, w, j, c2 = 1, 2, 4, 6, 8
    convs = [torch.zeros(h, w, b, c2) for _ in range(3)]
    shifted = torch.zeros(b, h, w, j)
    *_, table, _, _, _, _ = sd._blend_operands(
        shifted, torch.zeros(b, j, 3 * c2), convs, torch.zeros(3 * c2))
    assert isinstance(table, ctypes.Array)
    assert list(table) == [c.data_ptr() for c in convs]
    n = sd.MAX_CONVS + 1
    with pytest.raises(ValueError, match="at most"):
        sd._blend_operands(shifted, torch.zeros(b, j, n * c2),
                           [torch.zeros(h, w, b, c2)] * n,
                           torch.zeros(n * c2))
