"""CPU tests of the benchmark harness (``benchmark/``), at tiny sizes.

    python -m pytest benchmark/tests -q

The card tests (marker ``card``) skip here; on the card they run a cell
through ``run.py``.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"

from benchmark.harness import (FORBIDDEN, forbidden_modules,  # noqa: E402
                               load_cell, load_module)
from benchmark.roofline import kernels as K  # noqa: E402
from benchmark.roofline.flops import model_flops  # noqa: E402
from benchmark.run import Context, _per_layer, run_cell  # noqa: E402

SEED = 2**33 + 5
TINY_X8 = {"network_G": {"nb": 4, "depth_latent_ch": 16,
                         "which_ResBlk_depth": [0]}}
TINY_X2 = {"network_G": {"nb": 4, "depth_latent_ch": 8,
                         "which_ResBlk_depth": [0, 1, 2, 3]}}
SERVE = {"batch": 2, "lr_hw": [16, 16], "pool": 2, "warmup": 1, "sample": 2,
         "sample_within": 3, "sample_frames": 2, "trace_units": 3,
         "ref_block": 2}
TRAIN = {"batch": 2, "lr_hw": [16, 16], "pool": 4, "check_steps": 3,
         "trace_units": 2}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(name):
    over = dict(TINY_X2 if name.startswith("x2") else TINY_X8)
    t = dict(TRAIN if "train" in name else SERVE)
    if name.startswith("x2"):
        t.update(batch=1, lr_hw=[24, 20], ref_block=1, sample_frames=1)
    over["traffic"] = t
    return load_cell(name, overrides=over)


def run_tiny(cell, trace=0, seconds=0.5, seed=SEED):
    torch.set_num_threads(2)
    return run_cell(Context(cell, seed, seconds, trace, torch.device("cpu"),
                            t_start=time.perf_counter()))


def correct(out):
    return out.failed == 0 and all(c.ok for c in out.checks)


# ---------------------------------------------------------------- by name

@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cells_configs_metrics_found_by_name(cell):
    b = bench()
    c = load_cell(cell)
    entry = next(w for w in b["workloads"] if w["name"] == cell)
    assert c.spec["config"] == entry["config"] == c.config["name"]
    assert c.chips == entry["chips"]
    assert callable(load_module("traffic", c.traffic["kind"]).run)
    assert c.per_layer and c.end_to_end
    for m in c.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert set(c.spec["limits"]) and all(
        isinstance(v, (int, float)) for v in c.spec["limits"].values())


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_declared_metric_reads_a_trace_of_its_cell(cell):
    """On a trace holding a program kernel, a library kernel, a copy and an
    NCCL kernel, with the route counters the cell's plan expects, every
    per-layer metric declared for the cell returns a finite number."""
    from benchmark.roofline.plan import serve_plan
    from benchmark.tracing import Trace

    c = load_cell(cell)
    units = 2
    plan = serve_plan(c.config, c.traffic, c.spec.get("opt", {})) or {}
    ops = [("void output_stage_x8_vec16_kernel<bf16>(float*)", 0, 10**9,
            "kernel"),
           ("void at::native::add_kernel(float*)", 0, 2 * 10**8, "kernel"),
           ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 3 * 10**8, 4 * 10**8,
            "kernel"),
           ("Memcpy HtoD (Pageable -> Device)", 5 * 10**8, 6 * 10**8,
            "memcpy")]
    trace = Trace(ops, [], [], window_s=2.0, units=units,
                  frames=units * c.traffic["batch"],
                  extra={"calls": {k: len(v) * units for k, v in plan.items()}})
    for m in c.per_layer:
        v = load_module("metrics", m["name"]).read(trace, c)
        assert v is not None and v == v and v > 0, m["name"]
        if m["unit"] == "%":
            assert v < 100, m["name"]


def test_benchmark_json_names_files_that_exist():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in b["workloads"]:
        assert (BENCH / "workloads" / f"{w['traffic']}.json").exists()
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


# ------------------------------------------------------ runs on the CPU

@pytest.mark.parametrize("name", ["x8_offline_b32", "x8_train_b8",
                                  "x2_live_b1"])
def test_tiny_cell_runs_and_is_correct(name):
    out = run_tiny(tiny(name))
    assert out.attempted > 0 and out.failed == 0
    assert correct(out), [(c.name, c.value, c.limit) for c in out.checks]
    assert all(v > 0 for k, v in out.metrics.items()
               if k != "peak_device_gib")


def test_traced_tiny_run_reads_layer_metrics():
    cell = tiny("x8_train_b8")
    out = run_tiny(cell, trace=1)
    assert out.trace is not None and out.trace.units == 2
    got = _per_layer(cell, out)
    # no device on the CPU: only the metrics that need no device events
    assert set(got) <= {m["name"] for m in cell.per_layer}
    assert "mfu.train" in got and 0 < got["mfu.train"]["value"] < 100


def test_no_card_exits_nonzero_without_a_result():
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "x8_offline_b32", "--seed", str(2**31 + 99),
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert not r.stdout.strip()         # no line, so no device number
    assert "no CUDA device" in r.stderr


def test_only_files_in_a_copy_without_the_program_fail(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "x8_offline_b32", "--seed", "7", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()


# ------------------------------------------- added as files, in a copy

_NEW_CELL = {
    "name": "tmp_x4_tiny", "config": "tmp_x4", "chips": 1,
    "why": "a throwaway cell", "opt": {"eval_bucket_multiple": 0},
    "traffic": {"kind": "serve_closed", **SERVE},
    "limits": {"frame_nsr": 1e-4, "max_abs": 1e-4},
}
_NEW_METRIC = '''"""Frames traced a request."""


def read(trace, cell):
    return trace.frames / trace.units if trace.units else None
'''
_DRIVE = '''
import json, sys, time, torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from benchmark.harness import load_cell
from benchmark.run import Context, run_cell, _per_layer
torch.set_num_threads(2)
cell = load_cell("tmp_x4_tiny")
out = run_cell(Context(cell, 11, 0.5, 1, torch.device("cpu"),
                       t_start=time.perf_counter()))
print(json.dumps({"ok": all(c.ok for c in out.checks), "failed": out.failed,
                  "metrics": _per_layer(cell, out)}))
'''


def test_cell_config_and_metric_added_as_files_only(tmp_path):
    new = tmp_path / "benchmark"
    shutil.copytree(BENCH, new, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((BENCH / "configs" / "depthnet_x8_kvasir.json").read_text())
    cfg.update(name="tmp_x4", scale=4, serve_precision=None)
    cfg["network_G"].update(upscale=4, **TINY_X8["network_G"])
    (new / "configs" / "tmp_x4.json").write_text(json.dumps(cfg))
    (new / "workloads" / "tmp_x4_tiny.json").write_text(json.dumps(_NEW_CELL))
    (new / "metrics" / "frames_per_request.tmp.py").write_text(_NEW_METRIC)
    b = bench()
    b["configs"].append({"name": "tmp_x4", "source": "https://example.org",
                         "file": "benchmark/configs/tmp_x4.json",
                         "reduced": [], "why": "throwaway"})
    b["workloads"].append({"name": "tmp_x4_tiny", "config": "tmp_x4",
                           "traffic": "tmp_x4_tiny", "chips": 1,
                           "why": "throwaway"})
    b["per_layer"].append({"name": "frames_per_request.tmp", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "serving model",
                           "moves": "sr_frames_per_s",
                           "workloads": ["tmp_x4_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "drive.py").write_text(_DRIVE)
    r = subprocess.run([sys.executable, str(tmp_path / "drive.py"),
                        str(tmp_path), str(ROOT)], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["ok"] and got["failed"] == 0
    assert got["metrics"]["frames_per_request.tmp"]["value"] == SERVE["batch"]


# --------------------------------------------------- nothing of JAX

def test_no_jax_or_jax_package_after_a_run():
    code = ("import sys, time, torch; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.harness import forbidden_modules;"
            "from benchmark.run import Context, run_cell;"
            "import benchmark.tests.test_bench_harness as t;"
            "run_cell(Context(t.tiny('x8_offline_b32'), 3, 0.3, 1,"
            " torch.device('cpu'), t_start=time.perf_counter()));"
            "print(forbidden_modules(), 'endosr_torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "endosr_torch_lookalike", sys)
    assert "endosr" in FORBIDDEN and forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert forbidden_modules() == ["flax"]


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN + ("endosr_torch",), (f, n)
                assert top in ("torch", "numpy", "math", "benchmark",
                               "__future__"), (f, n)
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.depthnet, benchmark.reference.train;"
            "print(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('endosr_torch', 'endosr', 'jax')))")
    r = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                       capture_output=True, text=True, timeout=300)
    assert r.stdout.strip() == "[]", r.stderr[-2000:]


# ------------------------------------- the reference against the port

@pytest.mark.parametrize("scale,net,hw", [
    (8, TINY_X8["network_G"], (16, 16)),
    (2, TINY_X2["network_G"], (24, 20)),
    (8, {"nb": 16, "depth_latent_ch": 256,
         "which_ResBlk_depth": list(range(14))}, (8, 12)),
])
def test_reference_matches_the_ports_plain_path(scale, net, hw):
    from benchmark.inputs import frames
    from benchmark.reference.depthnet import forward
    from benchmark.weights import calibrate_output, make_params
    from endosr_torch.models.f_depthcond import FModelDepthCond

    torch.set_num_threads(2)
    cfg = {"scale": scale, "nb": net["nb"], "depth_masks": 10,
           "depth_latent_ch": net["depth_latent_ch"],
           "which_ResBlk_depth": net["which_ResBlk_depth"]}
    params = make_params(cfg, SEED, "cpu")
    gen = torch.Generator().manual_seed(3)
    x = frames(gen, 2, hw, 10, "cpu")
    calibrate_output(params, cfg, *x)
    g = json.loads((BENCH / "configs" / "depthnet_x8_kvasir.json")
                   .read_text())["network_G"]
    g.update(upscale=scale, preset="plain", **net)
    model = FModelDepthCond({
        "is_train": False, "scale": scale, "precision": None,
        "eval_bucket_multiple": 0,
        "datasets": {"test": {"depthMaskNum": 10}}, "network_G": g,
        "path": {}}, device="cpu")
    model.netG.load_state_dict(params, strict=True)
    model.feed_data({"LQ": x[0].numpy(), "Depth": x[1].numpy(),
                     "DepthMaskList": x[2].numpy()})
    sr = model.test()
    ref = forward(params, cfg, *x)
    assert sr.shape == ref.shape
    assert float((sr - ref).abs().max()) <= 1e-5
    assert float(ref.std()) > 0.02          # not clamped flat


# ---------------------------------------------- a broken timed path

def _serve_fault(monkeypatch, kind):
    from endosr_torch.models.f_depthcond import FModelDepthCond

    orig = FModelDepthCond.test

    def test(self):
        sr = orig(self)
        if kind == "altered":            # one frame's rows come out reversed
            sr = sr.clone()
            sr[0] = sr[0].flip(0)
        else:                            # half the batch left out
            sr = sr[:max(1, sr.shape[0] // 2)]
        self.fake_SR = sr
        return sr

    monkeypatch.setattr(FModelDepthCond, "test", test)


@pytest.mark.parametrize("kind", ["altered", "half_batch"])
def test_serving_faults_come_out_incorrect(monkeypatch, kind):
    _serve_fault(monkeypatch, kind)
    assert not correct(run_tiny(tiny("x8_offline_b32")))


def _train_fault(monkeypatch, kind):
    from endosr_torch.models.f_depthcond import FModelDepthCond

    if kind == "unchanged":
        orig_init = FModelDepthCond._init_training

        def init(self, t):
            orig_init(self, t)
            step = self.optimizer_G.step
            params = [p for g in self.optimizer_G.param_groups
                      for p in g["params"]]

            def frozen(*a, **k):         # Adam runs, the state stays
                keep = [p.detach().clone() for p in params]
                step(*a, **k)
                with torch.no_grad():
                    for p, v in zip(params, keep):
                        p.copy_(v)

            self.optimizer_G.step = frozen

        monkeypatch.setattr(FModelDepthCond, "_init_training", init)
    else:                                # half the batch, mean over the rest
        orig = FModelDepthCond.feed_data
        monkeypatch.setattr(
            FModelDepthCond, "feed_data", lambda self, d: orig(
                self, {k: v[:v.shape[0] // 2] for k, v in d.items()}))


@pytest.mark.parametrize("kind", ["unchanged", "half_batch"])
def test_training_faults_come_out_incorrect(monkeypatch, kind):
    _train_fault(monkeypatch, kind)
    assert not correct(run_tiny(tiny("x8_train_b8")))


def _dp_rank(rank, world, device, mesh, fault):
    torch.set_num_threads(1)
    if fault:                            # the exchange between chips left out
        import endosr_torch.models.base as base
        base.allreduce_grads = lambda params, mesh=None: None
    cell = load_cell("x8_train_dp4", overrides={
        **TINY_X8, "traffic": {**TRAIN, "batch": 4}})
    out = run_cell(Context(cell, SEED, 0.3, 0, device, rank, world, mesh,
                           time.perf_counter()))
    return (correct(out), sorted(out.metrics)) if rank == 0 else None


@pytest.mark.parametrize("fault", [False, True])
def test_data_parallel_step_on_two_cpu_ranks(fault):
    """The harness's own rank launcher (``launch_ranks``, as run.py starts
    a several-card cell) on two gloo ranks."""
    from benchmark.harness import launch_ranks

    ok, metrics = launch_ranks(_dp_rank, 2, fault, backend="gloo")[0]
    assert ok is (not fault)
    assert metrics == ["peak_device_gib", "setup_s", "train_images_per_s.dp"]


def _failing_rank(rank, world, device, mesh):
    if rank == 1:
        raise RuntimeError("a planted failure")
    torch.distributed.barrier()          # waits for a rank that never comes
    return rank


def test_launch_ranks_names_a_failed_rank_and_ends_the_others():
    from benchmark.harness import launch_ranks

    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="exit codes"):
        launch_ranks(_failing_rank, 2, backend="gloo")
    assert time.perf_counter() - t0 < 120


@pytest.mark.parametrize("name,lr", [("x8_offline_b32", [16, 16]),
                                     ("x2_live_b1", [64, 64])])
def test_control_comes_out_incorrect(name, lr):
    """The cell's control (x8: the reference in fp8; x2: the program in
    bf16) fails a limit the program meets, at the configuration's widths
    and depth on small frames."""
    from benchmark.controls import reading

    torch.set_num_threads(4)
    t = dict(SERVE, lr_hw=lr)
    if name.startswith("x2"):
        t.update(batch=1, ref_block=1, sample_frames=1)
    cell = load_cell(name, overrides={"traffic": t})
    ctl = cell.spec["control"]
    kind = "control:" + (ctl.get("numerics") or ctl.get("precision"))
    lim = cell.spec["limits"]
    # a window long enough to serve every sampled request
    prog = reading(cell, "program", SEED, 3.0, torch.device("cpu"))
    low = reading(cell, kind, SEED, 3.0, torch.device("cpu"))
    assert all(prog[k] <= lim[k] for k in lim), prog
    assert any(low[k] > lim[k] for k in lim), low


# ------------------------------------------------- roofline and FLOPs

def test_roofline_bounds_match_the_kernel_table():
    """The bound ms of PERF.md's kernel table (bf16, B 8, LR 128)."""
    b, ms = 8, 1e3
    got = {
        "packed_g123": (K.bound_s(K.packed_g123(b, 128, 128, 256, False, 2))
                        + K.bound_s(K.packed_g123(b, 129, 129, 128, True, 2,
                                                  pre_bias=True))) * ms,
        "style_blend_dot": sum(K.bound_s(K.style_blend_dot(b, 128, 128, 90,
                                                           m, 2))
                               for m in (1792, 1536)) * ms,
        "head_dot": K.bound_s(K.head_dot(b, 257, 257, 256, 512, 64, 2)) * ms,
        "output_stage_x8": K.bound_s(K.output_stage_x8(256 * b * 256, 2)) * ms,
        "output_stage": K.bound_s(K.output_stage(b, 256, 256, 4, 2)) * ms,
        "style_dot_hwbm": sum(K.bound_s(K.style_dot_hwbm(b, 128, 128, 90, m,
                                                         2))
                              for m in (1792, 1536)) * ms,
    }
    table = {"packed_g123": 0.281, "style_blend_dot": 0.536,
             "head_dot": 0.313, "output_stage_x8": 0.0501,
             "output_stage": 0.0451, "style_dot_hwbm": 0.276}
    for k, v in table.items():
        assert abs(got[k] - v) <= 0.0006 * max(1.0, v / 0.1), (k, got[k], v)


@pytest.mark.parametrize("cell,gflop", [("x8_offline_b32", 236.8),
                                        ("x2_live_b1", 3211.0)])
def test_model_flops_a_frame(cell, gflop):
    c = load_cell(cell)
    got = model_flops(c.net, c.traffic["lr_hw"]) / 1e9
    assert abs(got - gflop) <= 0.01 * gflop, got


def test_serve_plan_counts_the_kernels_the_path_calls():
    from benchmark.roofline.plan import serve_plan

    c = load_cell("x8_offline_b32")
    plan = serve_plan(c.config, c.traffic, c.spec["opt"])
    assert {k: len(v) for k, v in plan.items()} == {
        "packed_g123": 2, "style_blend_dot": 2, "head_dot": 1,
        "output_stage_x8": 1}
    c = load_cell("x2_live_b1")
    plan = serve_plan(c.config, c.traffic, c.spec["opt"])
    assert {k: len(v) for k, v in plan.items()} == {"style_dot_hwbm": 2,
                                                    "output_stage": 1}


# ----------------------------------------------------------- the card

@pytest.mark.card
@pytest.mark.parametrize("cell", ["x8_offline_b32", "x8_train_b8",
                                  "x2_live_b1"])
def test_cell_on_the_card(card, cell):
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        cell, "--seed", str(2**31 + 4242), "--seconds", "10",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
