"""The harness on the CPU at a tiny size: every file found by name, no JAX
anywhere, each cell's run correct, each fault the cells can have and
each control caught, the trace's reduction, and a run without the program
refused. The card's runs are ``test_cells_on_the_card`` (marked ``cuda``)."""

import dataclasses
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
import types
import weakref

import numpy as np
import pytest
import torch

from harness import core, trace

HERE = core.HERE
TINY = {"cfg": {"train_scenes": 2}, "mix": {"frames": 8, "tracks": 6}}
CELLS = ["clr-train-device", "pose-train-device"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return core.read_json(core.CHECKOUT / "BENCHMARK.json")


def _run(workload, seed=2 ** 31 + 11):
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "0.05", "--trace", "0"]
    return core.run(argv, time.perf_counter(), device="cpu", overrides=TINY, bench=_bench())


def _cells():
    return [w["name"] for w in _bench()["workloads"]]


def test_every_file_is_found_by_name():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])
    for wl in bench["workloads"]:
        _, cfg, mix, limits = core.cell(bench, wl["name"])
        driver = core.load_module(HERE / "drivers" / f"{mix['driver']}.py", "d")
        for fn in ("setup", "window", "summarize", "release", "check"):
            assert callable(getattr(driver, fn))
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())
        assert core.metrics_of(bench, wl["name"], False)
        assert core.metrics_of(bench, wl["name"], True)
    for m in bench["per_layer"]:
        assert callable(core.load_module(HERE / "metrics" / f"{m['name']}.py", "m").read)
        assert all(w in _cells() for w in m["workloads"])


def _imports_in_fresh_process(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(core.CHECKOUT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


PRELUDE = ("import sys, json; sys.path[:0] = ['b3dbench', '.']\n")


def test_no_jax_in_the_harness_and_no_program_in_the_reference():
    mods = _imports_in_fresh_process(
        PRELUDE + "import harness.core, harness.trace, harness.work, harness.port\n"
        "from harness import core\n"
        "import glob\n"
        "for i, p in enumerate(sorted(glob.glob('b3dbench/drivers/*.py') +"
        " glob.glob('b3dbench/metrics/*.py'))):\n"
        "    core.load_module(core.CHECKOUT / p, f'm{i}')\n"
        "import harness.port as hp; hp.port_model; "
        "import batch3dmot_tpu_torch.models, batch3dmot_tpu_torch.train.encoded, "
        "batch3dmot_tpu_torch.train.trainer\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & {"jax", "jaxlib", "flax", "batch3dmot_tpu"}
    ref = _imports_in_fresh_process(
        PRELUDE + "import reference.model, reference.graphs, "
        "reference.compare, harness.scenes, harness.weights, harness.work\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not ref & {"jax", "jaxlib", "flax", "batch3dmot_tpu", "batch3dmot_tpu_torch"}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_cpu(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = {m["name"] for m in core.metrics_of(_bench(), workload, False)}
    assert set(r["metrics"]) == names and "setup_s" in names
    assert list(r)[-1] == "checks"


def _still_step(self, batch):
    """A step that computes the loss and leaves the state unchanged."""
    self.optimizer.zero_grad(set_to_none=True)
    loss, scores = self._loss(batch)
    return loss.detach(), scores.detach()


def _half_batch(orig):
    from batch3dmot_tpu_torch.graph import PaddedGraph

    def loss(self, batch):
        graph, enc = batch if isinstance(batch, tuple) else (batch, None)
        h = graph.pose.shape[0] // 2
        g = PaddedGraph(**{f.name: getattr(graph, f.name)[:h]
                           for f in dataclasses.fields(graph)})
        value, scores = orig(self, g if enc is None else (g, tuple(t[:h] for t in enc)))
        return value, torch.cat([scores, scores.new_zeros(scores.shape)])
    return loss


def _epoch_cut(orig):
    """Index rows that leave out each epoch's last step."""
    def rows(*args, **kw):
        return orig(*args, **kw)[:-1]
    return rows


@pytest.mark.parametrize("workload,fault", [
    ("clr-train-device", "state_unchanged"), ("clr-train-device", "half_batch"),
    ("clr-train-device", "epoch_cut"),
    ("pose-train-device", "state_unchanged"), ("pose-train-device", "half_batch"),
    ("pose-train-device", "epoch_cut")])
def test_fault_in_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    from batch3dmot_tpu_torch.train import trainer

    if fault == "state_unchanged":
        monkeypatch.setattr(trainer.GNNTrainer, "_step", _still_step)
    elif fault == "half_batch":
        monkeypatch.setattr(trainer.GNNTrainer, "_loss", _half_batch(trainer.GNNTrainer._loss))
    elif fault == "epoch_cut":
        monkeypatch.setattr(trainer, "index_rows", _epoch_cut(trainer.index_rows))
    r = _run(workload)
    assert not r["correct"], r["checks"]


def test_release_frees_the_program():
    # a trainer left alive keeps its captured steps, and on a mesh their
    # collectives, past the run's end
    bench = _bench()
    wl, cfg, mix, limits = core.cell(bench, "pose-train-device")
    cfg.update(TINY["cfg"])
    mix.update(TINY["mix"])
    driver = core.load_module(HERE / "drivers" / "train_device.py", "b3d_release")
    ctx = types.SimpleNamespace(cfg=cfg, mix=mix, seed=2 ** 31 + 19, device=torch.device("cpu"),
                                trace=False, workload=wl, limits=limits,
                                stages=core.Stages(time.perf_counter()))
    st = driver.setup(ctx)
    driver.window(st, 0.05)
    alive = weakref.ref(st.trainer)
    driver.release(st)
    assert alive() is None


def _control():
    spec = importlib.util.spec_from_file_location("b3d_control_mod", HERE / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", CELLS)
def test_tf32_control_is_not_correct(workload):
    bench = _bench()
    _, _, _, limits = core.cell(bench, workload)
    reads = _control().readings(workload, 2 ** 31 + 13, torch.device("cpu"), TINY, bench)
    checks = core.judge(reads["tf32"], limits)
    assert not core.passed(checks), checks
    for name in ("state_unchanged", "half_batch"):
        assert not core.passed(core.judge(reads[name], limits)), (name, reads[name])


def _ev(start, end, name, device, thread=1):
    """A raw record, times in microseconds."""
    return (start * 1000, end * 1000, name, device, thread, False)


def test_trace_reduction():
    events = [_ev(0, 100, trace.WINDOW_SPAN, False),
              _ev(10, 30, "aten::mm", False), _ev(12, 14, "cudaLaunchKernel", False),
              _ev(60, 90, "host_round", False),
              _ev(20, 40, "edge_kernel(float const*)", True),
              _ev(30, 50, "void wgrad_kernel<1>(float*)", True),
              _ev(95, 130, "edge_kernel(float const*)", True)]
    s = trace.reduce_events(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)  # [20, 50] and [95, 100]
    assert trace.seconds_of(s["kernel_s"], {"edge_kernel"}) == pytest.approx(25e-6)
    assert trace.seconds_of(s["kernel_s"], {"wgrad_kernel"}) == pytest.approx(20e-6)
    # idle [0, 20] (midpoint inside aten::mm) and [50, 95] (inside host_round)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"host_round": 45e-6, "aten::mm": 20e-6})


def test_kernels_by_source():
    csrc = core.CHECKOUT / core.PORT / "csrc"
    fwd = trace.source_kernels(csrc, "fused_mp.cu")
    assert {"edge_kernel", "node_kernel", "proj_kernel"} <= fwd
    assert "segment_sum_kernel" in trace.source_kernels(csrc, "segment_sum.cu")
    assert "wgrad_kernel" in trace.source_kernels(csrc, "fused_mp_train.cu")


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(core.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, f"{HERE.name}/run.py", "--workload",
                          "clr-train-device", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cells_on_the_card(workload):
    chips = {w["name"]: w["chips"] for w in _bench()["workloads"]}[workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA CUDA card(s)")
    out = subprocess.run([sys.executable, "b3dbench/run.py", "--workload", workload, "--seed",
                          str(2 ** 31 + 17), "--seconds", "5", "--trace", "1"],
                         cwd=core.CHECKOUT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
    assert np.isfinite([m["value"] for m in r["metrics"].values()]).all()
