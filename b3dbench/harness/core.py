"""One run of one cell: find the cell's files by name, set up, measure,
check, print the result.

    <command> --workload NAME --seed N --seconds S --trace 0|1

Everything is found from names in ``BENCHMARK.json``: the workload's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the mix's driver (``drivers/<driver>.py``),
each per-layer metric's reader (``metrics/<metric>.py``) and the cell's
limits (``limits/<workload>.json``). A driver module has ``setup(ctx)``,
``window(state, seconds)``, ``summarize(state, raw)`` (the window's
numbers, worked out after it), ``release(state)`` and ``check(state)``.

Set-up is timed from the start of the process to the start of the window.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the loop runs under the profiler).
After the window: the device's memory peak is read, the program's state is
freed, and the reference judges what the timed path produced. The numbers
compared, each with its limit, are the last lines on standard error and
the last key of the result, the last line of standard output.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
CHECKOUT = HERE.parent
PORT = "batch3dmot_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "batch3dmot_tpu")


class RunError(Exception):
    """A run that cannot give a result (exit code in ``code``)."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def load_module(path: Path, name: str):
    if not path.exists():
        raise RunError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.exists():
        raise RunError(f"missing {path}")
    return json.loads(path.read_text())


def cell(bench: dict, workload: str):
    """(workload entry, configuration, mix, limits) of a cell, by name."""
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = read_json(CHECKOUT / entry["file"])
    mix = read_json(HERE / "traffic" / f"{wl['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{workload}.json")
    return wl, cfg, mix, limits


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ((workload in m["workloads"]) if "workloads" in m else (m["moves"] in names))]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_facts() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class Stages:
    """Set-up's stages on standard error: ``mark(name)`` prints the seconds
    since the previous mark (the first since the process started)."""

    def __init__(self, t0: float):
        self.last = t0

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        print(f"setup stage {name}: {now - self.last:.3f} s", file=sys.stderr, flush=True)
        self.last = now


def judge(values: dict, limits: dict) -> dict:
    """{name: {value, limit}}; a value with no limit, or one that is not a
    finite number, fails."""
    out = {}
    for name, value in values.items():
        if name not in limits:
            raise RunError(f"no limit for the compared number {name!r}")
        out[name] = {"value": value, "limit": limits[name]}
    return out


def passed(checks: dict) -> bool:
    return all(isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks.values())


def run(argv, t0: float, device=None, overrides=None, bench=None) -> dict:
    """One run; returns the result object. ``device``, ``overrides``
    ({"cfg": {...}, "mix": {...}} laid over the cell's files) and ``bench``
    (in place of BENCHMARK.json) serve the CPU tests: no look for a card, a
    cell cut to a test's size, a cell the benchmark does not list."""
    ap = argparse.ArgumentParser(prog="run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = bench or read_json(CHECKOUT / "BENCHMARK.json")
    wl, cfg, mix, limits = cell(bench, args.workload)
    cfg.update((overrides or {}).get("cfg", {}))
    mix.update((overrides or {}).get("mix", {}))
    driver = load_module(HERE / "drivers" / f"{mix['driver']}.py", f"b3d_driver_{mix['driver']}")
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            raise RunError(f"the cell needs {wl['chips']} CUDA card(s); "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                           "available", 3)
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    ctx = types.SimpleNamespace(cfg=cfg, mix=mix, seed=args.seed, device=device,
                                trace=bool(args.trace), workload=wl,
                                limits=limits, stages=Stages(t0))
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py", f"b3d_metric_{i}")
               for i, m in enumerate(metrics_of(bench, wl["name"], True))} if args.trace else {}

    state = driver.setup(ctx)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    from harness.trace import Window

    with Window(args.trace and on_card) as win:
        raw = driver.window(state, args.seconds)
    summary = win.summary
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise RunError(f"modules of JAX or of the JAX package are loaded: {bad[:8]}", 4)
    driver.release(state)
    out = driver.summarize(state, raw)
    checks = judge(driver.check(state), limits)

    metrics = {}
    if not args.trace:
        for m in metrics_of(bench, wl["name"], False):
            value = setup_s if m["name"] == "setup_s" else out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": wl["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": passed(checks), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if args.trace and summary is not None:
        s = summary
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        view = types.SimpleNamespace(trace=s, work=out["work"], cfg=cfg,
                                     csrc=CHECKOUT / PORT / "csrc")
        for m in metrics_of(bench, wl["name"], True):
            value = readers[m["name"]].read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = s["breakdown"]
        print(f"traced window: {s['window_s']:.3f} s, {s['records']} device records; "
              f"card: {card_facts()}", file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv, t0: float) -> int:
    try:
        result = run(argv, t0)
    except RunError as e:
        print(f"run.py: {e}", file=sys.stderr)
        return e.code
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name}: {c['value']!r} <= {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
