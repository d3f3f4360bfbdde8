"""The controls of a cell's check, read at the cell's own size: the
reference computed in the next precision below the configuration's (TF32
products for float32) put in the program's place, and the faults the
cell's check must catch, each against the reference, on each seed.

    python3 b3dbench/control.py --workload NAME --seeds 11 12 13

The TF32 control; half of each batch left out (the loss over the rest); a
step that leaves the state unchanged. Prints one JSON line per seed and
reading. Not part of a benchmark run.

    python3 b3dbench/control.py --workload NAME --seeds 11 12 13 --program 1

reads the program's sound runs instead, in one process: per seed the run's
set-up, a one-second window and its check.
"""

import argparse
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core  # noqa: E402


def readings(workload: str, seed: int, device, overrides=None, bench=None) -> dict:
    """{reading: gaps} of one seed; ``overrides`` and ``bench`` as
    ``core.run``'s."""
    bench = bench or core.read_json(core.CHECKOUT / "BENCHMARK.json")
    wl, cfg, mix, limits = core.cell(bench, workload)
    cfg.update((overrides or {}).get("cfg", {}))
    mix.update((overrides or {}).get("mix", {}))
    driver = core.load_module(core.HERE / "drivers" / f"{mix['driver']}.py", "b3d_control")
    ctx = types.SimpleNamespace(cfg=cfg, mix=mix, seed=seed, device=device, trace=False,
                                workload=wl, limits=limits)
    out = {}
    st = driver.inputs(ctx)
    ref = driver.reference_outputs(st, "f64")
    out["tf32"] = driver.compare.train_gaps(driver.reference_outputs(st, "tf32"), ref)
    out["half_batch"] = driver.compare.train_gaps(
        driver.reference_outputs(st, "f64", fault="half_batch"), ref)
    still = {**ref, "change": {k: 0 * v for k, v in ref["change"].items()}}
    out["state_unchanged"] = driver.compare.train_gaps(still, ref)
    return out


def program_readings(workload: str, seed: int, device, seconds: float = 1.0) -> dict:
    """The program's compared numbers on one seed: a run's set-up, a short
    window and its check, in this process."""
    import time

    bench = core.read_json(core.CHECKOUT / "BENCHMARK.json")
    wl, cfg, mix, limits = core.cell(bench, workload)
    driver = core.load_module(core.HERE / "drivers" / f"{mix['driver']}.py", "b3d_program")
    ctx = types.SimpleNamespace(cfg=cfg, mix=mix, seed=seed, device=device, trace=False,
                                workload=wl, limits=limits,
                                stages=core.Stages(time.perf_counter()))
    st = driver.setup(ctx)
    driver.summarize(st, driver.window(st, seconds))
    driver.release(st)
    return {"program": driver.check(st)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program", type=int, default=0)
    args = ap.parse_args()
    import torch

    read = program_readings if args.program else readings
    for seed in args.seeds:
        for name, gaps in read(args.workload, seed, torch.device(args.device)).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              "gaps": gaps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
