"""The flagship's AMOTA error bar for the PyTorch port, as
``scripts/flagship_error_bar.py`` measures it for the JAX package.

Two axes, kept apart:

  1. N training seeds (init + shuffle; identical scenes) x 80 epochs, each
     scored on a widened 30-scene held-out set -> mean +- std over seeds at
     a fixed eval set (training sensitivity);
  2. one checkpoint (seed 0) re-scored on the original 3-scene set and on
     the 30-scene set -> the eval-set-size axis (metric variance) with
     training held fixed.

Each run is its own process (``scripts/torch_flagship_synthetic.py``); the
kernels are built once, by the first, into the checkout's build directory.
The options, defaults and the ``SWEEP SUMMARY {...}`` line are the JAX
script's; ``--device`` (default: the GPU, which must exist) goes to every
run. At the sweep's shape (80 epochs, 30 held-out scenes) the seeds must
meet the JAX package's band, or the script exits non-zero after its
summary: mean AMOTA within 0.003 of 0.9865, every seed at 0.980 or above.

Run (one GPU): python scripts/torch_flagship_error_bar.py [--seeds 5] [--epochs 80]
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))


# the JAX package's sweep (docs/flagship_sweep_r05.json: 0.9865 +- 0.0004
# over 5 seeds) and the band the port's seeds are held to at its shape
JAX_AMOTA = 0.9865
BAND_MEAN, BAND_MIN = 0.003, 0.980
BAND_SHAPE = (80, 30)  # epochs, held-out scenes


def band_misses(amotas):
    """What of the band the per-seed AMOTAs miss (empty when they meet it;
    a seed whose AMOTA is not a number misses it)."""
    mean = float(np.mean(amotas))
    misses = [f"seed {s}: AMOTA {a:.4f} < {BAND_MIN}"
              for s, a in enumerate(amotas) if not a >= BAND_MIN]
    if not abs(mean - JAX_AMOTA) <= BAND_MEAN:
        misses.append(f"mean AMOTA {mean:.4f} not within {BAND_MEAN} of {JAX_AMOTA}")
    return misses


def seed_argv(seed, epochs, val_scenes, checkpoint):
    """The flagship's arguments for one training seed of the sweep."""
    return ["--epochs", str(epochs), "--train-seed", str(seed),
            "--val-scenes", str(val_scenes), "--save-checkpoint", checkpoint]


def run_flagship(extra, log_path):
    cmd = [sys.executable, os.path.join(HERE, "torch_flagship_synthetic.py"), *extra]
    print(f"$ {' '.join(cmd)}", flush=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(log_path, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"flagship run failed, log: {log_path}\n{proc.stderr[-2000:]}")
    m = re.search(r"^FLAGSHIP (\{.*\})$", proc.stdout, re.M)
    assert m, f"no FLAGSHIP summary line in {log_path}"
    for line in re.findall(r"^(?:kernels|training:) .*$", proc.stdout, re.M):
        print(f"  {line}", flush=True)
    print(f"  {m.group(0)}", flush=True)
    return json.loads(m.group(1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--val-scenes", type=int, default=30)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "b3d_torch_flagship_sweep"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where to compute (default: the GPU, which must exist)")
    args = ap.parse_args(argv)
    from batch3dmot_tpu_torch import resolve_device
    from batch3dmot_tpu_torch.eval.tracking_metrics import json_safe

    device = ["--device", resolve_device(args.device).type]
    os.makedirs(args.workdir, exist_ok=True)

    runs = []
    for seed in range(args.seeds):
        ckpt = os.path.join(args.workdir, f"seed{seed}.pt")
        summary = run_flagship(
            seed_argv(seed, args.epochs, args.val_scenes, ckpt) + device,
            os.path.join(args.workdir, f"seed{seed}.log"),
        )
        print(f"seed {seed}: AMOTA {summary['amota']:.4f} "
              f"(trainAP {summary['final_train_ap']:.4f}, "
              f"{summary['steps_per_s']:.1f} steps/s)", flush=True)
        runs.append(summary)

    # eval-set-size axis: one checkpoint, two held-out set sizes
    ckpt0 = os.path.join(args.workdir, "seed0.pt")
    rescore = {}
    for n_val in (3, args.val_scenes):
        s = run_flagship(
            ["--epochs", str(args.epochs), "--load-checkpoint", ckpt0,
             "--val-scenes", str(n_val), *device],
            os.path.join(args.workdir, f"rescore_val{n_val}.log"),
        )
        rescore[n_val] = s["amota"]
        print(f"seed-0 checkpoint on {n_val} held-out scenes: AMOTA {s['amota']:.4f}",
              flush=True)

    amotas = np.array([r["amota"] for r in runs])
    amotps = np.array([r["amotp"] for r in runs])
    out = {
        "seeds": args.seeds,
        "epochs": args.epochs,
        "val_scenes": args.val_scenes,
        "amota_per_seed": [round(float(a), 4) for a in amotas],
        "amota_mean": round(float(amotas.mean()), 4),
        "amota_std": round(float(amotas.std(ddof=1)), 4),
        "amotp_mean": round(float(amotps.mean()), 4),
        "amotp_std": round(float(amotps.std(ddof=1)), 4),
        "rescore_seed0": {str(k): round(float(v), 4) for k, v in rescore.items()},
    }
    out = json_safe(out)
    with open(os.path.join(args.workdir, "sweep_summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("SWEEP SUMMARY " + json.dumps(out), flush=True)
    if (args.epochs, args.val_scenes) == BAND_SHAPE:
        misses = band_misses(amotas)
        if misses:
            raise SystemExit("outside the JAX package's band: " + "; ".join(misses))
    return out


if __name__ == "__main__":
    main()
