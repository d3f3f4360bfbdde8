"""The message-passing kernels of two checkouts of the repository in turns
on one NVIDIA GPU: the other checkout, this one, this one, the other; each
turn a process of its own that builds its checkout's kernels and times,
with CUDA events (``chip_smoke.cuda_ms``, three runs each):

  * the inference kernel (B1-B3, ``fused_mp_scores_cuda``) at (128, 1024)
    x6, (256, 4096) x8, (1024, 32768) x1, the device pipeline's (256,
    10240) x16 and the cover (2560, 102400) x1;
  * the stashing forward (B4/B6, ``train_forward_cuda``) and the backward
    (B5/B7) at the training batch (256, 4096) x8, whose windows keep half
    to all of their edges and a cotangent on every row;
  * the backward with the benchmark's training windows' tails: (256,
    4096) x8, and eight draws of the cells' step (256, 4096) x2 (their
    times summed), each window keeping as
    many valid edges as a window of ``b3dbench``'s ``train_device`` traffic
    (drawn from its windows, built on the host from the mix's layout), the
    cotangent zero on the masked rows as the masked loss gives it;

on random inputs of a numpy seed (``chip_smoke.random_inputs``) and the
full-width ``mm`` of ``init_params_``; then one ``fit_device`` epoch (the
dense dataset of ``chip_smoke.py``'s workload, 24 replayed steps of (256,
4096) x2) by the host clock, after a warm epoch.

    python scripts/ab_kernels.py OTHER_CHECKOUT

Prints each turn's times and, last, one JSON line with the card's name
and power limit. Compare two builds only within one such run."""

import json
import subprocess
import sys
from pathlib import Path

CODE = r'''
import sys, json, time, numpy as np, torch
tails = json.loads(sys.argv[1])
sys.path.insert(0, ".")
import chip_smoke as cs
from batch3dmot_tpu_torch.config import GNNConfig
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.ops import cuda_build
from batch3dmot_tpu_torch.ops.fused_mp import extract_mp_params, fused_mp_scores_cuda
from batch3dmot_tpu_torch.ops.fused_mp_train import fused_mp_train_scores, train_forward_cuda
from batch3dmot_tpu_torch.train.encoded import (materialize_encoded_dataset,
                                                precompute_scene_encodings)
from batch3dmot_tpu_torch.train.trainer import GNNTrainer
cuda_build.build(["fused_mp", "fused_mp_train", "segment_sum"])
model = init_params_(make_model("mm"), torch.Generator().manual_seed(0)).cuda().eval()
flat, meta = extract_mp_params(model, True, 96, 64)
out = {}
for n, e, w in ((128, 1024, 6), (256, 4096, 8), (1024, 32768, 1), (256, 10240, 16),
                (2560, 102400, 1)):
    inputs = cs.random_inputs(np.random.default_rng(1), w, n, e, 96, 64, True)
    with torch.no_grad():
        out[f"fused_mp ({n},{e}) x{w}"] = [
            cs.cuda_ms(lambda: fused_mp_scores_cuda(*inputs, flat, meta, 6), 10)
            for _ in range(3)]
    del inputs
rng = np.random.default_rng(1)
inputs = cs.random_inputs(rng, 8, 256, 4096, 96, 64, True)
with torch.no_grad():
    out["stash forward (256,4096) x8"] = [
        cs.cuda_ms(lambda: train_forward_cuda(*inputs, flat, meta, 6, False), 10)
        for _ in range(3)]
leaves = [t.detach().clone().requires_grad_() for t in inputs[:3]]
flat_t, _ = extract_mp_params(model, True, 96, 64, trainable=True)
ct = torch.from_numpy(rng.uniform(-1, 1, (8, 4096)).astype(np.float32)).cuda()
scores = fused_mp_train_scores(*leaves, *inputs[3:], flat_t, meta, 6, False)
targets = [*leaves, *flat_t]
out["backward (256,4096) x8"] = [
    cs.cuda_ms(lambda: torch.autograd.grad(scores, targets, ct, retain_graph=True), 10)
    for _ in range(3)]
del scores, leaves, inputs
def tail_batch(w):
    """A differentiated forward of w windows with the cells' valid-edge
    counts, and its targets and cotangent (zero on the padding)."""
    inputs = list(cs.random_inputs(rng, w, 256, 4096, 96, 64, True))
    valid = torch.tensor(rng.choice(tails, w)).cuda()
    for i in (3, 4):
        inputs[i] = torch.from_numpy(rng.integers(0, 256, (w, 4096)).astype(np.int32)).cuda()
    inputs[5] = torch.arange(4096, device="cuda")[None, :] < valid[:, None]
    ct = torch.from_numpy(rng.uniform(-1, 1, (w, 4096)).astype(np.float32)).cuda()
    leaves = [t.detach().clone().requires_grad_() for t in inputs[:3]]
    scores = fused_mp_train_scores(*leaves, *inputs[3:], flat_t, meta, 6, False)
    return scores, [*leaves, *flat_t], ct * inputs[5]
def backwards(batches):
    for scores, targets, ct in batches:
        torch.autograd.grad(scores, targets, ct, retain_graph=True)
for w, draws in ((8, 1), (2, 8)):
    batches = [tail_batch(w) for _ in range(draws)]
    name = f"backward (256,4096) x{w}, cells' tails" + (f", {draws} draws" if draws > 1 else "")
    out[name] = [cs.cuda_ms(lambda: backwards(batches), 10) for _ in range(3)]
    del batches
items = cs.build_scenes()
pairs = [(win, precompute_scene_encodings(model, scene)) for scene, wins in items
         for win in wins]
dense = materialize_encoded_dataset(pairs)
tr = GNNTrainer(make_model("mm"), GNNConfig(batch_size=2, lr=1e-4, weight_decay=1e-4,
                                            loss="cb"),
                init_state_dict=model.state_dict())
tr.fit_device(dense, epochs=1, verbose=False)
walls = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit_device(dense, epochs=1, verbose=False)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
out["fit_device epoch (wall ms)"] = walls
print(json.dumps(out))
'''


def cell_tails(here: Path) -> list:
    """Valid edges of every training window of the benchmark's
    ``train_device`` traffic at the clr configuration's scenes, window
    length and kNN (the layout's counts: no run seed changes them)."""
    sys.path.insert(0, str(here / "b3dbench"))
    from harness.scenes import make_scenes
    from reference import graphs

    mix = json.loads((here / "b3dbench/traffic/train_device.json").read_text())
    cfg = json.loads((here / "b3dbench/configs/clr_att_gnn.json").read_text())
    scenes = make_scenes(mix, range(cfg["train_scenes"]), 0, None)
    return [len(w["src"]) for sc in scenes
            for _, w in graphs.scene_windows(sc, cfg["window_len_train"], cfg["top_knn_nodes"])]


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other, here = Path(argv[0]).resolve(), Path(__file__).resolve().parent.parent
    tails = json.dumps(cell_tails(here))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    turns = []
    for tag, cwd in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, "-c", CODE, tails], cwd=cwd,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        turns.append((tag, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(tag, json.dumps(turns[-1][1]), flush=True)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
