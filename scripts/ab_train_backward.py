"""The fused training backward (B5/B7) at (256, 4096) x8 on random inputs,
two checkouts of the repository in turns on one NVIDIA GPU: the other
checkout, this one, this one, the other; each turn a process of its own
that builds its checkout's kernels and times three runs of 10 backward
calls with CUDA events (``chip_smoke.cuda_ms``).

    python scripts/ab_train_backward.py OTHER_CHECKOUT

Prints each turn's times and, last, one JSON line with the card's name
and power limit. Compare two versions of the backward only within one
such run."""

import json
import subprocess
import sys
from pathlib import Path

CODE = r'''
import sys, json, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.ops import cuda_build
from batch3dmot_tpu_torch.ops.fused_mp import extract_mp_params
from batch3dmot_tpu_torch.ops.fused_mp_train import fused_mp_train_scores
cuda_build.build(["fused_mp", "fused_mp_train"])
model = init_params_(make_model("mm"), torch.Generator().manual_seed(0)).cuda()
rng = np.random.default_rng(1)
inputs = cs.random_inputs(rng, 8, 256, 4096, 96, 64, True)
leaves = [t.detach().clone().requires_grad_() for t in inputs[:3]]
flat, meta = extract_mp_params(model, True, 96, 64, trainable=True)
ct = torch.from_numpy(rng.uniform(-1, 1, (8, 4096)).astype(np.float32)).cuda()
out = fused_mp_train_scores(*leaves, *inputs[3:], flat, meta, 6, False)
targets = [*leaves, *flat]
ms = [cs.cuda_ms(lambda: torch.autograd.grad(out, targets, ct, retain_graph=True), 10)
      for _ in range(3)]
print(json.dumps(ms))
'''


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other, here = Path(argv[0]).resolve(), Path(__file__).resolve().parent.parent
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    turns = []
    for tag, cwd in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, "-c", CODE], cwd=cwd, capture_output=True,
                              text=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        turns.append((tag, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(tag, turns[-1][1], flush=True)
    print(json.dumps({"card": card, "backward_ms_turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
