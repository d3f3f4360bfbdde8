"""Which ReLU masks does the training backward kernel take? On one NVIDIA
GPU, for three of ``chip_smoke.py`` phase 2b's shapes, the kernel pair's
gradients against the plain version's (autograd) under three mask
sources: (A) the plain loop's own carries, (B) a float32 recompute from
the forward kernel's stashes (x_t, e_t, agg_t), (C) a float64 recompute
from the same stashes; prints per case the units where the sources
differ and the gradient elements outside the tolerance of 2b
(rtol 5e-3, atol 2e-4 x max|plain|), against the kernel and against the
plain version's own gradients.

    python3 scripts/probe_relu_replay.py
"""

import functools
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from batch3dmot_tpu_torch.models import init_params_, make_model  # noqa: E402
from batch3dmot_tpu_torch.ops import cuda_build  # noqa: E402
from batch3dmot_tpu_torch.ops.fused_mp import (  # noqa: E402
    extract_mp_params,
    fused_mp_scores_plain,
    relu_masks_from_stashes,
)
from batch3dmot_tpu_torch.ops.fused_mp_train import (  # noqa: E402
    fused_mp_train_scores,
    train_forward_cuda,
)


def outside(got, ref):
    """(elements outside the tolerance, per tensor)."""
    where = {}
    for k, r in ref.items():
        d = (got[k] - r).abs()
        o = int((d > cs.GRAD_ATOL * float(r.abs().max()) + cs.GRAD_RTOL * r.abs()).sum())
        if o:
            where[k] = o
    return sum(where.values()), where


def main():
    cuda_build.build(["fused_mp", "fused_mp_train"])
    gen = torch.Generator().manual_seed(0)
    models = {name: init_params_(make_model(name), gen).cuda().eval()
              for name in ("mm", "cl_gnn_trad", "pose")}
    rng = np.random.default_rng(0)
    d64 = lambda t: None if t is None else t.double()  # noqa: E731
    for name, (n, e), windows in [("mm", (64, 512), 8), ("pose", (128, 1024), 8),
                                  ("mm", (256, 4096), 8)]:
        model = models[name]
        pose = name == "pose"
        inputs = cs.random_inputs(rng, windows, n, e, model.node_dim, model.edge_dim, not pose)
        ct = torch.from_numpy(rng.uniform(-1.0, 1.0, (windows, e)).astype(np.float32)).cuda()
        flat, meta = extract_mp_params(model, not pose, model.node_dim, model.edge_dim)
        with torch.no_grad():
            stash = train_forward_cuda(*inputs, flat, meta, 6, pose)[1:4]
            own = fused_mp_scores_plain(*inputs, flat, meta, 6, pose, carries=True)[1:]
        _, g_k = cs.train_grads(model, inputs, ct, 6, pose, fused_mp_train_scores)
        _, g_p = cs.train_grads(model, inputs, ct, 6, pose, fused_mp_scores_plain)
        sources = {
            "A": relu_masks_from_stashes(own, inputs[2], *inputs[3:], flat, meta, 6),
            "B": relu_masks_from_stashes(stash, inputs[2], *inputs[3:], flat, meta, 6),
            "C": relu_masks_from_stashes([t.double() for t in stash], d64(inputs[2]),
                                         *inputs[3:], [w.double() for w in flat], meta, 6),
        }
        diff = {pair: sum(int((a != b).sum()) for a, b in zip(sources[pair[0]],
                                                               sources[pair[1]]))
                for pair in ("AB", "BC")}
        result = {}
        for tag, masks in sources.items():
            _, g = cs.train_grads(model, inputs, ct, 6, pose,
                                  functools.partial(fused_mp_scores_plain, relu_masks=masks))
            result[tag] = dict(vs_kernel=outside(g_k, g), vs_own_plain=outside(g_p, g)[0])
        print(f"{name} ({n}, {e}) x{windows}: own masks vs kernel {outside(g_k, g_p)}; "
              f"units differing A-B {diff['AB']}, B-C {diff['BC']}; replayed {result}",
              flush=True)


if __name__ == "__main__":
    main()
