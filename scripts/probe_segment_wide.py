"""The segment-sum kernel (B8) at the width of the attention rows'
backward (``ops/segment.py::gather_rows``: D = 288, (256, 4096) x2
windows) on one NVIDIA GPU: one call on random ids, the same sum split
into k column blocks as k times as many windows (one launch each), and
``scatter_add_`` (atomics, for scale); CUDA events over 50 calls after a
warm-up; every split bit-equal to the one call.

    python3 scripts/probe_segment_wide.py
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from batch3dmot_tpu_torch.ops import cuda_build  # noqa: E402
from batch3dmot_tpu_torch.ops.segment_kernel import segment_plan, segment_sum  # noqa: E402


def timed(fn, reps=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    cuda_build.build(["segment_sum"])
    g = torch.Generator(device="cuda").manual_seed(0)
    b, e, n, d = 2, 4096, 256, 288
    grad = torch.randn(b, e, d, device="cuda", generator=g)
    idx = torch.randint(0, n, (b, e), device="cuda", generator=g, dtype=torch.int32)
    base = segment_sum(grad, idx, n)
    for k in (1, 2, 3, 4, 6, 9):
        dk = d // k

        def run(k=k, dk=dk):
            gk = grad.view(b, e, k, dk).permute(0, 2, 1, 3).contiguous()
            out = segment_sum(gk, idx[:, None, :].expand(b, k, e), n)
            return out.permute(0, 2, 1, 3).reshape(b, n, d)

        print(f"split {k} (D {dk}), plan {segment_plan(b * k, n, e, dk)}: "
              f"{timed(run):.4f} ms, bit-equal {torch.equal(run(), base)}", flush=True)
    library = lambda: torch.zeros(b, n, d, device="cuda").scatter_add_(  # noqa: E731
        1, idx.long()[..., None].expand(b, e, d), grad)
    print(f"scatter_add_: {timed(library):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
