"""How the card's tensor cores round the float32 sums they accumulate, and
one product through each of the port's two product routines against
float64 (``batch3dmot_tpu_torch/csrc/tc_probe.cu``).

    python scripts/probe_tc_rounding.py

Needs one NVIDIA GPU (``chip_smoke.py`` runs the same functions). Two
parts:

1. Rounding. One ``mma.sync.m16n8k8`` and one ``wgmma.m64n16k8`` (TF32 in,
   float32 accumulate) on crafted inputs: D = A B + C with B of +-1 entries,
   so each output is C plus eight TF32 values, every product exact. Each
   output is compared bit for bit with a family of models of the adder
   (:func:`emulate`): the eight products summed in groups of G (4 or 8),
   each group with the running value as C; every addend of a group aligned
   to the largest exponent among them and kept to 24 + F bits (the bits
   below cut toward zero, or toward minus infinity), the aligned addends
   summed exactly and the sum normalized to float32 toward zero or to
   nearest. Printed: the models that give every output, and how the card
   rounds one addend a fraction of a unit below C (``one_addend``).
2. One product. ``A [R, K] @ W [K, N]`` on activations of the size six
   layers of flax's draw reach (ReLU of unit normals times 1e3) and
   lecun-normal weights, through ``tc_gemm`` (``mma.sync``, the training
   backward's) and ``wg_gemm`` (``wgmma``, the edge kernel's), beside the
   float32 matmul and the float32 matmul with TF32 allowed (the control):
   each one's max |x - f64|, its RMS, its mean error in the direction of
   the float64 value over that RMS (a sum truncated toward zero leans
   negative), and the same readings for sums of 40 of its rows (a node's
   messages: errors of one sign add up there).

Prints the card's name and power limit, the readings and, last, one JSON
line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SCALE = 200  # exact values as integers times 2^-SCALE (every case stays above 2^-150)
EXTRA_BITS = (0, 1, 2, 3, 4, 5, 6, 8, 10, None)  # None: no alignment loss
MODELS = [(f, g, final, cut) for f in EXTRA_BITS for g in (8, 4)
          for final in ("zero", "nearest") for cut in ("zero", "floor")]
AGG_ROWS = 40  # rows summed per node in part 2 (kNN 40)
KERNEL_ROUTES = ("tc_gemm (mma.sync)", "wg_gemm (wgmma)")
FLOAT32, CONTROL = "float32 matmul", "float32 matmul, TF32 allowed (control)"


def exact(x) -> int:
    """A float's exact value times 2^SCALE as an integer."""
    num, den = float(x).as_integer_ratio()
    return num * (1 << SCALE) // den


def _cut(v: int, q: int, cut: str) -> int:
    """v with the bits below weight 2^q removed: toward zero or minus infinity."""
    if q <= 0:
        return v
    if cut == "floor" or v >= 0:
        return (v >> q) << q
    return -((-v >> q) << q)


def to_f32(v: int, final: str) -> int:
    """v (exact) as a float32 with 24 significant bits: toward zero or to
    nearest, ties to even."""
    mag = abs(v)
    drop = mag.bit_length() - 24
    if drop <= 0:
        return v
    kept, rest = mag >> drop, mag & ((1 << drop) - 1)
    if final == "nearest":
        half = 1 << (drop - 1)
        if rest > half or (rest == half and kept & 1):
            kept += 1
    mag = kept << drop
    return mag if v >= 0 else -mag


def emulate(c: int, prods, extra, group: int, final: str, cut: str) -> int:
    """One model's D = C + sum(prods) (see the module's docstring)."""
    acc = c
    for i in range(0, len(prods), group):
        addends = [acc, *prods[i:i + group]]
        nz = [abs(a) for a in addends if a]
        if not nz:
            acc = 0
            continue
        if extra is not None:
            q = max(a.bit_length() for a in nz) - 1 - 23 - extra
            addends = [_cut(a, q, cut) for a in addends]
        acc = to_f32(sum(addends), final)
    return acc


def crafted(rng, rows: int):
    """``rows`` sets of eight TF32 addends (some signs to come from B) and,
    per row, the C values; families: one addend a fraction of a unit below
    C (the rounding of a single sum), exact half units (ties), mixed signs
    and magnitudes, cancellation of C, and sums whose first four addends
    cancel (groups of four)."""
    def tf32(x):
        x = np.asarray(x, np.float32)
        return ((x.view(np.int32) + 0x1000) & -0x2000).view(np.float32)

    a = np.zeros((rows, 8), np.float32)
    c = np.zeros((rows, 16), np.float32)
    for r in range(rows):
        fam = r % 5
        sign_c = rng.choice([-1.0, 1.0], 16)
        base = np.float32(1.0) + rng.integers(0, 1 << 23, 16).astype(np.float32) * 2.0 ** -23
        if fam == 0:  # one addend below C's unit
            a[r, 0] = tf32(rng.choice([-1, 1]) * (1 + rng.integers(0, 1024) / 1024)
                           * 2.0 ** -int(rng.integers(20, 30)))
            c[r] = sign_c * base * 2.0 ** int(rng.integers(-3, 4))
        elif fam == 1:  # half a unit of C, either sign
            a[r, 0] = rng.choice([-1, 1]) * 2.0 ** -24
            c[r] = sign_c * base
        elif fam == 2:  # mixed signs and magnitudes
            a[r] = tf32(rng.choice([-1, 1], 8) * rng.uniform(1, 2, 8)
                        * 2.0 ** rng.integers(-12, 1, 8))
            c[r] = sign_c * base * 2.0 ** rng.integers(-6, 3, 16)
        elif fam == 3:  # C cancels most of the sum
            a[r] = tf32(rng.uniform(1, 2, 8) * 2.0 ** rng.integers(-8, 0, 8))
            c[r] = -np.float32(a[r].astype(np.float64).sum()) * (
                1 + rng.integers(-64, 64, 16) * 2.0 ** -20)
        else:  # the first four cancel, the last four are small
            big = tf32(rng.uniform(1, 2, 2))
            a[r, :4] = [big[0], -big[0], big[1], -big[1]]
            a[r, 4:] = tf32(rng.choice([-1, 1], 4) * rng.uniform(1, 2, 4)
                            * 2.0 ** rng.integers(-40, -24, 4))
            c[r] = sign_c * 2.0 ** rng.integers(-40, -20, 16) * base
    return a, c.astype(np.float32)


def fit_models(a, b, c, d):
    """The models that give every output D = A B + C (A [P, M, 8], B [P, 8,
    N], C and D [P, M, N]), and how the card rounds the one-addend family
    (``crafted`` rows 0, 5, ...): counts of outputs equal to the sum's
    nearest float32, its float32 toward zero, both or neither."""
    alive = list(MODELS)
    one = dict(nearest=0, toward_zero=0, both=0, other=0)
    for p in range(a.shape[0]):
        for i in range(a.shape[1]):
            for j in range(b.shape[2]):
                prods = [exact(np.float64(a[p, i, k]) * np.float64(b[p, k, j])) for k in range(8)]
                cv, got = exact(c[p, i, j]), exact(d[p, i, j])
                if (p * a.shape[1] + i) % 5 == 0:
                    s = cv + sum(prods)
                    rn, rz = to_f32(s, "nearest"), to_f32(s, "zero")
                    key = ("both" if rn == rz else "nearest") if got == rn else (
                        "toward_zero" if got == rz else "other")
                    one[key] += 1
                alive = [m for m in alive if emulate(cv, prods, *m) == got]
    return alive, one


def describe(models):
    return [dict(extra_bits="none lost" if f is None else f, group=g, normalize=final,
                 align_cut=cut) for f, g, final, cut in models]


def rounding_probe(seed=0, mma_problems=16, wgmma_problems=2):
    """Part 1 on the card: each instruction's consistent models and its
    one-addend counts."""
    import torch

    from batch3dmot_tpu_torch.ops import cuda_build
    from batch3dmot_tpu_torch.ops.fused_mp import host_ptr

    lib = cuda_build.load("tc_probe")
    rng = np.random.default_rng(seed)
    out = {}
    for name, (m, n, problems) in (("mma.sync.m16n8k8", (16, 8, mma_problems)),
                                   ("wgmma.m64n16k8", (64, 16, wgmma_problems))):
        rows, cs = crafted(rng, problems * m)
        a = rows.reshape(problems, m, 8)
        c = np.ascontiguousarray(cs[:, :n]).reshape(problems, m, n)
        b = np.where(rng.random((problems, 8, n)) < 0.25, -1.0, 1.0).astype(np.float32)
        b[:, :, 0] = 1.0
        dev = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (a, b, c)]
        d = torch.empty_like(dev[2])
        fn = lib.tc_probe_mma if m == 16 else lib.tc_probe_wgmma
        dims = np.array([problems], np.int32)
        err = fn(host_ptr(dims), *(ctypes.c_void_p(t.data_ptr()) for t in (*dev, d)),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"{name} probe: CUDA error {err}")
        torch.cuda.synchronize()
        alive, one = fit_models(a, b, c, d.cpu().numpy())
        out[name] = dict(outputs=int(d.numel()), models=describe(alive), one_addend=one)
    return out


def stream_of(w: np.ndarray) -> np.ndarray:
    """W [K, N] as tc_stream.cuh's weight stream of one product at the edge
    kernel's slice depth: per slice (ops/fused_mp.py::stream_slices) the
    TF32 big parts, then the small ones (split as
    ops/fused_mp.py::split_tf32)."""
    import torch

    from batch3dmot_tpu_torch.ops.fused_mp import _EDGE_KC, _tf32_rna, stream_slices

    pad = np.concatenate([w.ravel(), np.zeros(1, np.float32)])
    parts = []
    for row, col in stream_slices(*w.shape, _EDGE_KC):
        x = torch.from_numpy(pad[np.where(row >= 0, row * w.shape[1] + col, w.size)])
        big = _tf32_rna(x)
        parts += [big, _tf32_rna(x - big)]
    return torch.cat(parts).numpy()


def error_readings(x, ref64):
    """max |x - f64|, RMS, and the mean error along sign(f64) over the RMS."""
    import torch

    e = x.double() - ref64
    rms = float(e.pow(2).mean().sqrt())
    lean = float((e * torch.sign(ref64)).mean()) / max(rms, 1e-300)
    return dict(max=float(e.abs().max()), rms=rms, lean=lean)


def product_probe(seed=0, rows=16000, k=256, n=128, scale=1e3):
    """Part 2 on the card: per route, the product's and its 40-row sums'
    readings against float64, and their max error over float32's."""
    import torch

    from batch3dmot_tpu_torch.ops import cuda_build
    from batch3dmot_tpu_torch.ops.fused_mp import host_ptr

    lib = cuda_build.load("tc_probe")
    rng = np.random.default_rng(seed)
    a = (np.maximum(rng.standard_normal((rows, k)), 0) * scale).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    a_d, w_d = torch.from_numpy(a).cuda(), torch.from_numpy(w).cuda()
    s_d = torch.from_numpy(stream_of(w)).cuda()
    dims = np.array([rows, k, n], np.int32)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    got = {}
    for name, fn, wt in zip(KERNEL_ROUTES, (lib.tc_probe_gemm, lib.tc_probe_wg), (w_d, s_d)):
        out = torch.empty(rows, n, device="cuda")
        err = fn(host_ptr(dims), ctypes.c_void_p(a_d.data_ptr()), ctypes.c_void_p(wt.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), stream)
        if err:
            raise RuntimeError(f"{name} probe: CUDA error {err}")
        got[name] = out
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        got[FLOAT32] = a_d @ w_d
        torch.backends.cuda.matmul.allow_tf32 = True
        got[CONTROL] = a_d @ w_d
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    ref = a_d.double() @ w_d.double()
    agg = lambda t: t.double().view(-1, AGG_ROWS, n).sum(1)  # noqa: E731
    ref_agg = agg(ref)
    out = {}
    for name, x in got.items():
        out[name] = dict(product=error_readings(x, ref), sums=error_readings(agg(x), ref_agg))
    f32 = out[FLOAT32]
    for r in out.values():
        r["ratio"] = r["product"]["max"] / f32["product"]["max"]
        r["sums_ratio"] = r["sums"]["max"] / f32["sums"]["max"]
    return dict(shape=[rows, k, n], activations=f"relu(N(0,1)) x {scale:g}",
                rows_summed=AGG_ROWS, routes=out)


def rounds(models) -> str:
    """How the fitted models round a sum: "to nearest", "toward zero" (the
    alignment and the normalization both cut), "mixed" or "unknown"."""
    kinds = {"to nearest" if m["normalize"] == "nearest" and m["extra_bits"] == "none lost"
             else "toward zero" if m["normalize"] == "zero" and m["align_cut"] == "zero"
             else "mixed" for m in models}
    return kinds.pop() if len(kinds) == 1 else "unknown"


def summary(rounding):
    """One line per instruction: how its sums round."""
    lines = []
    for name, r in rounding.items():
        models = r["models"]
        fit = "; ".join(f"G={m['group']}, F={m['extra_bits']}, normalize {m['normalize']}, "
                        f"align cut {m['align_cut']}" for m in models[:4]) or "no model fits"
        lines.append(f"{name}: sums round {rounds(models)}; {len(models)} of {len(MODELS)} "
                     f"models give every one of {r['outputs']} outputs: {fit}; one addend "
                     f"below C's unit gives C + x's nearest float32 / its float32 toward "
                     f"zero / both / neither: {r['one_addend']}")
    return lines


def main() -> int:
    import torch

    from batch3dmot_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("probe_tc_rounding: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cuda_build.build(["tc_probe"])
    rounding = rounding_probe()
    for line in summary(rounding):
        print(line, flush=True)
    products = product_probe()
    for name, r in products["routes"].items():
        print(f"{name}: max|x-f64| {r['product']['max']:.3e} ({r['ratio']:.2f}x float32's), "
              f"lean {r['product']['lean']:+.3f}; {AGG_ROWS}-row sums "
              f"{r['sums']['max']:.3e} ({r['sums_ratio']:.2f}x), lean {r['sums']['lean']:+.3f}",
              flush=True)
    print(json.dumps(dict(card=card, rounding=rounding, products=products)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
