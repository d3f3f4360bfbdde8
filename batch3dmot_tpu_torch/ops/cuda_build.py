"""Build the package's CUDA sources into shared libraries and load them,
and count what their kernels ran (:func:`traced_launches`).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/torch_kernels/lib<name>_<hash>.so`` at
the root of the checkout, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, then loaded with ``ctypes``. The first call
in a fresh checkout compiles; later calls reuse the library. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
import warnings
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Sequence[str]) -> Dict[str, dict]:
    """Compile every missing library among ``names``, one ``nvcc`` each, all
    started together. Returns per name: path, seconds, whether this call
    compiled it (``compiled``; False for a library already built) and the
    compiler's resource report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            jobs[name] = (out, None, None, time.perf_counter())
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (out, tmp, proc, time.perf_counter())
    report = {}
    for name, (out, tmp, proc, t0) in jobs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            os.replace(tmp, out)
        report[name] = dict(
            path=str(out), seconds=time.perf_counter() - t0,
            compiled=proc is not None, log=log
        )
    return report


# C entries per library: name -> (number of c_void_p arguments, return type)
_ARGTYPES = {
    "fused_mp": {
        # fused_mp_forward(dims, woff, wblob, tblob, x0, e_state, att, src,
        #                  dst, doff, dperm, soff, sperm, npb, pbuf, fbuf,
        #                  out, stream)
        "fused_mp_forward": (18, ctypes.c_int),
        # fused_mp_forward_stash(dims, woff, wblob, tblob, att, src, dst,
        #                        doff, dperm, soff, sperm, npb, pbuf, fbuf, xs,
        #                        es, agg, out, stream)
        "fused_mp_forward_stash": (19, ctypes.c_int),
    },
    "fused_mp_train": {
        # fused_mp_train_workspace(dims) -> floats
        "fused_mp_train_workspace": (1, ctypes.c_longlong),
        # fused_mp_train_mask_bytes(dims) -> bytes of the ReLU masks
        "fused_mp_train_mask_bytes": (1, ctypes.c_longlong),
        # fused_mp_backward(dims, woff, wblob, toff, tblob, ds, xs, es, agg,
        #                   att, src, dst, doff, dperm, soff, sperm, work,
        #                   dx0, de0, datt, dblob, masks, stream)
        "fused_mp_backward": (23, ctypes.c_int),
        # fused_mp_train_live(be, src, dst, ds, live, stream)
        "fused_mp_train_live": (6, ctypes.c_int),
        # fused_mp_train_tiles(out, stream): waits; fused_mp_train_tiles_clear(stream)
        "fused_mp_train_tiles": (2, ctypes.c_int),
        "fused_mp_train_tiles_clear": (1, ctypes.c_int),
    },
    "segment_sum": {
        # segment_sum_forward(dims, data, ids, mask, out, stream)
        "segment_sum_forward": (6, ctypes.c_int),
    },
    "tc_probe": {
        # tc_probe_mma / tc_probe_wgmma(dims, A, B, C, D, stream)
        "tc_probe_mma": (6, ctypes.c_int),
        "tc_probe_wgmma": (6, ctypes.c_int),
        # tc_probe_gemm / tc_probe_wg(dims, A, W or its stream, out, stream)
        "tc_probe_gemm": (5, ctypes.c_int),
        "tc_probe_wg": (5, ctypes.c_int),
    },
}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed. Every pointer and
    the stream are ``c_void_p`` (a bare int would be cut to 32 bits); each
    launching entry returns the CUDA error code."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, (n_args, restype) in _ARGTYPES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = [ctypes.c_void_p] * n_args
        fn.restype = restype
    return lib


def kernel_names() -> set:
    """The names of the ``__global__`` kernels in the package's sources."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    return {n for p in CSRC.glob("*.cu*") for n in pattern.findall(p.read_text())}


# The profiler now and then drops the records of a trace's first
# milliseconds (seen on an H100): ``traced_launches`` starts the run this
# long into the trace, between two marker kernels it requires.
TRACE_LEAD_S = 0.05
MARK_CYCLES = 200_000


def traced_launches(run) -> Dict[str, int]:
    """Launches of each of the package's kernels during ``run()`` on the
    GPU, as torch.profiler traces them: CUDA-graph replays included, which
    the Python wrappers' launch counters cannot see. A first profiled step,
    discarded, warms the tracer. ``run()`` starts ``TRACE_LEAD_S`` into the
    traced step, after a marker kernel, and a second marker follows it; a
    trace without both markers has lost records and raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    names = kernel_names()
    events = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # events of one cycle only: wanted
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: events.extend(p.key_averages())) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(TRACE_LEAD_S)
            torch.cuda._sleep(MARK_CYCLES)
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            prof.step()
    out: Dict[str, int] = {}
    marks = 0
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        if re.search(r"(?<!\w)spin_kernel(?!\w)", ev.key):
            marks += ev.count
        for n in names:
            if re.search(rf"(?<!\w){n}[(<]", ev.key):
                out[n] = out.get(n, 0) + ev.count
    if marks != 2:
        raise RuntimeError(f"the profiler lost records of the traced run: {marks} of its "
                           "2 marker kernels traced")
    return out
