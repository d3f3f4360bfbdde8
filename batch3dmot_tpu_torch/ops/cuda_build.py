"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/torch_kernels/lib<name>_<hash>.so`` at
the root of the checkout, keyed by a hash of the source and the flags, then
loaded with ``ctypes``. The first call in a fresh checkout compiles; later
calls reuse the library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
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
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Sequence[str]) -> Dict[str, dict]:
    """Compile every missing library among ``names``, one ``nvcc`` each, all
    started together. Returns per name: path, seconds and the compiler's
    resource report (registers, shared memory, spills)."""
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
            path=str(out), seconds=time.perf_counter() - t0, log=log
        )
    return report


_ARGTYPES = {
    # fused_mp_forward(dims, woff, wblob, x0, e_state, att, src, dst, doff,
    #                  dperm, soff, sperm, npb, pbuf, fbuf, out, stream)
    "fused_mp": ("fused_mp_forward", [ctypes.c_void_p] * 17),
}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed. Every pointer and
    the stream are ``c_void_p`` (a bare int would be cut to 32 bits); each
    entry returns the CUDA error code."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    fn_name, argtypes = _ARGTYPES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib
