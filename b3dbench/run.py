"""The benchmark of ``batch3dmot_tpu_torch``: one run of one cell.

    python3 b3dbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the CUDA cards the cell
asks for. See ``b3dbench/README.md``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# every cache of a run inside the checkout, at fixed paths; no thread pool
# wider than the run needs; no library may pull in JAX through Flax
for key, sub in (("TRITON_CACHE_DIR", "triton_cache"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[key] = os.path.join(CHECKOUT, "build", sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [HERE, CHECKOUT]

from harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
