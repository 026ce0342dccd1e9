"""Run one cell of the benchmark on the card and print one JSON line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``hyperpocket_tpu_torch``. The
kernels' build and every cache stay inside the checkout.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
# caches of the libraries the program may use, at fixed paths in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[0] = str(ROOT)  # the checkout, not this folder, whose names could shadow others

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main(t0=T0))
