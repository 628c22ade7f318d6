"""Run one cell of BENCHMARK.json once, on the card of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON; the numbers the check compared, each beside its limit, are
the last lines of standard error. Build and kernel caches live in fixed
directories under `build/` in the checkout."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv_compute_cache"}

if __name__ == "__main__":
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from harness.main import main

    sys.exit(main(sys.argv[1:], T_START))
