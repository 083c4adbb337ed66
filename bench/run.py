"""Run one cell of the benchmark once:

  python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See `benchkit/harness.py`."""

import time

T0 = time.perf_counter()  # the process's start, as near as Python gets to it

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# caches of the program's builds stay in the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
os.environ["USE_FLAX"] = "0"  # a library that could load JAX by itself must not
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from benchkit.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
