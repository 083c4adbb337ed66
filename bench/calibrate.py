"""Readings that set a cell's limits, on the card, in one process:

  python3 bench/calibrate.py --workload <name> --seeds <n> [--first-seed <s>]
      [--seconds <s>] [--controls <k>]

runs the cell's timed path on `n` seeds, each with a short window of
`--seconds` that still finishes the mix's longest requests, and prints one
JSON line a seed with every number the check compares (the lower readings).
On the first `k` seeds it also reads the control, the plain reference in fp8
in the program's place, and for a training cell a planted fault, half of each
batch left out (the upper readings). The benchmark's own runs never do this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchkit.harness import run_cell  # noqa: E402
from benchkit.spec import Spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args()
    spec = Spec()
    for i in range(args.seeds):
        seed = args.first_seed + i
        t = time.perf_counter()
        out = run_cell(spec, args.workload, seed=seed, seconds=args.seconds, trace=False,
                       device="cuda", t0=t, controls=i < args.controls)
        print(json.dumps({"seed": seed, "correct": out["correct"], "attempted": out["attempted"],
                          "checks": {k: c["value"] for k, c in out["checks"].items()},
                          "controls": out.get("controls", {}),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
