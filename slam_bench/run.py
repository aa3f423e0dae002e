"""Run one cell of the benchmark and print its result line.

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA cards the cell asks for: without them it exits with code 3
and prints no result. The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, then `card` and last `checks`); the last lines of
standard error give each number the check compared beside its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# one process with one host thread per math library: steadier host times
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

from slam_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), log=lambda m: print(m, file=sys.stderr))
    except harness.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
