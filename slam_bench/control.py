"""The readings the check's limits are set from: the program's numbers
over many seeds, and the control's, in one process.

    python3 slam_bench/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds N] [--fault NAME [--fault-seeds N]] [--out FILE]

The cell's system is built, seeded and given its prefix once, as a run
builds it (that state is the same for every seed). For each seed: the
seed's first take runs one episode from the snapshot with the window's
recording on (what a run compares), and `check.numbers` reads the program
against the references, then the control (the references one precision
lower in the program's place) against the same references. With
`--fault`, the first `--fault-seeds` seeds then run again with that fault
of `faults.py` planted in the program. Prints one JSON line per seed and, with `--out`, writes them all
there. Needs the cell's CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import torch  # noqa: E402

from slam_bench import check, faults, harness  # noqa: E402


def readings(cell: harness.Cell, setup: harness.Setup, seed: int, device,
             control: bool = True, fault: str = None) -> dict:
    """{"program": numbers, "control": numbers} of one seed."""
    frames = harness.takes_of(cell, setup, seed)[0]
    capture = check.Capture(base=setup.truth["base"])
    failed = [0]

    def count(n, dt, poses):
        failed[0] += sum(p is None for p in poses)

    rec = harness.install_capture(setup.s, capture)
    t = time.perf_counter()
    with faults.planted(fault) if fault else contextlib.nullcontext():
        harness.episode(setup.s, setup.snap, frames,
                        cell.traffic["frames_per_call"], count)
        harness.sync()
    episode_s = time.perf_counter() - t
    harness.remove_capture(setup.s, rec)
    out = {"seed": seed, "episode_s": episode_s, "fault": fault,
           "program": harness.judge(cell, capture, frames, failed[0], device,
                                    setup.truth)}
    if control:
        out["control"] = harness.judge(cell, capture, frames, failed[0], device,
                                       setup.truth, control=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first N seeds only")
    ap.add_argument("--fault", choices=faults.FAULTS,
                    help="then read the program with this fault planted")
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="... on the first N seeds")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no result: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload)
    dev = torch.device("cuda")
    setup = harness.build(cell, dev, log=lambda m: print(m, file=sys.stderr))
    rows = []
    for i, seed in enumerate(args.seeds):
        ctl = args.control_seeds is None or i < args.control_seeds
        rows.append(readings(cell, setup, seed, dev, control=ctl))
        print(json.dumps(rows[-1]), flush=True)
    for seed in (args.seeds[:args.fault_seeds] if args.fault else []):
        rows.append(readings(cell, setup, seed, dev, control=False, fault=args.fault))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": harness.card_line(),
                       "fault": args.fault, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
