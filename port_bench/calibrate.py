"""Readings that set the limits of ``correct``: the port's numbers and
the control's over several seeds, in one process.

    python3 -m port_bench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
the comparison), and then the control: the reference computed in float8
in the port's place on the same frames, held to the float32 reference by
the same layer numbers. One JSON line per seed on standard output. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from .run import Bench, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", default="",
                    help="plant faults in the timed path: alter,half")
    args = ap.parse_args(argv)
    bench = Bench.load()
    for seed in args.seeds:
        res = run_cell(bench, args.workload, seed, args.seconds,
                       False, control=True,
                       faults=tuple(f for f in args.faults.split(",") if f))
        print(json.dumps({"seed": seed, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
