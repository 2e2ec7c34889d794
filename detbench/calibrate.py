"""Readings of the check for setting a cell's limits, many seeds in one
process: the program's sound runs, and the lower-precision control (with,
for a training cell, the half-batch fault) in the program's place.

    python3 detbench/calibrate.py --workload <cell> --seconds <s> --seeds <n>... \\
        [--control fp8|tf32_rounded] [--control-seeds <n>...] [--faults half]

Prints one JSON line per seed and reading. Not run by the benchmark's own
runs; it is how ``limits/<cell>.json`` was set (see PERF.md).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control", default=None)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--faults", nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--manifest", type=Path, default=None, help="BENCHMARK.json to read (the repository's)")
    args = parser.parse_args(argv)

    from core import manifest, port

    cell = manifest.load_cell(args.workload, args.manifest)
    kind = manifest.kind_module(cell.kind)
    jobs = [(s, None) for s in args.seeds] + [(s, c) for s in args.control_seeds
                                            for c in ([args.control] if args.control else []) + args.faults]
    for seed, control in jobs:
        t0 = time.perf_counter()
        r = kind.Run(cell, seed, args.device)
        if control is None or cell.kind != "train":
            r.setup()
            r.window(args.seconds)
            r.release()
        else:
            r.prepare()
        t1 = time.perf_counter()
        readings = r.readings(control)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": control or "program",
                          "readings": readings, "run_s": t1 - t0, "check_s": time.perf_counter() - t1}),
              flush=True)
        del r
        port.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
