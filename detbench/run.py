"""The benchmark of basedet_tpu_torch: one cell, one run.

    python3 detbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell that ``BENCHMARK.json`` names, builds its inputs and weights
from the seed, warms up, measures for ``--seconds``, checks what the timed
path produced against the plain reference in ``detbench/reference/``, and
prints one JSON line: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a padded profiler stretch after the
window, and the ``breakdown``. The check's numbers, each beside its limit,
close standard error and the result line. Needs as many CUDA devices as the
cell asks for; exits non-zero without them, or if JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "basedet_tpu")  # compared by whole top-level names


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def run(workload: str, seed: int, seconds: float, trace_on: bool, device: str = "cuda", manifest_path=None,
        bench_dir: Path = BENCH, t_start: float = T_START):
    """One run of the cell: (result line as a dict, check numbers)."""
    import torch

    from core import check, manifest

    cell = manifest.load_cell(workload, manifest_path, bench_dir)
    kind = manifest.kind_module(cell.kind, bench_dir)
    r = kind.Run(cell, seed, device)
    r.setup()
    setup_s = time.perf_counter() - t_start
    e2e = r.window(seconds)
    cuda = torch.device(device).type == "cuda"
    result = {"correct": False, "attempted": r.attempted,
              "failed": 0, "metrics": {}, "device": {}}
    tr = r.traced() if trace_on else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0  # before any reader touches the device
    if trace_on:
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"], bench_dir).read(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
        busy, window = tr.busy_s(), tr.stretch_s
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                        "count": cell.chips,
                        "memory_peak_bytes": peak}
    if trace_on:
        result["device"].update(busy_s=busy, window_s=window)
    r.release()
    correct, numbers = check.judge(r.readings(), cell.limits)
    result["correct"] = correct
    # a reading that is not a number (a leaf the program lacks) fails and prints as null
    result["check"] = {n["name"]: {"value": n["value"] if math.isfinite(n["value"]) else None, "limit": n["limit"]}
                       for n in numbers}
    return result, numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from core import manifest

    try:
        cell = manifest.load_cell(args.workload)
    except (manifest.ManifestError, OSError, KeyError) as e:
        print(f"detbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"detbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    card = power_limit()
    result, numbers = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"detbench: the run loaded {', '.join(found)}; the port must not", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(f"detbench: {args.workload} seed {args.seed} on {card}", file=sys.stderr)
    for n in numbers:
        print(f"check {n['name']} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
