"""How many of a short burst's launches a torch.profiler pass reports, with and
without idle time padded into its window, on an NVIDIA GPU:

    python scripts/profiler_window_probe.py [--seconds 400] [--launches 20]

Each round runs four CUDA-activity profiler passes over ``--launches`` small
kernels: unpadded, unpadded after the profiler's own warm-up cycle, and with
10 ms and 200 ms of idle inside the window before and after the burst. Rounds
are 3 s of large matmuls apart, for ``--seconds``. Prints each round, then per
kind of pass the passes that saw none of the launches, those that saw all of
them, and the mean seen.

The profiler keeps a device record only if its timestamp, converted to the
host's clock, lies inside the window; where the conversion is off by more than
the burst lasts, an unpadded pass loses the burst whole. ``chip_smoke.py``'s
``padded_profile`` pads every window it opens for this reason.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule


def seen(prof) -> int:
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0)


def unpadded(fn, launches: int) -> int:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    return seen(prof)


def warm_cycle(fn, launches: int) -> int:
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return seen(prof)


def padded(fn, launches: int, pad: float) -> int:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    return seen(prof)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=400.0)
    parser.add_argument("--launches", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_window_probe: needs a CUDA device")
    x = torch.randn(4096, 4096, device="cuda")
    small = torch.randn(1000, device="cuda")
    fn = lambda: small.add_(1)
    kinds = {"unpadded": lambda: unpadded(fn, args.launches),
             "warm-up cycle": lambda: warm_cycle(fn, args.launches),
             "padded 10 ms": lambda: padded(fn, args.launches, 0.01),
             "padded 200 ms": lambda: padded(fn, args.launches, 0.2)}
    tally = {k: [] for k in kinds}
    start = time.monotonic()
    while time.monotonic() - start < args.seconds:
        row = {k: run() for k, run in kinds.items()}
        for k, n in row.items():
            tally[k].append(n)
        print(f"t={time.monotonic() - start:6.1f}s " + ", ".join(f"{k} {n}" for k, n in row.items()), flush=True)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 3:
            for _ in range(20):
                x @ x
            torch.cuda.synchronize()
    print(torch.cuda.get_device_name(0))
    for k, counts in tally.items():
        print(f"{k}: {len(counts)} passes of {args.launches} launches, none seen in "
              f"{sum(n == 0 for n in counts)}, all seen in {sum(n == args.launches for n in counts)}, "
              f"mean seen {sum(counts) / len(counts):.2f}")


if __name__ == "__main__":
    main()
