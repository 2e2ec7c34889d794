"""Kernel #9 (the DCN row scatter) against a tree from before its segmentation
kernels, timed in turns at CenterNet's three DCN stages at batch 16 of
512x512, f32 and bf16, as the train step calls it (f32 values to an f32 table,
bf16 to a bf16 one), on row ids made as the DCN makes them (9 taps a position,
offsets drawn from N(0, 1), anchors clamped into the padded table):

    PYTHONPATH=. python scripts/scatter_bench.py --sorted-source FILE

``FILE`` is a ``scatter_rows.cu`` of the interface that took ``row_segments``'
int64 order and starts and stored f32 (``git show <commit>:basedet_tpu_torch/
csrc/scatter_rows.cu`` of such a tree). Its call is ``row_segments``, that
kernel and, for a bf16 table, the cast; this tree's is ``scatter_rows``. For
each stage and dtype the script prints both calls' times by CUDA events in
turns (sorted, this, this, sorted) and their device operations by
torch.profiler, and per train step (three calls) the sums beside the bound.
Both outputs are held to the plain version's bits. Needs one NVIDIA GPU; the
builds go into ``basedet_tpu_torch/_build``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from basedet_tpu_torch.ops import scatter_rows_kernel as K
from basedet_tpu_torch.ops._build import build_library
from basedet_tpu_torch.ops.scatter_rows import row_segments, scatter_rows_plain

STAGES = [(16, 16, 8192), (16, 32, 1024), (16, 64, 512)]  # (B, H, D): res5, then each deconvolution stage
VOID, INT, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def dcn_idx(B, H, gen):
    """(B, 9*H*H) int32 row ids into the (H+1)^2 padded table, as ``bilinear_sample_batched`` makes them."""
    k = torch.arange(3, device="cuda").float() - 1
    ky, kx = k.repeat_interleave(3), k.repeat(3)
    h = torch.arange(H, device="cuda").float()
    y = h.view(H, 1, 1) + ky + torch.randn(B, H, H, 9, device="cuda", generator=gen)
    x = h.view(1, H, 1) + kx + torch.randn(B, H, H, 9, device="cuda", generator=gen)
    ay, ax = torch.floor(y).int() + 1, torch.floor(x).int() + 1
    return (ay.clamp(0, H) * (H + 1) + ax.clamp(0, H)).reshape(B, -1).contiguous()


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))


def sorted_call(lib):
    """The call through a kernel of the sorted interface: row_segments, the kernel (f32 out), the cast."""
    def call(idx, values, rows):
        B, N, D = values.shape
        out = torch.empty(B * rows, D, device="cuda")
        order, starts = row_segments(idx, rows)
        vec = 4 if D % 4 == 0 else 1
        err = lib.basedet_scatter_rows(values.data_ptr(), int(values.dtype == torch.bfloat16), order.data_ptr(),
                                       starts.data_ptr(), B * rows, D, vec, out.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"CUDA error {err}"
        return out.view(B, rows, D).to(values.dtype)
    return call


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sorted-source", type=Path, required=True,
                        help="a scatter_rows.cu of the sorted interface")
    args = parser.parse_args()
    sources = {"this": K.SOURCE, "sorted": args.sorted_source}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build_library, sources.values())))
    for name, (path, report) in built.items():
        regs = [line.split(":", 1)[1].strip() for line in report.splitlines() if "Used" in line]
        print(f"[build] {name}: {path.name}; ptxas: {'; '.join(regs)}")
    lib = ctypes.CDLL(str(built["sorted"][0]))
    lib.basedet_scatter_rows.argtypes = [VOID, INT, VOID, VOID, LONG, INT, INT, VOID, VOID]
    sorted_kernel = sorted_call(lib)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stages = []
    for B, H, D in STAGES:
        idx = dcn_idx(B, H, gen)
        stages.append((idx, torch.randn(B, idx.shape[1], D, device="cuda", generator=gen), (H + 1) ** 2))
    for dtype in (torch.float32, torch.bfloat16):
        step = {}
        for idx, v32, rows in stages:
            values = v32.to(dtype)
            calls = {"sorted": lambda: sorted_kernel(idx, values, rows),
                     "this": lambda: K.scatter_rows(idx, values, rows, out_dtype=dtype)}
            out = calls["this"]()
            assert same(out, scatter_rows_plain(idx, values, rows, dtype)), "this tree differs from the plain version"
            assert same(calls["sorted"](), out), "the sorted kernel's call differs from this tree's"
            events = {n: [] for n in calls}
            for n in ("sorted", "this", "this", "sorted"):
                events[n].append(cs.cuda_ms(calls[n], reps=20, warmup=3))
            device = {n: cs.device_kernels(f, 10) for n, f in calls.items()}
            bound = cs.scatter_bound(idx, values, rows, dtype)[0]
            B, N, D = values.shape
            parts = []
            for n in calls:
                total, ops, found = device[n]
                by_kernel = ", ".join(f"{k[:48]} {t:.4f}" for k, t in sorted(found.items(), key=lambda kv: -kv[1]))
                times = ", ".join(f"{t:.4f}" for t in events[n])
                parts.append(f"{n} call {min(events[n]):.4f} ms (events {times}), device {total:.4f} in {ops} "
                             f"operations ({by_kernel})")
            print(f"[stage] ({B}, {N}, {D}) {str(dtype)[6:]} into {rows} rows: bound {bound:.4f} ms; "
                  + "; ".join(parts), flush=True)
            for n in calls:
                step[f"{n} call"] = step.get(f"{n} call", 0.0) + min(events[n])
                step[f"{n} device"] = step.get(f"{n} device", 0.0) + device[n][0]
            step["bound"] = step.get("bound", 0.0) + bound
        print(f"[step] {str(dtype)[6:]}, 3 calls: " + ", ".join(f"{k} {v:.4f}" for k, v in step.items())
              + f" ms; this tree's device time at {step['bound'] / step['this device']:.3f} of the bound | {card}",
              flush=True)


if __name__ == "__main__":
    main()
