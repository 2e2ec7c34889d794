"""An inference cell: one caller sends the port's ``BaseNet.inference`` page-
locked host batches back to back (closed loop) and waits for each batch's
detections on the host; a batch's time runs from the call to the last
detection copied back.

The check draws from the seed a sample of the window's batches, runs the
plain reference once over each of their pool batches and compares the
padded detections."""
from __future__ import annotations

import random
import statistics
import time
from typing import Dict, List, Optional

import torch

from core import check, port, trace, traffic
from core.roofline import PEAK_FLOPS
from reference.common import identity, set_quant, tf32_round

WARM = 3  # warm-up batches


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.t = cell.config["infer"]
        self.batch, self.image = int(self.t["batch"]), tuple(self.t["image"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        c = self.cell.config
        self.pool = traffic.infer_pool(self.cell.traffic, self.batch, self.image, self.seed, self.device)
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            self.held = torch.cuda.memory_allocated(self.device)
        cfg = port.port_config(c, self.batch, False, self.seed)
        self.model = port.build_port_model(c, cfg, self.seed, self.device).eval()
        self.k = 0
        for _ in range(WARM):
            self.serve()

    def serve(self) -> Dict[str, torch.Tensor]:
        """One batch through ``inference``, its detections on the host."""
        dets = self.model.inference(self.pool[self.k % len(self.pool)])
        self.k += 1
        return {k: v.cpu() for k, v in dets.items()}

    def window(self, seconds: float) -> Dict[str, float]:
        self.sync()
        self.outputs: List[Dict[str, torch.Tensor]] = []
        self.first = self.k
        latencies = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            a = time.perf_counter()
            self.outputs.append(self.serve())
            latencies.append(time.perf_counter() - a)
        dt = time.perf_counter() - t0
        self.images_per_s = len(latencies) * self.batch / dt
        self.latencies = latencies
        self.peak_gib = ((torch.cuda.max_memory_allocated(self.device) - self.held) / 2 ** 30
                         if self.device.type == "cuda" else None)
        self.attempted = len(latencies)
        p95 = statistics.quantiles(latencies, n=20)[18] if len(latencies) >= 2 else latencies[0]
        return {"infer_img_per_s": self.images_per_s, "infer_p95_ms": p95 * 1e3}

    def traced(self) -> trace.Trace:
        tr = trace.traced_stretch(self.serve, int(self.cell.traffic["trace_steps"]), trace.Recorder())
        flops = port.flops_per_image(self.cell.config, self.batch, self.image, train=False)
        tr.run = {"images_per_s": self.images_per_s, "flops_per_image": flops,
                  "peak_flops": PEAK_FLOPS["float32"], "batch": self.batch, "peak_gib": self.peak_gib}
        return tr

    def release(self) -> None:
        del self.model
        port.free_device()

    def sample(self) -> List[int]:
        """Window batches to check, drawn from the seed: ``check_batches`` of them."""
        n = len(self.outputs)
        return sorted(random.Random(self.seed).sample(range(n), min(n, int(self.cell.traffic["check_batches"]))))

    def reference_dets(self, pool_ids, control: Optional[str]) -> Dict[int, Dict[str, torch.Tensor]]:
        """The reference's detections for each pool batch, f32 with TF32 off,
        or with ``control`` "tf32_rounded" every convolution's and product's
        inputs rounded to TF32, as TF32 tensor cores take them."""
        weights = port.seeded_weights(self.cell.config, self.seed, self.device)
        _, ref = port.build_reference(self.cell.config, weights, self.device)
        del weights
        ref.eval()
        set_quant(ref, tf32_round if control == "tf32_rounded" else identity)
        port.tf32_off()
        out = {}
        with torch.no_grad():
            for i in sorted(set(pool_ids)):
                batch = {k: v.to(self.device) for k, v in self.pool[i].items()}
                out[i] = {k: v.cpu() for k, v in ref.inference(batch).items()}
        del ref
        port.free_device()
        return out

    def readings(self, control: Optional[str] = None) -> Dict[str, float]:
        """The sampled window batches against the reference, or, with
        ``control``, the reference in that numerics in the program's place."""
        picks = self.sample()
        pool_ids = [(self.first + j) % len(self.pool) for j in picks]
        ref = self.reference_dets(pool_ids, None)
        if control is None:
            prog = [self.outputs[j] for j in picks]
        else:
            ctrl = self.reference_dets(pool_ids, control)
            prog = [ctrl[i] for i in pool_ids]
        return check.infer_readings(prog, [ref[i] for i in pool_ids])
