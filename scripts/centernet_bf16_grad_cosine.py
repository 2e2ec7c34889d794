"""The bf16-vs-f32 gradient cosine of train-mode CenterNet R50-DCNv2 in the
JAX package and in the port, on the CPU:

    JAX_PLATFORMS=cpu python scripts/centernet_bf16_grad_cosine.py [--size 512] [--batch 2] [--seed 0]

Weights: the port's full-width CenterNet
(``basedet_tpu_torch/playground/centernet_r50/config.py``, FREEZE_AT 0, so
every BN of the backbone and neck trains) from a CPU generator seeded
``--seed`` and spread as ``chip_smoke.randomise_cnet`` spreads them, which is
the recipe of chip_smoke.py's phase 41 (the card's generator draws other
values from the same seed); carried to the JAX variable tree by
``basedet_tpu_torch/utils/weights.py``. Batch: ``DataloaderBuilder``'s first
synthetic batch of ``--batch`` images of ``--size``². Each package takes one
gradient of its ``get_losses`` in train mode in f32 and one under its bf16
policy. Prints the losses, the gradient norms and the cosines: JAX bf16
against JAX f32, the port's bf16 against its f32, the port's f32 against
JAX's f32 (the carry's check), and the share of the f32 gradient's norm² in
the stem and layer1.

Outside tier-1: a full-width ResNet-50 on the CPU takes minutes and
gigabytes (it prints its peak resident memory).
"""
from __future__ import annotations

import argparse
import math
import os
import resource
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG = "basedet_tpu_torch/playground/centernet_r50/config.py"


def cosine(a, b):
    keys = sorted(set(a) & set(b))
    x = np.concatenate([np.asarray(a[k], np.float64).ravel() for k in keys])
    y = np.concatenate([np.asarray(b[k], np.float64).ravel() for k in keys])
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


def norm(g):
    return math.sqrt(sum(float(np.sum(np.asarray(v, np.float64) ** 2)) for v in g.values()))


def stem_share(g):
    front = sum(float(np.sum(np.asarray(v, np.float64) ** 2)) for k, v in g.items()
                if k.startswith(("bottom_up.conv1", "bottom_up.bn", "bottom_up.layer1")))
    return front / norm(g) ** 2


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from basedet_tpu import configs as C
    from basedet_tpu.layers.precision import precision_policy as jax_policy
    from basedet_tpu.utils import all_register
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.precision import precision_policy
    from basedet_tpu_torch.tools import import_config
    from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
    from chip_smoke import randomise_cnet

    jax.config.update("jax_platforms", "cpu")
    torch.manual_seed(args.seed)
    opts = ["DATA.TRAIN.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", f"({args.size},{args.size})",
            "MODEL.BATCHSIZE", str(args.batch)]
    cfg = import_config(CONFIG)
    cfg.merge(opts)
    generator = torch.Generator().manual_seed(args.seed)
    port = build_model(cfg, "cpu", generator)
    randomise_cnet(port.module, generator)
    port.train()
    batch = next(iter(DataloaderBuilder.build(cfg, "cpu")))
    variables = jax_from_state_dict(port.module.state_dict())

    out = {}
    for dtype in (None, torch.bfloat16):
        t0 = time.perf_counter()
        port.module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                                     state_dict_from_jax(variables, port.module.state_dict()).items()})
        port.module.zero_grad(set_to_none=True)
        with full_f32(), precision_policy(dtype):
            total, losses = port.get_losses(batch)
        with full_f32():
            total.backward()
        grads = {n: p.grad.double().numpy() for n, p in port.module.named_parameters() if p.grad is not None}
        out["port", dtype] = ({k: float(v.detach()) for k, v in losses.items()}, grads)
        print(f"port {dtype or 'f32'}: {time.perf_counter() - t0:.1f} s", flush=True)

    all_register()
    jcfg = C.CenterNetConfig()
    jcfg.merge(opts)
    jmodel = jcfg.build_model()
    others = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        total, losses, _ = jmodel.get_losses({**others, "params": params}, batch)
        return total, losses

    for dtype in (None, jnp.bfloat16):
        t0 = time.perf_counter()
        with jax_policy(dtype):
            (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        grads = {k: v.numpy().astype(np.float64) for k, v in
                 state_dict_from_jax({"params": jax.device_get(grads)}).items()}
        out["jax", dtype] = ({k: float(v) for k, v in jax.device_get(losses).items()}, grads)
        print(f"jax {dtype or 'f32'}: {time.perf_counter() - t0:.1f} s", flush=True)

    for (pkg, dtype), (losses, grads) in out.items():
        print(f"{pkg} {'bf16' if dtype is not None else 'f32'}: losses "
              f"{ {k: round(v, 6) for k, v in losses.items()} }, gradient norm {norm(grads):.6g}, stem+layer1 "
              f"share of norm² {stem_share(grads):.4f}")
    jf, jb = out["jax", None][1], out["jax", jnp.bfloat16][1]
    pf, pb = out["port", None][1], out["port", torch.bfloat16][1]
    print(f"CenterNet R50-DCNv2 train mode, batch {args.batch} of {args.size}x{args.size}, seed {args.seed}: "
          f"cosine JAX bf16 vs JAX f32 {cosine(jb, jf):.4f}; port bf16 vs port f32 {cosine(pb, pf):.4f}; "
          f"port f32 vs JAX f32 {cosine(pf, jf):.6f}; port bf16 vs JAX bf16 {cosine(pb, jb):.4f}; peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20:.2f} GiB")


if __name__ == "__main__":
    main()
