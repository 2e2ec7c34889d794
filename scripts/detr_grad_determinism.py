"""Which of full-width DETR R50's gradients differ between two identical
passes on an NVIDIA GPU:

    PYTHONPATH=. python scripts/detr_grad_determinism.py

Builds DETR from ``basedet_tpu_torch/playground/detr_r50_150e/config.py``
with ``chip_smoke.py``'s random weights from seed 0, then runs its losses and
backward twice on the same batch of 2 dummy images of 800x1333 (dropout
from the same seed and step), in IEEE f32, and prints the parameters whose
gradients are not bit-equal; then runs a third pass under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and prints the
operations PyTorch flags as non-deterministic. Tensor parallelism reads it:
the ranks of a model group compute the replicated gradients each for
itself, so any gradient listed here would drift the replicas apart unless
the model group averages it (``parallel/tp.py::all_reduce_model_grads``).
"""
from __future__ import annotations

import warnings

import torch

import chip_smoke
from basedet_tpu_torch import build_model
from basedet_tpu_torch.layers.common.function import full_f32
from basedet_tpu_torch.tools import import_config
from basedet_tpu_torch.utils.dummy import DummyLoader


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    cfg = import_config(chip_smoke.DETR_CONFIG)
    cfg.merge(["DATA.TEST.name", "dummy"])
    generator = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    model = build_model(cfg, "cuda", generator)
    chip_smoke.randomise_detr(model.module, generator)
    model.train()
    batch = DummyLoader(batch_size=2, image_size=(800, 1333), max_instances=cfg.DATA.MAX_INSTANCES).make_batch()

    def grads():
        model.module.zero_grad(set_to_none=True)
        with full_f32():
            total, _ = model.get_losses(batch, seed=42, step=0)
            total.backward()
        return {n: p.grad.clone() for n, p in model.module.named_parameters() if p.grad is not None}

    a, b = grads(), grads()
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    print(f"{len(differ)} of {len(a)} gradients differ between two identical passes "
          f"({torch.cuda.get_device_name(0)}):")
    for n in differ:
        print(f"  {n}: largest |difference| {float((a[n] - b[n]).abs().max()):.3g} of max|gradient| "
              f"{float(a[n].abs().max()):.3g}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        grads()
    print("operations flagged as non-deterministic:",
          *sorted({str(w.message).splitlines()[0][:200] for w in caught}) or ["none"], sep="\n  ")


if __name__ == "__main__":
    main()
