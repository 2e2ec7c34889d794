"""Model analysis CLI of the port (counterpart of ``basedet_tpu/tools/analyze_net.py``):

    python -m basedet_tpu_torch.tools.analyze_net -f <config.py> \
        [--height 640 --width 640] [--device cuda] [KEY VALUE ...]

``params_M`` counts the module's parameters, trainable or frozen by the
solver: the JAX package's ``params`` collection. The frozen BatchNorms'
state and the BN running statistics are buffers here, as they are the
``frozen`` and ``batch_stats`` collections there, and are not counted.

``forward_gflops`` is what ``torch.utils.flop_counter.FlopCounterMode``
counts over one eval forward of the module at (1, 3, H, W)
(``BaseNet.example_inputs``): two operations per multiply-add of the
convolutions (forward and transposed), the matrix products (``mm``,
``addmm``, ``bmm``, ``baddbmm``, ``einsum`` through them) and the fused
attention kernels. Elementwise work, normalisations, reductions, sorts and
the custom ops (NMS, RoIAlign) count nothing, where XLA's ``cost_analysis``,
which the JAX tool reads, counts elementwise work too; the two figures are
not the same measure.
"""
from __future__ import annotations

import torch

from basedet_tpu_torch.tools.misc import apply_common_flags, default_parser, import_config, resolve_device
from basedet_tpu_torch.utils.logger import logger, setup_logger
from basedet_tpu_torch.utils.registry import build_model


def count_params(module: torch.nn.Module) -> int:
    """The number of parameter entries (the JAX package's ``params``)."""
    return sum(p.numel() for p in module.parameters())


def forward_flops(module: torch.nn.Module, args) -> int:
    """FlopCounterMode's count over one eval forward of ``module`` on ``args``."""
    from torch.utils.flop_counter import FlopCounterMode

    training = module.training
    params = [p for p in module.parameters() if p.requires_grad]
    module.eval()
    counter = FlopCounterMode(display=False)
    try:
        # no parameter requires grad during the count: the counter's module tracker hooks the backward of
        # every input that does, and a parameter handed to a submodule (DETR's query embedding) has no
        # graph to hook under no_grad
        for p in params:
            p.requires_grad_(False)
        with torch.no_grad(), counter:
            module(*args)
    finally:
        for p in params:
            p.requires_grad_(True)
        module.train(training)
    return counter.get_total_flops()


def analyze(cfg, image_size=(640, 640), device="cpu"):
    model = build_model(cfg, device)
    n_params = count_params(model.module)
    flops = forward_flops(model.module, model.example_inputs(image_size))
    stats = {
        "model": cfg.MODEL.NAME,
        "params": n_params,
        "params_M": round(n_params / 1e6, 3),
        "forward_gflops": round(flops / 1e9, 2),
        "image_size": tuple(image_size),
    }
    logger.info(f"analysis: {stats}")
    return stats


def main(args=None):
    parser = default_parser("basedet_tpu_torch analyze")
    parser.add_argument("--height", type=int, default=640)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    args = parser.parse_args(args)
    device = resolve_device(args.device)
    cfg = import_config(args.file)
    apply_common_flags(cfg, args)
    setup_logger()
    return analyze(cfg, (args.height, args.width), device)


if __name__ == "__main__":
    main()
