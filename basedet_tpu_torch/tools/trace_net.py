"""Export CLI of the port (counterpart of ``basedet_tpu/tools/trace_net.py``):

    python -m basedet_tpu_torch.tools.trace_net -f <config.py> [-w <weights>] \
        [--out model.pt2] [--height 640 --width 640] [--device cuda] [KEY VALUE ...]

Builds the model, loads ``-w`` as ``det_test`` does, and saves the module's
eval forward at (1, 3, H, W) through ``torch.export`` (``BaseNet.
dump_static_graph``). The NMS and RoIAlign kernels stay in the program as the
custom ops ``basedet::nms_keep`` and ``basedet::roi_align``; reload it with
``basedet_tpu_torch.models.base_net.load_static_graph``. The device defaults
to ``cuda`` and is never swapped for another.
"""
from __future__ import annotations

from basedet_tpu_torch.tools.misc import apply_common_flags, default_parser, import_config, resolve_device
from basedet_tpu_torch.utils.logger import logger, setup_logger
from basedet_tpu_torch.utils.registry import build_model


def main(args=None):
    parser = default_parser("basedet_tpu_torch trace/export")
    parser.add_argument("--out", type=str, default="model.pt2")
    parser.add_argument("--height", type=int, default=640)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    args = parser.parse_args(args)
    device = resolve_device(args.device)
    cfg = import_config(args.file)
    apply_common_flags(cfg, args)
    setup_logger(cfg.GLOBAL.OUTPUT_DIR, file_prefix="trace_log")

    model = build_model(cfg, device)
    if args.weights:
        model.load_weights(args.weights)
    program = model.dump_static_graph(args.out, image_size=(args.height, args.width))
    logger.info(f"exported to {args.out}")
    return program


if __name__ == "__main__":
    main()
