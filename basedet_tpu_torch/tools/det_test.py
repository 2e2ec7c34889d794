"""Evaluation CLI of the port (counterpart of ``basedet_tpu/tools/det_test.py``):

    python -m basedet_tpu_torch.tools.det_test -f <config.py> -w <weights> \
        [--device cuda] [KEY VALUE ...]

Options go before the config overrides. ``-w`` takes a ``torch.save``d
state_dict (``det_train``'s ``dumped_model.pt``), a training checkpoint, or a
pickle of the JAX variable tree with numpy leaves; without it, the checkpoint
that ``GLOBAL.CKPT_SAVE_DIR/last_checkpoint`` names. ``--eval-ema`` evaluates
a training checkpoint's EMA weights too, after its live ones. The device
defaults to ``cuda`` and is never swapped for another. ``--debug`` as in
``det_train``.
"""
from __future__ import annotations

import os

from basedet_tpu_torch.data.build import build_test_dataloader
from basedet_tpu_torch.engine.tester import BaseTester
from basedet_tpu_torch.tools.misc import (apply_common_flags, default_parser, disable_debug, enable_debug,
                                          import_config, resolve_device)
from basedet_tpu_torch.utils.logger import logger, setup_logger
from basedet_tpu_torch.utils.registry import build_evaluator, build_model


def main(args=None):
    parser = default_parser("basedet_tpu_torch test")
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    parser.add_argument("--eval-ema", action="store_true")
    args = parser.parse_args(args)
    if args.debug:
        enable_debug()  # before CUDA starts
    try:
        return _test(args)
    finally:
        if args.debug:
            disable_debug()


def _test(args):
    device = resolve_device(args.device)
    cfg = import_config(args.file)
    apply_common_flags(cfg, args)
    cfg.MODEL.BATCHSIZE = 1  # as the reference's det_test
    setup_logger(cfg.GLOBAL.OUTPUT_DIR, file_prefix="test_log")

    weights = args.weights
    if weights is None:
        with open(os.path.join(cfg.GLOBAL.CKPT_SAVE_DIR, "last_checkpoint")) as f:
            weights = os.path.join(cfg.GLOBAL.CKPT_SAVE_DIR, f.read().strip())
    model = build_model(cfg, device)
    tester = BaseTester(model, build_test_dataloader(cfg, device=device), build_evaluator(cfg))
    model.load_weights(weights)
    results = tester.test()
    logger.info(f"eval results: {results}")
    if args.eval_ema:
        model.load_weights(weights, ema=True)
        logger.info(f"eval results (EMA): {tester.test()}")
    return results


if __name__ == "__main__":
    main()
