"""Training CLI of the port (counterpart of ``basedet_tpu/tools/det_train.py``):

    python -m basedet_tpu_torch.tools.det_train -f <config.py> [--device cuda] \
        [KEY VALUE ...]

Options go before the config overrides. The device defaults to ``cuda`` and
is never swapped for another. Only the synthetic training set is ported
(``DATA.TRAIN.name dummy``). ``--amp`` trains YOLOX under the bf16 policy
(``TRAINER.AMP.FUSED_BN True`` adds the fused CSP chain) and is refused for
the other models; ``--remat``, ``--resume``, ``--tb`` and ``--debug`` are
refused: they are not ported yet.
"""
from __future__ import annotations

import torch

from basedet_tpu_torch.tools.misc import apply_common_flags, default_parser, import_config
from basedet_tpu_torch.utils.logger import logger, setup_logger
from basedet_tpu_torch.utils.registry import build_trainer


def main(args=None):
    parser = default_parser("basedet_tpu_torch train")
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    args = parser.parse_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; pass --device cpu explicitly")

    cfg = import_config(args.file)
    apply_common_flags(cfg, args)
    setup_logger(cfg.GLOBAL.OUTPUT_DIR)
    logger.info(f"training config: {args.file} on {device}")

    trainer = build_trainer(cfg, device)
    trainer.init_state()
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
