"""Training CLI of the port (counterpart of ``basedet_tpu/tools/det_train.py``):

    python -m basedet_tpu_torch.tools.det_train -f <config.py> [--device cuda] \
        [KEY VALUE ...]

Options go before the config overrides. The device defaults to ``cuda`` and
is never swapped for another. ``DATA.TRAIN.name`` names a COCO-format
dataset (``data/datasets/info.py``, under ``$BASEDET_DATA_DIR``) or ``dummy``
for synthetic batches; a ``DATA.TEST.name`` other than ``dummy``, or
``TEST.EVAL_EPOCH_INTERVAL``, evaluates on that split during and after
training. ``--resume`` continues from ``GLOBAL.CKPT_SAVE_DIR/latest.pt`` at
the epoch after it. ``--amp`` trains any model under the bf16 policy
(``TRAINER.AMP.FUSED_BN True`` adds YOLOX's fused CSP chain); ``--remat``
recomputes the network's activations in the backward (``TRAINER.REMAT``,
also ``"selective"``). ``--tb`` and ``--debug`` are refused: they are not
ported yet.
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
