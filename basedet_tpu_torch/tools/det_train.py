"""Training CLI of the port (counterpart of ``basedet_tpu/tools/det_train.py``):

    python -m basedet_tpu_torch.tools.det_train -f <config.py> [--device cuda] \
        [KEY VALUE ...]
    torchrun --nproc-per-node N -m basedet_tpu_torch.tools.det_train \
        -f <config.py> --multi-host [--dist-backend nccl|gloo] [KEY VALUE ...]

Options go before the config overrides. The device defaults to ``cuda`` and
is never swapped for another. ``DATA.TRAIN.name`` names a COCO-format
dataset (``data/datasets/info.py``, under ``$BASEDET_DATA_DIR``) or ``dummy``
for synthetic batches; a ``DATA.TEST.name`` other than ``dummy``, or
``TEST.EVAL_EPOCH_INTERVAL``, evaluates on that split during and after
training. ``--resume`` continues from ``GLOBAL.CKPT_SAVE_DIR/latest.pt`` at
the epoch after it. ``--amp`` trains any model under the bf16 policy
(``TRAINER.AMP.FUSED_BN True`` adds YOLOX's fused CSP chain); ``--remat``
recomputes the network's activations in the backward (``TRAINER.REMAT``,
also ``"selective"``). ``-d DIR`` trains every ``*.py`` config of ``DIR`` in
sorted order. ``--tb`` writes TensorBoard scalars under
``GLOBAL.OUTPUT_DIR/tb`` (``GLOBAL.TENSORBOARD.LOG_IMAGES True`` adds each
epoch's detections on the last batch); ``GLOBAL.CKPT_BACKEND orbax`` saves
``GLOBAL.CKPT_SAVE_DIR/<epoch>.pt`` without blocking the loop, keeps the
newest 3 and resumes from the newest with ``--resume``. ``--debug``
launches kernels synchronously and raises at the first non-finite module
output or gradient, naming it (``tools/misc.py::enable_debug``).

``--multi-host`` trains data-parallel over the process group that torchrun's
environment describes (``basedet_tpu_torch/parallel``): each rank steps
``MODEL.BATCHSIZE`` images of a global batch of ``MODEL.BATCHSIZE`` times
the world size on ``cuda:LOCAL_RANK``. The backend is ``nccl`` on ``cuda``
and ``gloo`` on ``cpu`` unless ``--dist-backend`` names one; ``gloo`` on
``cuda`` lets ranks share a card. ``WORLD_SIZE`` above 1 without
``--multi-host`` raises (it would train unrelated copies), as does ``nccl``
with more ranks than visible cards; nothing falls back to another backend
or device.

``TRAINER.TP_SIZE N`` (N above 1, dividing the world size) lays the ranks
out as a (W/N data × N model) grid (``parallel/mesh.py``): the N consecutive
ranks of a model group step the same rows, DETR's FFNs split their hidden
width between them (``parallel/tp.py``), and the world size of the schedule
and the batch is W/N. It needs ``--multi-host`` and raises without it.
"""
from __future__ import annotations

import os

import torch

from basedet_tpu_torch import parallel
from basedet_tpu_torch.tools.misc import (apply_common_flags, default_parser, disable_debug, enable_debug,
                                          import_config, resolve_device)
from basedet_tpu_torch.utils.logger import logger, setup_logger
from basedet_tpu_torch.utils.registry import build_trainer


def _train_one(config_file: str, args, device: torch.device):
    cfg = import_config(config_file)
    apply_common_flags(cfg, args)
    tp = int(cfg.TRAINER.get("TP_SIZE", 1))
    if tp > 1 and not args.multi_host:
        raise ValueError(f"TRAINER.TP_SIZE {tp} needs --multi-host under torchrun: the model group's ranks are "
                         "processes")
    if args.multi_host:
        parallel.init_grid(tp)
    rank = parallel.global_rank()
    setup_logger(cfg.GLOBAL.OUTPUT_DIR if rank == 0 else None, rank=rank)
    logger.info(f"training config: {config_file} on {device}, data-parallel world size {parallel.world_size()}, "
                f"TP_SIZE {tp}")

    trainer = build_trainer(cfg, device)
    trainer.init_state()
    trainer.train()
    return trainer


def main(args=None):
    parser = default_parser("basedet_tpu_torch train")
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    parser.add_argument("--multi-host", action="store_true",
                        help="data-parallel over torchrun's process group (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_*)")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="the process group's backend: nccl on cuda and gloo on cpu unless named")
    parser.add_argument("-d", "--dir", type=str, default=None,
                        help="train every *.py config in this directory, in sorted order")
    args = parser.parse_args(args)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if env_world > 1 and not args.multi_host:
        raise RuntimeError(f"WORLD_SIZE={env_world} without --multi-host would train {env_world} unrelated "
                           "copies; pass --multi-host")
    if args.dist_backend and not args.multi_host:
        raise ValueError("--dist-backend needs --multi-host")
    if args.debug:
        enable_debug()  # before CUDA starts
    try:
        return _run(args)
    finally:
        if args.debug:
            disable_debug()


def _run(args):
    device = resolve_device(args.device)
    if args.multi_host:
        device = parallel.init_from_env(device, args.dist_backend)
    try:
        if args.dir:
            trainer = None
            for name in sorted(os.listdir(args.dir)):
                if name.endswith(".py"):
                    trainer = _train_one(os.path.join(args.dir, name), args, device)
            return trainer
        return _train_one(args.file, args, device)
    finally:
        if args.multi_host:
            parallel.shutdown()


if __name__ == "__main__":
    main()
