"""Rematerialisation, ``TRAINER.REMAT`` (counterpart of the ``jax.checkpoint``
in ``basedet_tpu/engine/train_state.py``): the backward recomputes the
forward's activations instead of keeping them.

The JAX package wraps its whole loss function in one ``jax.checkpoint``
(``True``), or saves only the outputs named ``conv_out``, those of
``_ConvBNAct``'s convolutions (``"selective"``). In PyTorch one checkpoint
around the whole loss would recompute all of it at the first unpack of the
backward and hold every activation again, the peak of a step without REMAT.
So the port checkpoints the network segment by segment
(``torch.utils.checkpoint``, non-reentrant), and the backward holds one
segment's activations at a time beside the segments' inputs:

  * ``True``: every ResNet stem and block, every ``ConvBNAct`` (conv, BN and
    activation: Darknet, CSPDarknet, the PAFPN, YOLOFPN and YOLOX's head are
    made of them), the FPN, each level of the RetinaNet, point and RPN heads,
    the R-CNN box head, each CenterNet deconvolution stage and head, and each
    fused CSP layer is a segment whose inputs alone are saved;
  * ``"selective"``: a ``ConvBNAct`` saves its convolution's output and
    recomputes its BN and activation (the JAX package's ``conv_out``
    anchor); every other segment is recomputed as under ``True``.

What no segment covers (the assignment, the losses' arithmetic, DETR's
transformer, the glue between segments) keeps its activations, as without
REMAT; the results are those of a step without REMAT, bit for bit, since every
segment reruns the same operations on the same inputs.

The recomputation runs in the backward, outside the train step's policy, so a
segment re-enters the compute policy it ran under; and it does not update
the train-mode BN running statistics again (:func:`recomputing`), which
change once per step, as flax's returned ``batch_stats`` do. No random draw
happens inside a segment: Faster R-CNN's sampling noise and DETR's dropout
draw from generators seeded by (seed, step) outside them, and a segment that
used PyTorch's global generators would replay them
(``preserve_rng_state``). A kernel launched inside a segment runs twice a
step (forward and recomputation): the fused CSP forward kernels; the
RoIAlign, NMS, matching and IoU kernels run outside every segment.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
from torch.utils.checkpoint import checkpoint

from basedet_tpu_torch.layers import precision

_MODE: Optional[str] = None  # None, "full" or "selective"
_IN_SEGMENT = False  # inside a segment's forward or recomputation: nested segments run plainly
_RECOMPUTING = False


def mode_from_cfg(cfg) -> Optional[str]:
    """``cfg.TRAINER.REMAT`` as the JAX package reads it: falsy → None,
    ``"selective"`` (any case) → "selective", anything else → "full"."""
    remat = cfg.TRAINER.get("REMAT", False)
    if not remat:
        return None
    return "selective" if str(remat).lower() == "selective" else "full"


@contextlib.contextmanager
def remat_policy(mode: Optional[str]) -> Iterator[None]:
    """Checkpoint the segments with ``mode`` (None: no REMAT) for the
    duration; the previous mode is restored after."""
    global _MODE
    if mode not in (None, "full", "selective"):
        raise ValueError(f"REMAT mode {mode!r} is not None, 'full' or 'selective'")
    saved, _MODE = _MODE, mode
    try:
        yield
    finally:
        _MODE = saved


def recomputing() -> bool:
    """True while a segment is being recomputed in the backward."""
    return _RECOMPUTING


@contextlib.contextmanager
def _segment_context(recompute: bool, policy) -> Iterator[None]:
    global _IN_SEGMENT, _RECOMPUTING
    saved = _IN_SEGMENT, _RECOMPUTING
    _IN_SEGMENT, _RECOMPUTING = True, recompute or _RECOMPUTING
    try:
        with precision.precision_policy(*policy) if recompute else contextlib.nullcontext():
            yield
    finally:
        _IN_SEGMENT, _RECOMPUTING = saved


def _live() -> bool:
    return _MODE is not None and not _IN_SEGMENT and torch.is_grad_enabled()


def segment(fn: Callable, *args):
    """``fn(*args)``, checkpointed when REMAT is on, gradients are on and no
    segment encloses this one; else called as it is."""
    if not _live():
        return fn(*args)
    policy = precision.current_policy()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (_segment_context(False, policy), _segment_context(True, policy)))


def conv_tail(conv: Callable, tail: Callable, x: torch.Tensor) -> torch.Tensor:
    """``tail(conv(x))`` for a convolution and its BN and activation: one
    segment under ``True``; under ``"selective"`` the convolution runs
    outside the segment, so its output is saved, and only the tail is
    recomputed."""
    if _live() and _MODE == "selective":
        return segment(tail, conv(x))
    return segment(lambda t: tail(conv(t)), x)
