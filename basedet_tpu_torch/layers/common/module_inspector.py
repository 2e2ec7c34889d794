"""Intermediate-feature extraction (counterpart of
``basedet_tpu/layers/common/module_inspector.py``, and of the reference's
``feature_extract`` built on forward hooks, which the JAX package replaced
with flax's ``capture_intermediates``).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Union

import torch.nn as nn


def feature_extract(
    module: nn.Module,
    *args,
    filter_fn: Union[Sequence[str], Callable, None] = None,
    **kwargs,
):
    """Run ``module(*args, **kwargs)`` with a forward hook on each submodule
    that ``filter_fn`` keeps: a list of path substrings, or a callable
    (path, submodule) → bool; None keeps every submodule. Paths are the
    module's own names with ``/`` between levels (the flax names the port's
    modules carry), ``""`` for the module itself. A submodule called more
    than once (a head shared over levels) keeps its first call's output, as
    flax's capture keeps the first value. Returns (outputs, {path: output}).
    """
    if filter_fn is None:
        keep = lambda path, mdl: True  # noqa: E731
    elif callable(filter_fn):
        keep = filter_fn
    else:
        names = list(filter_fn)
        keep = lambda path, mdl: any(n in path for n in names)  # noqa: E731
    captured: Dict[str, object] = {}
    handles = []

    def hook(path):
        def record(_mdl, _inputs, output):
            captured.setdefault(path, output)
        return record

    for name, mdl in module.named_modules():
        path = name.replace(".", "/")
        if keep(path, mdl):
            handles.append(mdl.register_forward_hook(hook(path)))
    try:
        outputs = module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return outputs, captured
