"""Checkpoint loading by matching (counterpart of ``basedet_tpu/utils/checkpoint.py``),
on the ``state_dict`` side.

A checkpoint here is a flat mapping ``name → array or tensor`` with
dot-joined names. Each key of the target ``state_dict`` takes, in the
target's order: the checkpoint key of the same name; else the one unused key
of which it is a string suffix or which is a suffix of it; else, among those
suffix hits, the one whose size equals the target's. A source of another
shape but the same size is reshaped (MegEngine's ``(1, C, 1, 1)`` BN
parameters). Targets with no source keep their value and are reported
missing; checkpoint keys no target took are reported unused; both give
warnings, and ``strict`` makes a missing target raise.

torch's ``num_batches_tracked`` counters take no part: the JAX variable tree
has no such leaf, so leaving them out keeps the counts equal to the JAX
package's on the same checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .logger import logger

_COUNTER = "num_batches_tracked"


def unwarp_ckpt(state: Mapping) -> Mapping:
    """Unwrap ``{model: ...}``, ``{state_dict: ...}`` or ``{params: ...}`` nesting
    of at most three keys whose inner values are not scalars."""
    for key in ("model", "state_dict", "params"):
        if key in state and isinstance(state[key], Mapping) and len(state) <= 3:
            inner = state[key]
            if all(not isinstance(v, (int, float, str)) for v in inner.values()):
                return inner
    return state


def as_tensor(value: Any) -> torch.Tensor:
    """A checkpoint leaf (array or tensor) as a CPU tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def _pick(path: str, numel: int, state: Mapping, used: set) -> Optional[str]:
    if path in state:
        return path
    hits = [k for k in state if k not in used and (k.endswith(path) or path.endswith(k))]
    if len(hits) == 1:
        return hits[0]
    sized = [k for k in hits if int(np.prod(np.shape(state[k]))) == numel]
    return sized[0] if len(sized) == 1 else None


def load_matched_weights(
    target: Mapping[str, torch.Tensor], state: Mapping, strict: bool = False
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Fill a copy of ``target`` (a ``state_dict``) from ``state`` (flat name →
    array). Returns (the new ``state_dict``, ``{"matched": int, "missing":
    [target keys], "unused": [checkpoint keys]}``)."""
    state = {k: v for k, v in unwarp_ckpt(state).items() if not k.endswith(_COUNTER)}
    used: set = set()
    out: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    matched = 0
    for path, leaf in target.items():
        out[path] = leaf
        if path.endswith(_COUNTER):
            continue
        src = _pick(path, leaf.numel(), state, used)
        if src is None:
            missing.append(path)
            continue
        value = as_tensor(state[src])
        if tuple(value.shape) != tuple(leaf.shape):
            if value.numel() != leaf.numel():
                logger.warning(f"shape mismatch for {path}: checkpoint {tuple(value.shape)} vs model "
                               f"{tuple(leaf.shape)}; keeping init")
                missing.append(path)
                continue
            value = value.reshape(leaf.shape)
        used.add(src)
        out[path] = value.to(dtype=leaf.dtype, device=leaf.device)
        matched += 1
    unused = [k for k in state if k not in used]
    if missing:
        msg = f"{len(missing)} params not found in checkpoint, e.g. {missing[:5]}"
        if strict:
            raise KeyError(msg)
        logger.warning(msg)
    if unused:
        logger.warning(f"{len(unused)} checkpoint keys unused, e.g. {unused[:5]}")
    return out, {"matched": matched, "missing": missing, "unused": unused}
