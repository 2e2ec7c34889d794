"""Weight bridge between the JAX variable tree and the port's ``state_dict``.

Pure numpy and torch. A flax leaf ``{collection}/a/b/.../leaf`` maps to the
key ``a.b....name``, module names kept, and the leaf renamed: conv ``kernel``
HWIO → ``weight`` OIHW (depthwise ``(k, k, 1, C)`` → ``(C, 1, k, k)`` by the
same transpose), ``Dense`` ``kernel`` (in, out) → ``Linear.weight`` (out,
in), BN ``scale/bias`` (params) and ``mean/var`` (batch_stats) →
``weight/bias/running_mean/running_var``. A train-mode BN keeps its flax name
``BatchNorm_<i>`` where its flax parent holds several (a ResNet block, a
CenterNet ``DeconvLayer``); a parent's only one, ``BatchNorm_0``, is called
``bn`` (YOLOX's ``ConvBNAct``, the ResNet stem). Each BN also gets torch's
``num_batches_tracked`` buffer (0), which has no JAX counterpart.

The kernel of a module named ``up_sample`` (CenterNet's 4x4 transposed
convolution, ``SubpixelConvTranspose2x``) is stored ``(4, 4, Ci, Co)`` with
torch's semantics: ``ConvTranspose2d.weight`` ``(Ci, Co, 4, 4)`` is its
``transpose(2, 3, 0, 1)``, not the conv rule's, which would swap the
channels (and raise no error, as Ci == Co there).
The ``frozen`` collection of ``FrozenBatchNorm_<i>`` (scale, bias, mean,
var) maps to that module's buffers of the same four torch names; the module
keeps its flax name.

A ``Dense`` kernel's rows keep their order: the port's box head flattens
RoIAlign's channels-last (ph, pw, C) output in the same (h, w, c) order as
the flax ``fc1``.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_BN = "BatchNorm_0"
_BN_NAME = re.compile(r"BatchNorm_\d+")
_TRANSPOSED = "up_sample"
_FROZEN_BN = "FrozenBatchNorm_"
_TO_TORCH = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
    ("frozen", "scale"): "weight",
    ("frozen", "bias"): "bias",
    ("frozen", "mean"): "running_mean",
    ("frozen", "var"): "running_var",
}
# (torch name, owning module kind) → (collection, flax leaf)
_TO_JAX = {
    ("weight", None): ("params", "kernel"),
    ("bias", None): ("params", "bias"),
    ("weight", "bn"): ("params", "scale"),
    ("bias", "bn"): ("params", "bias"),
    ("running_mean", "bn"): ("batch_stats", "mean"),
    ("running_var", "bn"): ("batch_stats", "var"),
    **{(name, "frozen"): ("frozen", leaf) for (coll, leaf), name in _TO_TORCH.items()
       if coll == "frozen"},
}


def _kernel_to_torch(path: str, value: np.ndarray, transposed: bool) -> np.ndarray:
    if value.ndim == 4:  # transposed conv (kh, kw, Ci, Co) → (Ci, Co, kh, kw); conv HWIO → OIHW
        return value.transpose(2, 3, 0, 1) if transposed else value.transpose(3, 2, 0, 1)
    if value.ndim == 2:  # Dense (in, out) → Linear (out, in)
        return value.T
    raise ValueError(f"{path}: expected an HWIO conv or (in, out) Dense kernel, got {value.shape}")


def _kernel_to_jax(value: np.ndarray, transposed: bool) -> np.ndarray:
    if value.ndim == 4:
        return value.transpose(2, 3, 0, 1) if transposed else value.transpose(2, 3, 1, 0)
    return value.T


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def state_dict_from_jax(
    variables: Mapping, reference: Optional[Mapping[str, torch.Tensor]] = None
) -> Dict[str, torch.Tensor]:
    """Map a flax variable tree (numpy leaves) to a ``state_dict``. With
    ``reference`` (a model's ``state_dict()``), the keys and shapes must
    match it exactly: a missing or extra key raises ``KeyError``."""
    sd: Dict[str, torch.Tensor] = {}
    leaves = list(_leaves(variables))
    # parents holding a BatchNorm_<i> beside BatchNorm_0: theirs keep their names
    several = {tuple(path[1:-2]) for path, _ in leaves
               if len(path) > 2 and _BN_NAME.fullmatch(path[-2]) and path[-2] != _BN}
    for (collection, *mods, leaf), value in leaves:
        name = _TO_TORCH.get((collection, leaf))
        if name is None or not mods:
            raise KeyError(f"no torch counterpart for {'/'.join([collection, *mods, leaf])}")
        if leaf == "kernel":
            value = _kernel_to_torch("/".join(mods), value, mods[-1] == _TRANSPOSED)
        is_bn = bool(_BN_NAME.fullmatch(mods[-1]))
        names = ["bn" if m == _BN and tuple(mods[:i]) not in several else m
                 for i, m in enumerate(mods)]
        key = ".".join(names + [name])
        if key in sd:
            raise KeyError(f"two JAX leaves map to {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
        if is_bn:
            sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0)
    if reference is not None:
        missing = sorted(set(reference) - set(sd))
        extra = sorted(set(sd) - set(reference))
        if missing or extra:
            raise KeyError(f"state_dict keys differ: missing {missing[:8]}, extra {extra[:8]}")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(reference[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != {tuple(reference[k].shape)}")
    return sd


def jax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """Inverse of :func:`state_dict_from_jax`: a flax variable tree with
    numpy leaves."""
    tree: Dict[str, dict] = {}
    for key, tensor in sd.items():
        *mods, name = key.split(".")
        kind = None
        if mods and (mods[-1] == "bn" or _BN_NAME.fullmatch(mods[-1])):
            kind = "bn"
        elif mods and mods[-1].startswith(_FROZEN_BN):
            kind = "frozen"
        if name == "num_batches_tracked" and kind == "bn":
            continue
        target = _TO_JAX.get((name, kind))
        if target is None or not mods:
            raise KeyError(f"no JAX counterpart for {key}")
        collection, leaf = target
        value = tensor.detach().cpu().numpy()
        if leaf == "kernel":
            value = _kernel_to_jax(value, mods[-1] == _TRANSPOSED)
        node = tree.setdefault(collection, {})
        for m in mods:
            node = node.setdefault(_BN if m == "bn" else m, {})
        if leaf in node:
            raise KeyError(f"two state_dict keys map to {collection}/{'/'.join(mods)}/{leaf}")
        node[leaf] = value
    return tree
