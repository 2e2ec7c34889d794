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

The FCOS family's point head adds flax ``GroupNorm`` modules
(``cls_gn_<i>``, ``bbox_gn_<i>``, and ``cls_gn_l<lv>_<i>``,
``bbox_gn_l<lv>_<i>`` per level): ``scale``/``bias`` → ``weight``/``bias`` of
``nn.GroupNorm``, no transpose; and its top-level ``scales`` parameter (one
per level) keeps its name and shape. An FPN with ``GN`` holds flax's
``GroupNorm_<i>`` under the same rule.

RetinaNet's FPN top-block convs (``fpn_p6``, ``fpn_p7``) and its head, in
either ``share_param`` form (``cls_subnet_<i>``, ``cls_score``, ... or
``cls_subnet_l<lv>_<i>``, ``cls_score_l<lv>``, ...), are plain convs under
their flax names and take the conv rule. So are YOLOv3's Darknet
(``stem``, ``dark<i>_down``, ``dark<i>_block<b>/layer1|layer2``, each a
``ConvBNAct`` with ``conv`` and ``BatchNorm_0``) and YOLOFPN
(``output_conv<i>_conv<j>``, ``output_conv<i>_pred``, ``lateral_conv<i>``).

The HF backbone zoo (``layers/backbone/hf_adaptor.py``) names its BNs
``normalization`` (Flax ``nn.BatchNorm``: ``scale``/``bias`` in params,
``mean``/``var`` in batch_stats), kept as they are; its grouped kernels
``(kh, kw, Cin/g, Cout)`` and its squeeze-excitation convs with bias
(``attention/0``, ``attention/2``) take the conv rule.

DETR's transformer adds flax ``LayerNorm`` (``norm<i>``, ``encoder_norm``,
``decoder_norm``): ``scale``/``bias`` → ``weight``/``bias``, no transpose;
and the ``DenseGeneral`` projections of each ``self_attn``/``cross_attn``
(``MultiHeadDotProductAttention``): the ``query``, ``key`` and ``value``
kernels (D, H, D/H) and biases (H, D/H) become ``nn.Linear`` weights (H·D/H,
D) and biases by a reshape to (D, H·D/H) and a transpose, the ``out`` kernel
(H, D/H, D) by a reshape to (H·D/H, D) and a transpose. The way back needs
the head count: :func:`jax_from_state_dict` takes ``num_heads``. The
top-level ``query_embed`` and the learned embedding's ``row_embed`` and
``col_embed`` keep their names and layout.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_BN = "BatchNorm_0"
_BN_NAME = re.compile(r"BatchNorm_\d+|normalization")
_TRANSPOSED = "up_sample"
_FROZEN_BN = "FrozenBatchNorm_"
_GN_NAME = re.compile(r"(cls|bbox)_gn(_l\d+)?_\d+|GroupNorm_\d+")
_LN_NAME = re.compile(r"norm\d+|encoder_norm|decoder_norm")
_ATTENTION = ("self_attn", "cross_attn")
_PROJ_IN = ("query", "key", "value")
_PASSED = ("scales", "query_embed", "row_embed", "col_embed")  # params leaves that keep their name and layout
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
    ("weight", "gn"): ("params", "scale"),
    ("bias", "gn"): ("params", "bias"),
    ("weight", "ln"): ("params", "scale"),
    ("bias", "ln"): ("params", "bias"),
    ("weight", "attn"): ("params", "kernel"),
    ("bias", "attn"): ("params", "bias"),
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


def _attention_to_torch(proj: str, leaf: str, value: np.ndarray) -> np.ndarray:
    """A ``DenseGeneral`` leaf of flax's attention → its ``nn.Linear`` tensor."""
    if leaf == "bias":
        return value.reshape(-1)
    if proj == "out":  # (H, D/H, D) → (D, H·D/H)
        return value.reshape(-1, value.shape[-1]).T
    return value.reshape(value.shape[0], -1).T  # (D, H, D/H) → (H·D/H, D)


def _attention_to_jax(proj: str, leaf: str, value: np.ndarray, num_heads: int) -> np.ndarray:
    if proj == "out":
        return value if leaf == "bias" else value.T.reshape(num_heads, -1, value.shape[0])
    if leaf == "bias":
        return value.reshape(num_heads, -1)
    return value.T.reshape(value.shape[1], num_heads, -1)


def _is_attention(mods) -> bool:
    return len(mods) >= 2 and mods[-2] in _ATTENTION and mods[-1] in (*_PROJ_IN, "out")


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
        passed = collection == "params" and leaf in _PASSED
        name = leaf if passed else _TO_TORCH.get((collection, leaf))
        if name is None or not (mods or passed):
            raise KeyError(f"no torch counterpart for {'/'.join([collection, *mods, leaf])}")
        if _is_attention(mods):
            value = _attention_to_torch(mods[-1], leaf, value)
        elif leaf == "kernel":
            value = _kernel_to_torch("/".join(mods), value, mods[-1] == _TRANSPOSED)
        is_bn = bool(mods) and bool(_BN_NAME.fullmatch(mods[-1]))
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


def jax_from_state_dict(sd: Mapping[str, torch.Tensor], num_heads: Optional[int] = None) -> Dict[str, dict]:
    """Inverse of :func:`state_dict_from_jax`: a flax variable tree with
    numpy leaves. ``num_heads`` is the attention's head count, needed where
    ``sd`` holds an attention projection."""
    tree: Dict[str, dict] = {}
    for key, tensor in sd.items():
        *mods, name = key.split(".")
        kind = None
        if mods and (mods[-1] == "bn" or _BN_NAME.fullmatch(mods[-1])):
            kind = "bn"
        elif mods and mods[-1].startswith(_FROZEN_BN):
            kind = "frozen"
        elif mods and _GN_NAME.fullmatch(mods[-1]):
            kind = "gn"
        elif mods and _LN_NAME.fullmatch(mods[-1]):
            kind = "ln"
        elif _is_attention(mods):
            kind = "attn"
        if name == "num_batches_tracked" and kind == "bn":
            continue
        passed = name in _PASSED and kind is None
        target = ("params", name) if passed else _TO_JAX.get((name, kind))
        if target is None or not (mods or passed):
            raise KeyError(f"no JAX counterpart for {key}")
        collection, leaf = target
        value = tensor.detach().cpu().numpy()
        if kind == "attn":
            if num_heads is None:
                raise ValueError(f"{key}: an attention projection needs num_heads")
            value = _attention_to_jax(mods[-1], leaf, value, num_heads)
        elif leaf == "kernel":
            value = _kernel_to_jax(value, mods[-1] == _TRANSPOSED)
        node = tree.setdefault(collection, {})
        for m in mods:
            node = node.setdefault(_BN if m == "bn" else m, {})
        if leaf in node:
            raise KeyError(f"two state_dict keys map to {collection}/{'/'.join(mods)}/{leaf}")
        node[leaf] = value
    return tree
