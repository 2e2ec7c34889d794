"""The HuggingFace backbone zoo: ResNet and RegNet X/Y as plain PyTorch
(counterpart of ``basedet_tpu/layers/backbone/hf_adaptor.py``).

The JAX package wraps ``transformers``' Flax vision modules; the port writes
the same architectures itself from ``modeling_flax_resnet.py`` and
``modeling_flax_regnet.py`` (transformers 4.57), so it imports neither
``transformers`` nor flax:

  * ResNet: the embedder (7x7/2 conv, BN, activation, 3x3/2 max-pool with
    padding 1), basic layers (two 3x3 convs) or bottleneck layers (1x1 to a
    quarter of the width, 3x3 carrying the stride, 1x1 back), a projection
    shortcut (1x1 conv + BN) where the width or the stride changes, the first
    stage at stride 1;
  * RegNet: a 3x3/2 stem, every stage downsampling, X layers (1x1, grouped
    3x3 with ``width // groups_width`` groups, 1x1) and Y layers (X with a
    squeeze-excitation after the 3x3: mean over the plane, 1x1 conv to
    ``round(in_channels / 4)`` with bias, ReLU, 1x1 conv back with bias,
    sigmoid, product).

Every norm is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
(``FlaxBatchNorm2d``): batch statistics and a running update in train mode,
over every rank under a process group, whatever ``MODEL.BACKBONE.NORM`` and
``FREEZE_AT`` say, as the JAX adapter ignores them; so every parameter
trains. The Flax RegNet layers call their inner conv layers without
``deterministic``, which defaults to True there: those BNs (the 1x1, 3x3
and 1x1 of every X or Y layer) normalise with their running statistics in
train mode too and never update them (``_RunningStatsBatchNorm``); the stem's
and the shortcuts' follow the mode. The HF modules use flax's own
``nn.Conv`` in f32, not the JAX package's policy-aware ``Conv``, so the
backbone computes in f32 under ``--amp`` (the adapter suspends the policy;
the FPN after it casts to bf16), and no ``TRAINER.REMAT`` segment lies
inside it, as none lies inside the JAX one.

Submodules carry the Flax names (``hf.embedder.embedder.convolution``,
``hf.encoder.stages.<s>.layers.<l>.layer.layer_<i>`` in a basic layer,
``.layer.<i>`` in the others, ``.shortcut.convolution|normalization``, a Y
layer's ``.layer.2.attention.0|2``), so ``utils/weights.py`` maps a Flax
checkpoint by name; :func:`load_hf_weights` reads one from a local
``save_pretrained`` directory with the msgpack decoder below.
"""
from __future__ import annotations

import json
import math
import os
import struct
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision
from basedet_tpu_torch.layers.common.blocks import FlaxBatchNorm2d

# -- preset configs, as the JAX package names them ---------------------------
_RESNET_PRESETS = {
    # name: (embedding_size, hidden_sizes, depths, layer_type)
    "resnet18": (64, (64, 128, 256, 512), (2, 2, 2, 2), "basic"),
    "resnet34": (64, (64, 128, 256, 512), (3, 4, 6, 3), "basic"),
    "resnet50": (64, (256, 512, 1024, 2048), (3, 4, 6, 3), "bottleneck"),
    "resnet101": (64, (256, 512, 1024, 2048), (3, 4, 23, 3), "bottleneck"),
    "resnet152": (64, (256, 512, 1024, 2048), (3, 8, 36, 3), "bottleneck"),
}

_REGNET_PRESETS = {
    # name: (embedding_size, hidden_sizes, depths, groups_width, layer_type)
    "regnety_004": (32, (48, 104, 208, 440), (1, 3, 6, 6), 8, "y"),
    "regnety_016": (32, (48, 120, 336, 888), (2, 6, 17, 2), 24, "y"),
    "regnety_040": (32, (128, 192, 512, 1088), (2, 6, 12, 2), 64, "y"),
    "regnetx_016": (32, (72, 168, 408, 912), (2, 4, 10, 2), 24, "x"),
    "regnetx_040": (32, (80, 240, 560, 1360), (2, 5, 14, 2), 40, "x"),
}

# hidden_states layout of HF ResNet/RegNet with output_hidden_states=True:
# (embeddings, stage1, stage2, stage3, stage4) at strides (4, 4, 8, 16, 32).
_STAGE_INDEX = {"res2": 1, "res3": 2, "res4": 3, "res5": 4}

# the defaults of transformers' ResNetConfig and RegNetConfig, for a dict
# that leaves a field out (RegNetConfig always downsamples in its first stage)
_DEFAULTS = {
    "resnet": {"num_channels": 3, "embedding_size": 64, "hidden_sizes": [256, 512, 1024, 2048],
               "depths": [3, 4, 6, 3], "layer_type": "bottleneck", "hidden_act": "relu",
               "downsample_in_first_stage": False},
    "regnet": {"num_channels": 3, "embedding_size": 32, "hidden_sizes": [128, 192, 512, 1088],
               "depths": [2, 6, 12, 2], "groups_width": 64, "layer_type": "y", "hidden_act": "relu"},
}

# transformers' flax ACT2FN, the entries a conv net uses
_ACT = {
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


def hf_config(name_or_cfg: Union[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """The HF config's fields for a preset name or a ``config.json`` dict
    (``model_type`` ``resnet`` or ``regnet``), the config class's defaults
    filled in."""
    if isinstance(name_or_cfg, str):
        if name_or_cfg in _RESNET_PRESETS:
            emb, hidden, depths, layer_type = _RESNET_PRESETS[name_or_cfg]
            name_or_cfg = {"model_type": "resnet", "embedding_size": emb, "hidden_sizes": list(hidden),
                           "depths": list(depths), "layer_type": layer_type}
        elif name_or_cfg in _REGNET_PRESETS:
            emb, hidden, depths, gw, layer_type = _REGNET_PRESETS[name_or_cfg]
            name_or_cfg = {"model_type": "regnet", "embedding_size": emb, "hidden_sizes": list(hidden),
                           "depths": list(depths), "groups_width": gw, "layer_type": layer_type}
        else:
            raise ValueError(
                f"unknown hf backbone {name_or_cfg!r}; presets: "
                f"{sorted(_RESNET_PRESETS) + sorted(_REGNET_PRESETS)} "
                "(or pass a config.json dict and load_hf_weights of its directory)")
    family = name_or_cfg.get("model_type")
    if family not in _DEFAULTS:
        raise ValueError(f"unsupported hf model family {family!r}")
    cfg = {**_DEFAULTS[family], **{k: name_or_cfg[k] for k in _DEFAULTS[family] if k in name_or_cfg},
           "model_type": family}
    if family == "regnet":
        cfg["downsample_in_first_stage"] = True
    if cfg["hidden_act"] not in _ACT:
        raise ValueError(f"hidden_act {cfg['hidden_act']!r} is not one of {sorted(_ACT)}")
    return cfg


def get_feature_setting(name: str) -> Tuple[str, ...]:
    """Default FPN inputs."""
    return ("res3", "res4", "res5")


def get_channel_setting(name: str) -> Tuple[int, ...]:
    """Channels of ``get_feature_setting(name)``, from the preset's
    ``hidden_sizes``."""
    hs = tuple(hf_config(name)["hidden_sizes"])
    return tuple(hs[_STAGE_INDEX[f] - 1] for f in get_feature_setting(name))


def hf_feature_channels(name_or_cfg) -> Dict[str, int]:
    """{res2..res5: channels} of the adapter for a preset name or config dict."""
    hs = hf_config(name_or_cfg)["hidden_sizes"]
    return {f: int(hs[i - 1]) for f, i in _STAGE_INDEX.items()}


def auto_convert_cfg_to_hf(cfg, hf_backbone: str = "resnet50"):
    """Rewrite a detection config to use an HF-zoo backbone."""
    cfg.MODEL.BACKBONE.NAME = "hf_" + hf_backbone
    out_features = get_feature_setting(hf_backbone)
    out_channels = get_channel_setting(hf_backbone)
    cfg.MODEL.BACKBONE.OUT_FEATURES = list(out_features)
    cfg.MODEL.BACKBONE.OUT_FEATURE_CHANNELS = list(out_channels)
    if "FPN" in cfg.MODEL:
        cfg.MODEL.FPN.TOP_BLOCK_IN_FEATURE = out_features[-1]
        cfg.MODEL.FPN.TOP_BLOCK_IN_CHANNELS = out_channels[-1]
    return cfg


# -- the modules -------------------------------------------------------------
class _RunningStatsBatchNorm(FlaxBatchNorm2d):
    """A Flax RegNet layer's inner BN: running statistics in either mode, no
    update (its caller's ``deterministic`` defaults to True)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0,
                            self.eps)


def _bn(channels: int, running: bool, device) -> nn.Module:
    return (_RunningStatsBatchNorm if running else FlaxBatchNorm2d)(channels, eps=1e-5, momentum=0.1,
                                                                    device=device)


class _ConvLayer(nn.Module):
    """``FlaxResNetConvLayer`` / ``FlaxRegNetConvLayer``: conv (padding k // 2,
    no bias), BN, activation (none for a layer's last conv)."""

    def __init__(self, cin, cout, k=3, stride=1, groups=1, act: Optional[str] = "relu",
                 running=False, device=None):
        super().__init__()
        self.convolution = nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False, device=device)
        self.normalization = _bn(cout, running, device)
        self.act = _ACT[act] if act else None

    def forward(self, x):
        y = self.normalization(self.convolution(x))
        return self.act(y) if self.act is not None else y


class _ShortCut(nn.Module):
    """1x1 conv with the layer's stride (flax's default ``SAME`` padding: none
    at 1x1), BN."""

    def __init__(self, cin, cout, stride, device=None):
        super().__init__()
        self.convolution = nn.Conv2d(cin, cout, 1, stride, bias=False, device=device)
        self.normalization = _bn(cout, False, device)

    def forward(self, x):
        return self.normalization(self.convolution(x))


class _Chain(nn.Module):
    """Submodules under the given names, applied in order."""

    def __init__(self, named: Sequence[Tuple[str, nn.Module]]):
        super().__init__()
        self.order = [n for n, _ in named]
        for n, m in named:
            self.add_module(n, m)

    def forward(self, x):
        for n in self.order:
            x = getattr(self, n)(x)
        return x


class _SELayer(nn.Module):
    """``FlaxRegNetSELayer``: x · sigmoid(conv(relu(conv(mean over the plane))))."""

    def __init__(self, channels, reduced, device=None):
        super().__init__()
        self.attention = nn.Sequential(nn.Conv2d(channels, reduced, 1, device=device), nn.ReLU(),
                                       nn.Conv2d(reduced, channels, 1, device=device), nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x.mean((2, 3), keepdim=True))


class _Layer(nn.Module):
    """A residual layer: ``act(layer(x) + shortcut(x))``, the shortcut a
    projection where the width or the stride changes, else the identity."""

    def __init__(self, cfg, cin, cout, stride, device=None):
        super().__init__()
        act = cfg["hidden_act"]
        kind = cfg["layer_type"]
        self.shortcut = _ShortCut(cin, cout, stride, device) if cin != cout or stride != 1 else None
        if kind == "basic":  # a ResNet layer's inner activations are ReLU whatever hidden_act says
            named = [("layer_0", _ConvLayer(cin, cout, 3, stride, device=device)),
                     ("layer_1", _ConvLayer(cout, cout, 3, act=None, device=device))]
        elif kind == "bottleneck":
            mid = cout // 4
            named = [("0", _ConvLayer(cin, mid, 1, device=device)),
                     ("1", _ConvLayer(mid, mid, 3, stride, device=device)),
                     ("2", _ConvLayer(mid, cout, 1, act=None, device=device))]
        else:  # RegNet "x" or "y"
            groups = max(1, cout // cfg["groups_width"])
            named = [("0", _ConvLayer(cin, cout, 1, act=act, running=True, device=device)),
                     ("1", _ConvLayer(cout, cout, 3, stride, groups, act=act, running=True, device=device))]
            if kind == "y":
                named.append(("2", _SELayer(cout, int(round(cin / 4)), device)))
            named.append((str(len(named)), _ConvLayer(cout, cout, 1, act=None, running=True, device=device)))
        self.layer = _Chain(named)
        self.act = _ACT[act]

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        return self.act(self.layer(x) + residual)


class _Stage(nn.Module):
    def __init__(self, cfg, cin, cout, stride, depth, device=None):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg, cin if i == 0 else cout, cout, stride if i == 0 else 1, device)
                                     for i in range(depth)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _Encoder(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        widths = [cfg["embedding_size"], *cfg["hidden_sizes"]]
        first = 2 if cfg["downsample_in_first_stage"] else 1
        self.stages = nn.ModuleList([_Stage(cfg, widths[s], widths[s + 1], first if s == 0 else 2, depth, device)
                                     for s, depth in enumerate(cfg["depths"])])


class _Embeddings(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        resnet = cfg["model_type"] == "resnet"
        self.embedder = _ConvLayer(cfg["num_channels"], cfg["embedding_size"], 7 if resnet else 3, 2,
                                   act=cfg["hidden_act"], device=device)
        self.max_pool = resnet

    def forward(self, x):
        y = self.embedder(x)
        return F.max_pool2d(y, 3, 2, 1) if self.max_pool else y


class _HFModule(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.embedder = _Embeddings(cfg, device)
        self.encoder = _Encoder(cfg, device)


class HFBackboneAdapter(nn.Module):
    """An HF ResNet or RegNet as a detection backbone: NCHW image →
    ``{name: NCHW}`` for the ``out_features`` among res2..res5, at strides
    4/8/16/32. ``name_or_cfg`` is a preset name or a dict of the HF config's
    fields as ``config.json`` holds them. Every stage runs whatever
    ``out_features`` asks, as in the JAX adapter (whose train mode updates
    every stage's statistics)."""

    def __init__(self, name_or_cfg: Union[str, Mapping[str, Any]],
                 out_features: Sequence[str] = ("res3", "res4", "res5"), device=None):
        super().__init__()
        self.config = hf_config(name_or_cfg)
        self.out_features = tuple(out_features) or ("res3", "res4", "res5")
        unknown = [f for f in self.out_features if f not in _STAGE_INDEX]
        if unknown:
            raise ValueError(f"hf backbone features {unknown}: it has {sorted(_STAGE_INDEX)}")
        self.hf = _HFModule(self.config, device)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.shape[1] != self.config["num_channels"]:
            raise ValueError(f"image channels {x.shape[1]} != the config's num_channels "
                             f"{self.config['num_channels']}")
        with precision.precision_policy(None):
            y = self.hf.embedder(x.float())
            hidden = [y]
            for stage in self.hf.encoder.stages:
                y = stage(y)
                hidden.append(y)
        return {f: hidden[_STAGE_INDEX[f]] for f in self.out_features}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As the Flax modules draw them (normal in place of truncated normal):
        conv kernels variance_scaling(2.0, fan_out), SE biases zero, BN the
        identity."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


# -- local Flax checkpoints ----------------------------------------------------
def _bf16_to_f32(raw: bytes) -> np.ndarray:
    return (np.frombuffer(raw, np.uint16).astype(np.uint32) << 16).view(np.float32)


def _ndarray(payload: bytes) -> np.ndarray:
    """Flax's ndarray ext payload: a msgpack ``(shape, dtype name, bytes)``."""
    shape, dtype, raw = _MsgpackReader(payload).read()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    arr = _bf16_to_f32(raw) if dtype == "bfloat16" else np.frombuffer(raw, np.dtype(dtype))
    return arr.reshape(tuple(shape)).copy()


class _MsgpackReader:
    """A msgpack decoder (the subset Flax's ``to_bytes`` writes, and the rest
    of the format's scalars): maps, arrays, str, bin, ints, floats, bool,
    nil, and ext type 1 (an ndarray) or 3 (a numpy scalar)."""

    _FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i",
              0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
    _LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I",
            0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I", 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
    _FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self._take(b & 0x1f).decode()
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in self._FIXED:
            return self._unpack(self._FIXED[b])
        if b in self._FIXEXT:
            return self._ext(self._unpack(">b"), self._FIXEXT[b])
        if b not in self._LEN:
            raise ValueError(f"msgpack type byte {b:#x} is not decoded")
        n = self._unpack(self._LEN[b])
        if b in (0xc4, 0xc5, 0xc6):
            return self._take(n)
        if b in (0xd9, 0xda, 0xdb):
            return self._take(n).decode()
        if b in (0xdc, 0xdd):
            return [self.read() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self._map(n)
        return self._ext(self._unpack(">b"), n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("this checkpoint holds an array that Flax chunked past 2**30 bytes "
                             "(__msgpack_chunked_array__); load_hf_weights reads whole arrays only")
        return out

    def _ext(self, code: int, n: int):
        payload = self._take(n)
        if code == 1:
            return _ndarray(payload)
        if code == 3:
            return _ndarray(payload)[()]
        raise ValueError(f"msgpack ext type {code} is not decoded")


def read_flax_msgpack(path: str):
    """The tree that Flax's ``serialization.to_bytes`` wrote to ``path``,
    numpy leaves."""
    with open(path, "rb") as f:
        reader = _MsgpackReader(f.read())
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: {len(reader.data) - reader.pos} bytes after the msgpack object")
    return tree


def read_hf_config(path: str) -> Dict[str, Any]:
    """``config.json`` of a local ``from_pretrained`` directory, as a dict."""
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def load_hf_weights(path: str) -> Dict[str, torch.Tensor]:
    """Read a local Flax ``from_pretrained`` directory (``config.json`` and
    ``flax_model.msgpack``, which holds ``{"params", "batch_stats"}``) and
    return the ``state_dict`` of ``HFBackboneAdapter(read_hf_config(path))``,
    where the JAX function returns the same leaves nested under ``"hf"``."""
    from basedet_tpu_torch.utils.weights import state_dict_from_jax

    cfg = read_hf_config(path)
    tree = read_flax_msgpack(os.path.join(path, "flax_model.msgpack"))
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: flax_model.msgpack holds no params collection")
    variables = {coll: {"hf": leaves} for coll, leaves in tree.items()}
    reference = HFBackboneAdapter(cfg, device="meta").state_dict()
    return state_dict_from_jax(variables, reference=reference)
