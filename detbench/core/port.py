"""What the benchmark takes from the port: its configuration object, built
from a configuration file's values, its model with the seed's weights, and
its train step."""
from __future__ import annotations

import gc
from typing import Dict

import torch

from core import manifest
from core.weights import make_weights, to_port


def port_config(config: Dict, batch: int, amp: bool, seed: int):
    """The port's config class that the file names, with each of the file's
    values written to the port's key that ``port.keys`` maps it to (a file
    key with dots names a value inside a group: ``solver.warmup_iters``)."""
    from basedet_tpu_torch import configs as C

    cfg = getattr(C, config["port"]["config_class"])()
    for key, path in config["port"]["keys"].items():
        value = config
        for k in key.split("."):
            value = value[k]
        *parents, leaf = path.split(".")
        node = cfg
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
    cfg.MODEL.BATCHSIZE = batch
    cfg.TRAINER.AMP.ENABLE = bool(amp)
    cfg.SEED = int(seed)
    return cfg


def reference_shapes(config: Dict):
    """The reference model built on the meta device (no memory, no compute)."""
    ref_mod = manifest.reference_module(config)
    with torch.device("meta"):
        ref = ref_mod.build(config)
    return ref_mod, ref


def seeded_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights under the reference's names."""
    ref_mod, ref = reference_shapes(config)
    sd = ref.state_dict()
    return make_weights({k: tuple(v.shape) for k, v in sd.items()}, {k: v.dtype for k, v in sd.items()},
                        ref_mod.init_spec, seed, device)


def build_port_model(config: Dict, cfg, seed: int, device):
    """The port's model for ``cfg`` with the seed's weights loaded."""
    from basedet_tpu_torch.utils.registry import build_model

    model = build_model(cfg, device)
    ref_mod = manifest.reference_module(config)
    weights = to_port(seeded_weights(config, seed, device), ref_mod, model.module.state_dict().keys())
    model.module.load_state_dict(weights, strict=True)
    del weights
    return model


def build_reference(config: Dict, weights: Dict[str, torch.Tensor], device):
    """The reference model on ``device`` with ``weights`` (the seed's,
    under the reference's names) copied in."""
    ref_mod, ref = reference_shapes(config)
    ref = ref.to_empty(device=device)
    ref.load_state_dict(weights, strict=True)
    return ref_mod, ref


def flops_per_image(config: Dict, batch: int, image_hw, train: bool) -> float:
    """Convolution and matrix-product FLOPs an image, counted by
    ``FlopCounterMode`` on the reference at these shapes on the meta device:
    the forward, and for a train step its backward too."""
    from torch.utils.flop_counter import FlopCounterMode

    ref_mod, ref = reference_shapes(config)
    ref.train(train)
    with FlopCounterMode(display=False) as counter:
        out = ref_mod.flop_graph(ref, batch, tuple(image_hw), train)
        if train:
            out.backward()
    return counter.get_total_flops() / batch


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
