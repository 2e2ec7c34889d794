"""Weights from the seed, drawn on the device in one normal and one uniform
call, each leaf cut from them and shaped by its reference's ``init_spec``.
The same tensors go into the port's module (through the reference's
``port_name``) and into the reference."""
from __future__ import annotations

from typing import Callable, Dict

import torch


def make_weights(shapes: Dict[str, tuple], dtypes: Dict[str, torch.dtype], init_spec: Callable, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every entry of ``shapes``, drawn from ``seed``: the
    normal leaves from one ``randn``, the uniform ones from one ``rand``, in
    name order."""
    names = sorted(shapes)
    specs = {n: init_spec(n, shapes[n]) for n in names}
    count = lambda kind: sum(_numel(shapes[n]) for n in names if specs[n][0] == kind)  # noqa: E731
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pools = {"normal": torch.randn(count("normal"), generator=gen, device=device),
             "uniform": torch.rand(count("uniform"), generator=gen, device=device)}
    offsets = {"normal": 0, "uniform": 0}
    out = {}
    for n in names:
        kind, a, b = (*specs[n], None)[:3]
        shape, size = shapes[n], _numel(shapes[n])
        if kind == "const":
            out[n] = torch.full(shape, a, dtype=dtypes[n], device=device)
            continue
        x = pools[kind][offsets[kind]:offsets[kind] + size].view(shape)
        offsets[kind] += size
        if kind == "normal":
            shift = torch.tensor(b, dtype=torch.float32, device=device)
            if shift.dim():  # a pattern repeated over the leaf's last axis
                shift = shift.repeat(size // shift.numel()).view(shape)
            out[n] = (x * a + shift).to(dtypes[n])
        else:
            out[n] = (a + (b - a) * x).to(dtypes[n])
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def to_port(weights: Dict[str, torch.Tensor], ref_module, port_state_keys) -> Dict[str, torch.Tensor]:
    """The weights under the port's names; the two key sets must agree."""
    mapped = {ref_module.port_name(k): v for k, v in weights.items()}
    missing, extra = set(port_state_keys) - set(mapped), set(mapped) - set(port_state_keys)
    if missing or extra:
        raise KeyError(f"name map mismatch: the port has {sorted(missing)[:5]} unmapped, "
                       f"the reference {sorted(extra)[:5]} unknown to the port")
    return mapped
