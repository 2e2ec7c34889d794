"""The ``GN`` norm, the FPN with a norm and the Darknet backbone names of the
port against the JAX package on the CPU.

- ``get_norm("GN")`` against flax's ``nn.GroupNorm(32, epsilon=1e-5)``
  (``basedet_tpu/layers/common/blocks.py:77-80``), in f32 and under the
  bf16 policy; ``SyncBN`` builds the one train-mode BN (its statistics cross
  ranks under a process group, ``tests/test_torch_parallel.py``).
- The FPN with ``GN``, ``BN`` (train mode, running statistics too) and
  ``FrozenBN`` on its lateral and output convs, without their bias
  (``basedet_tpu/layers/backbone/fpn.py:52-53``), its weights carried from
  the JAX tree by ``utils/weights.py`` both ways.
- ``make_backbone`` by ``darknet21`` and ``csp_darknet``
  (``basedet_tpu/layers/backbone/build.py:50-60``).

Tolerances: f32 outputs to 1e-4 of the largest magnitude (each convolution
sums in its own order, and flax's GroupNorm takes E[x²] - E[x]² where torch
takes a two-pass variance); bf16 outputs within 2 bf16 ulps of it; the BN
running statistics to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu_torch.layers import precision
from basedet_tpu_torch.layers.backbone.build import make_backbone
from basedet_tpu_torch.layers.backbone.fpn import FPN
from basedet_tpu_torch.layers.common.blocks import FlaxBatchNorm2d, FlaxGroupNorm, get_norm
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.torch_threads import torch_threads  # noqa: F401


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), f"off by {err:.3e} of {float(np.abs(want).max()):.3e}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_group_norm_matches_flax(dtype):
    from basedet_tpu.layers.common.blocks import get_norm as jget_norm
    from basedet_tpu.layers.precision import precision_policy as jax_policy

    rng = np.random.RandomState(0)
    x = (rng.randn(2, 6, 5, 64) * 3 + 1).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 64).astype(np.float32), rng.normal(0, 0.3, 64).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    with jax_policy(jdt):
        gn = jget_norm("GN")()
        xj = jnp.asarray(x, jdt or jnp.float32)
        ref = gn.apply({"params": {"scale": scale, "bias": bias}}, xj)
    port = get_norm("GN")(64)
    assert isinstance(port, FlaxGroupNorm) and port.num_groups == 32 and port.eps == 1e-5
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale)), port.bias.copy_(torch.from_numpy(bias))
    xt = _nchw(np.asarray(xj.astype(jnp.float32)))
    with precision.precision_policy(torch.bfloat16 if dtype == "bf16" else None), torch.no_grad():
        got = port(xt.bfloat16() if dtype == "bf16" else xt)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert ref.dtype == (jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    _close(got.float().numpy().transpose(0, 2, 3, 1), ref.astype(jnp.float32),
           2 * 2.0 ** -8 if dtype == "bf16" else 1e-5)


def test_sync_bn_is_the_train_mode_bn():
    for name in ("BN", "SyncBN"):
        bn = get_norm(name)(8)
        assert type(bn) is FlaxBatchNorm2d and bn.eps == 1e-5 and bn.momentum == 0.1


def _jax_fpn(norm, train):
    from basedet_tpu.layers.backbone.fpn import FPN as JFPN

    return JFPN(in_features=("res3", "res4", "res5"), strides=(8, 16, 32), out_channels=64, norm=norm,
                top_block="p6p7", top_block_in_feature="res5", train=train)


@pytest.mark.parametrize("norm", ["GN", "BN", "FrozenBN"])
def test_fpn_with_norm_matches_jax(norm):
    rng = np.random.RandomState(1)
    channels = {"res3": 32, "res4": 48, "res5": 64}
    sizes = {"res3": 16, "res4": 8, "res5": 4}
    feats = {k: (rng.randn(2, sizes[k], sizes[k], c) * 2).astype(np.float32) for k, c in channels.items()}
    train = norm == "BN"
    jfpn = _jax_fpn(norm, train)
    variables = jax.device_get(jfpn.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()}))
    variables = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(0, 0.1, np.shape(v))).astype(np.float32), variables)
    if train:
        ref, new = jfpn.apply(variables, {k: jnp.asarray(v) for k, v in feats.items()}, mutable=["batch_stats"])
    else:
        ref, new = jfpn.apply(variables, {k: jnp.asarray(v) for k, v in feats.items()}), None
    port = FPN(("res3", "res4", "res5"), [32, 48, 64], (8, 16, 32), 64, norm=norm, top_block="p6p7")
    sd = state_dict_from_jax(variables, port.state_dict())
    port.load_state_dict(sd)
    assert all(port.get_submodule(f"fpn_{k}_res3").bias is None for k in ("lateral", "output"))
    back = jax_from_state_dict(port.state_dict())
    np.testing.assert_equal(jax.tree_util.tree_map(np.asarray, back), jax.tree_util.tree_map(np.asarray, variables))
    port.train(train)
    with torch.no_grad():
        got = port({k: _nchw(v) for k, v in feats.items()})
    assert sorted(got) == sorted(ref) == ["p3", "p4", "p5", "p6", "p7"]
    for k in ref:
        _close(got[k].numpy().transpose(0, 2, 3, 1), ref[k], 1e-4)
    if train:
        back = jax_from_state_dict(port.state_dict())
        for mod, stats in new["batch_stats"].items():
            for leaf in ("mean", "var"):
                np.testing.assert_allclose(back["batch_stats"][mod][leaf], np.asarray(stats[leaf]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,features", [("darknet21", ("dark3", "dark4", "dark5")),
                                           ("csp_darknet", ("dark3", "dark4", "dark5"))])
def test_make_backbone_by_darknet_names_matches_jax(name, features):
    from basedet_tpu.layers.backbone.build import make_backbone as jmake_backbone

    rng = np.random.RandomState(2)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jmod = jmake_backbone(name, features, train=False)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = jmod.apply(variables, jnp.asarray(x))
    port = make_backbone(name, features)
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x))
    assert sorted(got) == sorted(ref) == sorted(features)
    for k in features:
        _close(got[k].numpy().transpose(0, 2, 3, 1), ref[k], 1e-4)
