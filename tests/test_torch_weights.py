"""The weight bridge (basedet_tpu_torch/utils/weights.py) between the JAX
variable tree and the port's state_dict, at tiny YOLOX-S."""
import pickle

import jax
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.utils import all_register
from basedet_tpu_torch import build_model
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def trees():
    all_register()
    cfg = shrink(C.YOLOXSConfig())
    variables = jax.device_get(cfg.build_model().init_variables(jax.random.PRNGKey(0),
                                                                image_size=(64, 64)))
    rng = np.random.RandomState(0)
    # distinct values in every leaf, so any swap of leaves shows
    variables = jax.tree_util.tree_map(
        lambda v: rng.normal(size=np.shape(v)).astype(np.float32), variables)
    return cfg, variables


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_round_trip_is_exact(trees):
    cfg, variables = trees
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    back = _leaves(jax_from_state_dict(port.module.state_dict()))
    ref = _leaves(variables)
    assert back.keys() == ref.keys()
    for k in ref:
        assert back[k].dtype == ref[k].dtype and back[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_every_leaf_used_once(trees):
    cfg, variables = trees
    sd = state_dict_from_jax(variables)
    model_keys = set(build_model(cfg, "cpu").module.state_dict())
    assert set(sd) == model_keys
    real = [k for k in sd if not k.endswith("num_batches_tracked")]
    assert len(real) == len(_leaves(variables))
    # every value appears exactly where its leaf went: all leaves are distinct
    sums = sorted(float(np.abs(v).sum()) for v in _leaves(variables).values())
    assert sorted(float(sd[k].abs().sum()) for k in real) == pytest.approx(sums, rel=1e-6)


def test_kernel_layouts(trees):
    _, variables = trees
    sd = state_dict_from_jax(variables)
    hwio = variables["params"]["backbone"]["stem"]["conv"]["conv"]["kernel"]
    assert hwio.shape == (3, 3, 12, 16)
    assert tuple(sd["backbone.stem.conv.conv.weight"].shape) == (16, 12, 3, 3)
    np.testing.assert_array_equal(sd["backbone.stem.conv.conv.weight"][5, 7].numpy(),
                                  hwio[:, :, 7, 5])
    assert torch.equal(sd["backbone.stem.conv.bn.running_var"],
                       torch.from_numpy(variables["batch_stats"]["backbone"]["stem"]["conv"]
                                        ["BatchNorm_0"]["var"]))


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_key_mismatch_raises(trees, change):
    cfg, variables = trees
    variables = jax.tree_util.tree_map(lambda v: v, variables)
    if change == "missing":
        del variables["params"]["head"]["obj_pred_2"]["bias"]
    else:
        variables["params"]["head"]["obj_pred_3"] = {"bias": np.zeros(1, np.float32)}
    port = build_model(cfg, "cpu")
    with pytest.raises(KeyError):
        state_dict_from_jax(variables, port.module.state_dict())


def test_load_weights_reads_a_numpy_jax_pickle_and_a_torch_state_dict(trees, tmp_path):
    cfg, variables = trees
    port = build_model(cfg, "cpu")
    with open(tmp_path / "jax.pkl", "wb") as f:
        pickle.dump(variables, f)
    port.load_weights(str(tmp_path / "jax.pkl"))
    torch.save(port.module.state_dict(), tmp_path / "port.pt")
    other = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    other.load_weights(str(tmp_path / "port.pt"))
    for k, v in port.module.state_dict().items():
        assert torch.equal(v, other.module.state_dict()[k]), k


@pytest.mark.parametrize("share", [True, False], ids=["shared head", "per-level head"])
def test_retinanet_round_trip(share):
    """Tiny RetinaNet: the FPN's ``fpn_p6``/``fpn_p7`` and the head in both
    ``share_param`` forms map HWIO → OIHW and back, every leaf once."""
    all_register()
    cfg = shrink(C.RetinaNetConfig())
    cfg.MODEL.HEAD.SHARE_PARAM = share
    variables = jax.device_get(cfg.build_model().init_variables(jax.random.PRNGKey(0), image_size=(64, 64)))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(lambda v: rng.normal(size=np.shape(v)).astype(np.float32), variables)
    port = build_model(cfg, "cpu")
    sd = state_dict_from_jax(variables, port.module.state_dict())
    port.module.load_state_dict(sd)
    assert len(sd) == len(_leaves(variables)) == len(port.module.state_dict())
    head = {k.split(".")[1] for k in sd if k.startswith("head.")}
    per_level = {name for lv in range(5) for name in (f"cls_subnet_l{lv}_0", f"bbox_subnet_l{lv}_0",
                                                      f"cls_score_l{lv}", f"bbox_pred_l{lv}")}
    assert head == ({"cls_subnet_0", "bbox_subnet_0", "cls_score", "bbox_pred"} if share else per_level)
    p6 = variables["params"]["fpn"]["fpn_p6"]["kernel"]
    np.testing.assert_array_equal(sd["fpn.fpn_p6.weight"].numpy(), p6.transpose(3, 2, 0, 1))
    back = _leaves(jax_from_state_dict(port.module.state_dict()))
    ref = _leaves(variables)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
