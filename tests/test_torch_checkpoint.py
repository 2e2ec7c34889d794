"""Checkpoint loading by matching in the port (``utils/checkpoint.py``,
``utils/convert_weights.py``, ``utils/reference_layout.py``) against the JAX
package's, on the CPU:

  * the matcher's rules (exact, unique suffix, unique size among the suffix
    hits, reshape of an equal size, strict) give the JAX package's stats on
    the same flat state;
  * the reference-layout RetinaNet R50 state converts to the tensors the
    JAX converter gives, every leaf matched and nothing unused (as
    tests/structures/test_reference_checkpoint.py requires of the JAX
    package);
  * a backbone-only R50 state in the ImageNet naming loads into FCOS R50
    with the JAX package's matched/missing/unused counts, the trunk's
    values in place and the FPN and head at their init, through
    ``BaseNet.load_weights`` of a pickle too;
  * ``det_test`` reads a non-training pickle (a JAX variable tree without
    the head) through the matcher; a training checkpoint still loads
    exactly.
The JAX side takes its variable tree's shapes from ``jax.eval_shape``: no
R50 is compiled here.
"""
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.utils import all_register
from basedet_tpu.utils.checkpoint import flatten_tree
from basedet_tpu.utils.checkpoint import load_matched_weights as jmatch
from basedet_tpu.utils.convert_weights import load_reference_checkpoint as jload
from basedet_tpu_torch import build_model
from basedet_tpu_torch import configs as P
from basedet_tpu_torch.models.base_net import BaseNet
from basedet_tpu_torch.utils import reference_layout
from basedet_tpu_torch.utils.checkpoint import load_matched_weights, unwarp_ckpt
from basedet_tpu_torch.utils.convert_weights import convert_reference_detector_state
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.torch_threads import torch_threads  # noqa: F401

FCOS_CONFIG = "basedet_tpu_torch/playground/fcos_r50_1x/config.py"


def jax_shapes(cfg):
    """The JAX model's variable tree, leaves as ShapeDtypeStructs."""
    all_register()
    module = cfg.build_model().make_module(train=False)
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))


def test_matcher_rules_give_the_jax_stats():
    target = {"a.conv1.weight": torch.zeros(4, 2, 1, 1), "a.layer1_0.conv1.weight": torch.zeros(4, 4, 1, 1),
              "b.bn.weight": torch.zeros(3), "b.gn.weight": torch.zeros(6), "c.fc.weight": torch.zeros(2, 5),
              "d.extra.bias": torch.zeros(7)}
    state = {"conv1.weight": np.ones((4, 2, 1, 1), np.float32),  # suffix of the first target
             "layer1_0.conv1.weight": np.full((4, 4, 1, 1), 2.0, np.float32),
             "b.bn.weight": np.full((1, 3, 1, 1), 3.0, np.float32),  # exact name, reshaped
             "gn.weight": np.full(6, 4.0, np.float32), "n.weight": np.full(5, 4.0, np.float32),  # by size
             "c.fc.weight": np.zeros((3, 5), np.float32),  # another size: kept at init
             "unused.thing": np.zeros(1, np.float32)}
    got, stats = load_matched_weights(target, state)
    jtarget = {"/".join(k.split(".")): np.asarray(v) for k, v in target.items()}
    _, jstats = jmatch(jtarget, {"/".join(k.split(".")): v for k, v in state.items()}, return_stats=True)
    assert stats["matched"] == jstats["matched"] == 4
    assert [m.replace(".", "/") for m in stats["missing"]] == jstats["missing"]
    assert [u.replace(".", "/") for u in stats["unused"]] == jstats["unused"]
    assert float(got["a.conv1.weight"].sum()) == 8.0 and float(got["a.layer1_0.conv1.weight"][0, 0]) == 2.0
    assert tuple(got["b.bn.weight"].shape) == (3,) and float(got["b.gn.weight"][0]) == 4.0
    assert float(got["c.fc.weight"].abs().sum()) == 0.0
    with pytest.raises(KeyError):
        load_matched_weights(target, state, strict=True)
    assert unwarp_ckpt({"state_dict": state, "epoch": 3}) is state


def test_reference_layout_is_the_jax_packages():
    from basedet_tpu.utils.reference_layout import reference_retinanet_r50_state as jstate

    want, got = jstate(), reference_layout.reference_retinanet_r50_state()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reference_retinanet_state_converts_as_the_jax_converter():
    state = reference_layout.reference_retinanet_r50_state()
    jtree, jstats = jload(jax_shapes(C.RetinaNetConfig()), state, strict=True, detector_naming=True,
                          return_stats=True)
    model = build_model(P.RetinaNetConfig(), "cpu")
    sd, stats = load_matched_weights(model.module.state_dict(), convert_reference_detector_state(state),
                                     strict=True)
    assert stats["missing"] == jstats["missing"] == [] and stats["unused"] == jstats["unused"] == []
    assert stats["matched"] == jstats["matched"] == len(flatten_tree(jtree)) == len(sd)
    want = state_dict_from_jax(jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), jtree))
    assert set(want) - set(sd) == set()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    model.module.load_state_dict(sd)


@pytest.fixture(scope="module")
def backbone_only(tmp_path_factory):
    state = reference_layout.reference_r50_backbone_state()
    _, jstats = jload(jax_shapes(C.FCOSConfig()), state, detector_naming=True, return_stats=True)
    path = tmp_path_factory.mktemp("weights") / "r50_imagenet.pkl"
    with open(path, "wb") as f:
        pickle.dump(state, f)
    return state, jstats, str(path)


def test_backbone_only_state_loads_into_fcos_with_the_jax_counts(backbone_only):
    state, jstats, _ = backbone_only
    model = build_model(P.FCOSConfig(), "cpu")
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    sd, stats = load_matched_weights(init, convert_reference_detector_state(state))
    assert (stats["matched"], len(stats["missing"]), len(stats["unused"])) == \
        (jstats["matched"], len(jstats["missing"]), len(jstats["unused"]))
    assert stats["matched"] == sum(k.startswith("bottom_up.") for k in sd) == 265  # R50: 5 + 16 x 15 + 4 x 5
    assert all(k.startswith(("fpn.", "head.")) for k in stats["missing"])
    assert stats["unused"] == ["fc.weight", "fc.bias"]
    assert float(sd["bottom_up.layer2_1.FrozenBatchNorm_1.running_mean"][0]) == \
        float(state["layer2.1.bn2.running_mean"].reshape(-1)[0])
    assert torch.equal(sd["bottom_up.layer3_0.downsample_conv.weight"],
                       torch.from_numpy(state["layer3.0.downsample.0.weight"]))
    for k in stats["missing"]:
        assert torch.equal(sd[k], init[k]), k


def test_load_weights_reads_a_backbone_only_pickle(backbone_only):
    state, jstats, path = backbone_only
    model = build_model(P.FCOSConfig(), "cpu")
    head = model.module.head.cls_score.bias.detach().clone()
    stats = model.load_weights(path)
    assert stats["matched"] == jstats["matched"] and len(stats["missing"]) == len(jstats["missing"])
    assert torch.equal(model.module.bottom_up.conv1.weight.detach(), torch.from_numpy(state["conv1.weight"]))
    assert torch.equal(model.module.head.cls_score.bias.detach(), head)
    wrapped = path.replace(".pkl", "_wrapped.pkl")  # {state_dict: ..., epoch: ...}, unwrapped first
    with open(wrapped, "wb") as f:
        pickle.dump({"state_dict": state, "epoch": 90}, f)
    assert model.load_weights(wrapped) == stats


TINY = ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.FPN.OUT_CHANNELS", "64", "MODEL.HEAD.NUM_CONVS", "1",
        "DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", "(128,192)", "TEST.CLS_THRESHOLD", "0.0"]


def test_det_test_reads_a_non_training_pickle_by_matching(tmp_path, monkeypatch):
    """A numpy JAX variable tree of tiny FCOS without its head: det_test loads
    the rest and keeps the head's init (before the matcher, the exact key
    check refused it)."""
    from basedet_tpu_torch.tools import det_test, import_config

    cfg = import_config(FCOS_CONFIG)
    cfg.merge(TINY)
    tree = jax_from_state_dict(build_model(cfg, "cpu", torch.Generator().manual_seed(5)).module.state_dict())
    del tree["params"]["head"]
    with open(tmp_path / "no_head.pkl", "wb") as f:
        pickle.dump(tree, f)
    seen = []
    load = BaseNet.load_weights
    monkeypatch.setattr(BaseNet, "load_weights", lambda self, *a, **k: seen.append(load(self, *a, **k)))
    results = det_test.main(["-f", FCOS_CONFIG, "-w", str(tmp_path / "no_head.pkl"), "--device", "cpu", *TINY,
                             "GLOBAL.OUTPUT_DIR", str(tmp_path)])
    assert results["num_detections"] > 0
    records = json.loads((tmp_path / "predict_coco.json").read_text())
    assert len(records) == results["num_detections"]
    (stats,) = seen
    assert stats["unused"] == [] and stats["missing"] and all(k.startswith("head.") for k in stats["missing"])


def test_a_training_checkpoint_still_loads_exactly(tmp_path):
    cfg = P.FCOSConfig()
    cfg.merge(TINY)
    model = build_model(cfg, "cpu")
    sd = model.module.state_dict()
    del sd["head.scales"]
    torch.save({"model": sd, "optimizer": {}, "ema": None, "step": 1, "progress": {}}, tmp_path / "latest.pt")
    with pytest.raises(RuntimeError, match="head.scales"):
        model.load_weights(str(tmp_path / "latest.pt"))
