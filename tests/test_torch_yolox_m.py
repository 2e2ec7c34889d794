"""YOLOX-M in the port (``basedet_tpu_torch/playground/yolox_m/config.py``):
its parameter tree maps one to one onto the JAX package's ``YOLOXMConfig``
tree through ``utils/weights.py``, shapes included, with the same parameter
count. The JAX tree's shapes come from ``jax.eval_shape``, so nothing
compiles and no full-width forward runs on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np

from basedet_tpu_torch import build_model
from basedet_tpu_torch.tools.misc import import_config
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.torch_threads import torch_threads  # noqa: F401

CONFIG = "basedet_tpu_torch/playground/yolox_m/config.py"


def test_yolox_m_tree_maps_onto_the_jax_tree():
    from basedet_tpu import configs as C
    from basedet_tpu.utils import all_register

    cfg = import_config(CONFIG)
    jcfg = C.YOLOXMConfig()
    assert (cfg.MODEL.DEPTH_FACTOR, cfg.MODEL.WIDTH_FACTOR) == (jcfg.MODEL.DEPTH_FACTOR, jcfg.MODEL.WIDTH_FACTOR) \
        == (0.67, 0.75)
    all_register()
    module = jcfg.build_model().make_module(train=False)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = build_model(cfg, "cpu").module
    reference = port.state_dict()
    mapped = state_dict_from_jax(tree, reference)  # raises on a missing or extra key or another shape
    assert mapped.keys() == reference.keys()
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == n_jax > 25_000_000
    back = jax_from_state_dict(reference)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    assert reference["backbone.dark5_csp.conv3.conv.weight"].shape[0] == 768  # the fused backward's streamed w
