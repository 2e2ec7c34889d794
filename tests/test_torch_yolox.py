"""The port's YOLOX (basedet_tpu_torch) against the JAX package on the CPU.

Tiny YOLOX-S (depth 0.33, width 0.25, 96² images). Weights come from the JAX
``init_variables`` tree with its BN statistics and affine and the head's
biases randomised (so that a swapped BN leaf or a wrong layout cannot hide),
converted to numpy and through ``utils/weights.py`` into the port. Inputs
come from numpy with a fixed seed.

Float tolerance: the two frameworks sum each convolution in their own order
(XLA:CPU vs oneDNN), which moves f32 results by a few ulps per layer; over
the whole network that stays well inside 1e-4 absolute at this size
(docs/PARITY.md:58-66 budgets ~1e-3 per stage across backends). Everything
downstream of the head outputs is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.layers.backbone.yolo_pafpn import YOLOPAFPN as JPAFPN
from basedet_tpu.layers.blocks.yolo_block import CSPLayer as JCSPLayer
from basedet_tpu.layers.blocks.yolo_block import Focus as JFocus
from basedet_tpu.layers.blocks.yolo_block import SPPBottleneck as JSPP
from basedet_tpu.utils import all_register
from basedet_tpu.utils.dummy import DummyLoader
from basedet_tpu_torch import build_model
from basedet_tpu_torch.utils.compare import match_detections
from basedet_tpu_torch.utils.weights import state_dict_from_jax
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

IMG = 96
HEAD_ATOL = 1e-4


def _randomise(variables, rng):
    """BN mean/var/scale/bias and the head's biases drawn from rng."""
    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "mean":
                v = rng.normal(0.0, 0.2, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 2.0, v.shape)
            elif k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias":
                v = v + rng.normal(0.0, 0.3, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(jax.device_get(variables), ())


@pytest.fixture(scope="module")
def yolox():
    all_register()
    cfg = shrink(C.YOLOXSConfig())
    jmodel = cfg.build_model()
    variables = _randomise(
        jmodel.init_variables(jax.random.PRNGKey(0), image_size=(IMG, IMG)),
        np.random.RandomState(0),
    )
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    batch = DummyLoader(batch_size=2, image_size=(IMG, IMG), max_instances=6).make_batch()
    batch = {k: batch[k] for k in ("data", "im_info")}
    batch["im_info"][1, 2:4] = (150, 120)  # second image rescales on the way out
    head = jax.jit(jmodel.make_module(train=False).apply)(variables, jnp.asarray(batch["data"]))
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, port=port, batch=batch,
                jhead=jax.device_get(head))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        node = variables[col]
        for p in path:
            node = node[p]
        out[col] = node
    return out


def _block_cases():
    rng = np.random.RandomState(1)
    n = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return {
        "focus": (("backbone", "stem"), JFocus(16, 3),
                  lambda m: m.backbone.stem, [rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)]),
        "csp": (("backbone", "dark3_csp"), JCSPLayer(64, n=3, shortcut=True),
                lambda m: m.backbone.dark3_csp, [n(2, 12, 12, 64)]),
        "spp": (("backbone", "dark5_spp"), JSPP(256),
                lambda m: m.backbone.dark5_spp, [n(2, 6, 6, 256)]),
        "pafpn": (("pafpn",), JPAFPN(depth=0.33, width=0.25),
                  lambda m: m.pafpn, [[n(2, 12, 12, 64), n(2, 6, 6, 128), n(2, 3, 3, 256)]]),
    }


@pytest.mark.parametrize("name", ["focus", "csp", "spp", "pafpn"])
def test_block_matches_jax(yolox, name):
    path, jmod, port_mod, args = _block_cases()[name]
    (x,) = args
    ref = jmod.apply(_sub(yolox["variables"], *path), x)
    with torch.no_grad():
        if isinstance(x, list):
            got = port_mod(yolox["port"].module)([_nchw(a) for a in x])
        else:
            got = port_mod(yolox["port"].module)(_nchw(x))
    refs = ref if isinstance(ref, list) else [ref]
    gots = got if isinstance(got, list) else [got]
    for r, g in zip(refs, gots):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), rtol=0, atol=HEAD_ATOL)


def test_yolox_module_head_outputs_match_jax(yolox):
    """Per-level cls logits, box offsets and objectness, f32."""
    port = yolox["port"]
    image = port.pre_process(yolox["batch"])["image"]
    with torch.no_grad():
        outs = port.module(image)
    for ref_l, got_l in zip(yolox["jhead"], outs):
        for r, g in zip(ref_l, got_l):
            assert g.shape[1:] == (r.shape[3], r.shape[1], r.shape[2])
            np.testing.assert_allclose(_nhwc(g), r, rtol=0, atol=HEAD_ATOL)


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_yolox_module_runs_f32_whatever_the_process_set(yolox):
    """TF32 is off inside the forward even where the process turned it on,
    and the process's settings are back after it."""
    port = yolox["port"]
    seen = []
    hook = port.module.backbone.register_forward_pre_hook(lambda *_: seen.append(_tf32_flags()))
    saved = _tf32_flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            port.module(port.pre_process(yolox["batch"])["image"])
        after = _tf32_flags()
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [(False, False)]
    assert after == (True, True)


def _jax_inference_from_head(jmodel, head, img_info):
    """JAX ``inference`` with its module output replaced by ``head``."""
    class _Fixed:
        def apply(self, variables, image):
            return head

    jmodel.make_module, orig = (lambda train: _Fixed()), jmodel.make_module
    try:
        return jax.device_get(jmodel.inference(None, {"data": np.zeros((2, IMG, IMG, 3), np.float32),
                                                     "im_info": img_info}))
    finally:
        jmodel.make_module = orig


def test_post_process_of_jax_head_outputs_is_exact(yolox):
    """The JAX head outputs through the port's decode, top-k, NMS and rescale
    give the JAX ``inference`` detections: same labels, validity and order;
    boxes and scores to the last ulp the transcendental functions allow."""
    jhead, port = yolox["jhead"], yolox["port"]
    img_info = yolox["batch"]["im_info"]
    ref = _jax_inference_from_head(yolox["jmodel"], jhead, img_info)
    got = port.post_process(*[[_nchw(x) for x in lv] for lv in jhead], torch.from_numpy(img_info))
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(got["box_labels"].numpy(), ref["box_labels"])
    np.testing.assert_allclose(got["box_scores"].numpy(), ref["box_scores"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"], rtol=1e-6, atol=1e-5)
    assert ref["valid"].sum() > 20


def test_yolox_inference_matches_jax(yolox):
    """The whole slice: port ``YOLOX.inference`` against JAX ``inference_jit``
    on a DummyLoader batch, matched one-to-one by label, IoU >= 0.999 and
    |Δscore| <= 1e-4. Candidates whose score order flips within the forward
    tolerance can change which box wins an NMS cluster or makes the top
    100, so at least 95% must match, not all."""
    ref = jax.device_get(yolox["jmodel"].inference_jit(yolox["variables"], yolox["batch"]))
    got = {k: v.numpy() for k, v in yolox["port"].inference(yolox["batch"]).items()}
    assert got["boxes"].shape == ref["boxes"].shape
    assert np.isfinite(got["boxes"]).all()
    assert ref["valid"].sum() > 20
    assert abs(int(got["valid"].sum()) - int(ref["valid"].sum())) <= 0.05 * ref["valid"].sum()
    assert match_detections(ref, got) >= 0.95
