"""The bf16 compute policy (``TRAINER.AMP``, ``--amp``) of the port's nine
other families against the JAX package's ``precision_policy(bf16)`` on the
CPU, on the same weights (``utils/weights.py``) and the same numpy-seeded
batch, at the ``tests/tiny.py`` sizes.

The dtype flow: every stage that both packages name alike (a flax module's
output read through ``capture_intermediates``, the port's module of the same
name through a forward hook) gives the same dtypes: bf16 where the JAX layer
has the policy's ``dtype=``, f32 where it promotes (FCOS's ``GroupNorm``,
YOLOv3's ``_pred`` conv, DETR's ``input_proj`` and transformer).

The yardstick of ``tests/test_torch_amp.py``, per family, since bf16 moves
any model's outputs by its own rounding:
  * the head outputs (the leaves of the named head, all elements together):
    their mean |port bf16 - JAX bf16| at most 1.5 times the mean |JAX bf16 -
    f32|, the JAX package's own bf16-against-f32 deviation (the f32 side is
    the port's f32 run, which the families' own test files hold to the JAX
    package's f32 within 1e-5-1e-3);
  * each loss within 10% of the JAX package's bf16 loss, the gradient norm
    within 15%;
  * the gradient's cosine with the JAX package's bf16 gradient at least half
    the cosine of the JAX package's bf16 gradient with the f32 one, which
    must itself be at least 0.5: a setup where bf16 does not track f32 would
    make the check empty.
CenterNet runs in train mode at batch 2 from its config's initialisation
(the heatmap's focal-loss prior bias, bilinear deconvolutions, BN at
identity) with only the DCN offset branches random, so that taps are
fractional and some fall off the map. Its own test file's spread BN
affines, biases and deconvolutions make tiny CenterNet chaotic under bf16
(measured: the JAX package's bf16 gradient has a cosine of 0.08 with its f32
one, the center-offset loss moves 31% between the two packages' bf16 runs),
and no yardstick can tell a right bf16 step from a wrong one there.
ATSS, OTA and FreeAnchor share FCOS's and RetinaNet's layers: each takes one
``--amp`` train step (``make_train_step``) with finite losses.

One run per family, shared by its tests: a compiled bf16 loss-and-gradient
program and a compiled bf16 forward with its intermediates, on weights made
by the port's initialisation, converted to the JAX tree and randomised as the
family's own test file randomises them (CenterNet as said above).
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from basedet_tpu_torch import build_model
from basedet_tpu_torch.layers import precision
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_amp import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.test_torch_yolox_train import flat
from tests.torch_threads import torch_threads  # noqa: F401


def _pair(port_cfg, randomise, num_heads=None):
    """The port on ``port_cfg`` and its variables as a JAX tree, randomised
    and loaded back: the JAX package's initialisation (minutes of eager flax
    at these sizes) is not needed, only its tree."""
    port = build_model(port_cfg, "cpu")
    kw = {"num_heads": num_heads} if num_heads else {}
    variables = randomise(jax_from_state_dict(port.module.state_dict(), **kw))
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    return variables, port


def _frcnn():
    import jax

    from tests import test_torch_faster_rcnn_train as T

    cfg = T.tiny_cfg()
    jmodel = cfg.build_model()
    variables, port = _pair(cfg, lambda v: T._randomise(v, np.random.RandomState(0)))
    batch = T.make_batch()
    rng = jax.random.PRNGKey(11)
    image = jmodel.pre_process(batch, train=False)
    return SimpleNamespace(
        jmodel=jmodel, variables=variables, port=port, batch=batch, head=("rpn",), train_apply=False,
        jax_loss=lambda v: jmodel.get_losses(v, batch, rng)[:2],
        jax_apply=lambda v, **kw: jmodel.make_module(train=False).apply(v, image["image"], image["img_info"], **kw),
        port_apply=lambda p: p.module(*(lambda x: (x["image"], x["img_info"]))(p.pre_process(batch))),
        port_loss=lambda p: p.get_losses(batch, noise=T.port_noise(p, rng)))


def _retinanet():
    from tests import test_torch_retinanet as T

    cfg = T.tiny_cfg()
    variables, port = _pair(cfg, lambda v: T.randomise(v, np.random.RandomState(0)))
    return _one_stage(cfg.build_model(), variables, port, T.make_batch(), ("head",))


def _fcos():
    from tests import test_torch_fcos as T

    jcfg, pcfg = T.tiny_cfgs("FCOSConfig")
    variables, port = _pair(pcfg, lambda v: T.randomise(v, np.random.RandomState(0)))
    return _one_stage(jcfg.build_model(), variables, port, T.make_batch(), ("head",))


def _random_offsets(variables, rng):
    """The DCN offset branches (zero at init) drawn from rng: a bias of
    std 0.5 cells, a kernel of std 0.5 / sqrt(fan-in); the rest as it was."""
    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif "conv_offset" in path:
                std = 0.5 if k == "bias" else 0.5 / math.sqrt(np.prod(np.shape(v)[:-1]))
                out[k] = rng.normal(0.0, std, np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(variables, ())


def _centernet():
    from tests import test_torch_centernet as T

    cfg = T.tiny_cfg()
    variables, port = _pair(cfg, lambda v: _random_offsets(v, np.random.RandomState(0)))
    return _one_stage(cfg.build_model(), variables, port, T.make_batch(), ("head",), train_apply=True)


def _yolov3():
    from basedet_tpu import configs as C
    from tests import test_torch_yolov3 as T

    jcfg = C.YOLOv3Config()
    jcfg.DATA.MAX_INSTANCES = T.MAX_INST
    variables, port = _pair(T.tiny_cfg(),
                            lambda v: T.spread(v, np.random.RandomState(0), pred_scale=0.05))
    return _one_stage(T._TinyYOLOv3(jcfg), variables, port, T.make_batch(), ("fpn",), train_apply=True)


def _detr():
    from basedet_tpu import configs as C
    from basedet_tpu_torch.configs import DETRConfig
    from tests import test_torch_detr as T

    jmodel = T._shrink(C.DETRConfig()).build_model()
    variables, port = _pair(T._shrink(DETRConfig()),
                            lambda v: {**v, "params": T.noisy(v["params"], np.random.RandomState(0), 0.05)},
                            num_heads=T.H)
    batch = T.make_batch()
    inputs = jmodel._prepare(batch, train=True)
    return SimpleNamespace(
        jmodel=jmodel, variables=variables, port=port, batch=batch, head=("class_embed", "bbox_embed"),
        train_apply=False, num_heads=T.H, jax_loss=lambda v: jmodel.get_losses(v, batch)[:2],
        jax_apply=lambda v, **kw: jmodel.make_module(train=True).apply(v, inputs["image"], inputs["mask"], **kw),
        port_apply=lambda p: p.module(*(lambda x: (x["image"], x["mask"]))(p.prepare(batch, train=True))),
        port_loss=lambda p: p.get_losses(batch))


def _one_stage(jmodel, variables, port, batch, head, train_apply=False):
    """A family whose module takes the image alone."""
    image = jmodel.pre_process(batch, train=train_apply)["image"]

    def jax_apply(v, **kw):
        module = jmodel.make_module(train=train_apply)
        if train_apply:
            return module.apply(v, image, mutable=["batch_stats", *kw.pop("mutable", [])], **kw)
        return module.apply(v, image, **kw)

    return SimpleNamespace(
        jmodel=jmodel, variables=variables, port=port, batch=batch, head=head, train_apply=train_apply,
        jax_loss=lambda v: jmodel.get_losses(v, batch)[:2], jax_apply=jax_apply,
        port_apply=lambda p: p.module(p.pre_process(batch, train=train_apply)["image"]),
        port_loss=lambda p: p.get_losses(batch))


FAMILIES = {"RetinaNet": _retinanet, "FCOS": _fcos, "FasterRCNN": _frcnn, "CenterNet": _centernet,
            "YOLOv3": _yolov3, "DETR": _detr}


def _leaves(tree):
    """Tensor leaves in a fixed order: lists and tuples in order, dicts by key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _as_jax_layout(t, like):
    """A port leaf as a float64 array in the layout of the JAX leaf ``like``:
    an NCHW map goes to NHWC; anything else keeps its layout."""
    a = t.detach().double().numpy()
    if a.shape != like.shape and a.ndim == 4 and a.transpose(0, 2, 3, 1).shape == like.shape:
        return a.transpose(0, 2, 3, 1)
    return a


def _port_forward(port, family, names):
    """The port's forward with hooks on ``names`` (None: every named module):
    {name: output} of the modules that ran through ``__call__``."""
    seen, handles = {}, []
    for name, m in port.module.named_modules():
        if name and (names is None or name in names):
            handles.append(m.register_forward_hook(lambda mod, args, out, name=name: seen.setdefault(name, out)))
    try:
        with torch.no_grad():
            family.port_apply(port)
    finally:
        for h in handles:
            h.remove()
    return seen


def _grads(port, family):
    named = dict(port.module.named_parameters())
    grads = {n: p.grad for n, p in named.items() if p.grad is not None}
    kw = {"num_heads": family.num_heads} if hasattr(family, "num_heads") else {}
    return flat(jax_from_state_dict(grads, **kw)["params"])


def _norm(g):
    return math.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))


def _cosine(a, b):
    """The cosine of two flat gradient trees over b's keys, in float64; 0 where one is 0."""
    a = np.concatenate([np.asarray(a.get(k, np.zeros_like(b[k])), np.float64).ravel() for k in sorted(b)])
    b = np.concatenate([np.asarray(b[k], np.float64).ravel() for k in sorted(b)])
    norms = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / norms) if norms > 0 else 0.0


_RUNS = {}


def family_run(name):
    """The JAX package's bf16 losses, gradients and intermediates, and the
    port's f32 and bf16 ones, for one family (computed once)."""
    if name in _RUNS:
        return _RUNS[name]
    import jax
    import jax.numpy as jnp

    from basedet_tpu.layers.precision import precision_policy as jax_policy

    f = FAMILIES[name]()
    variables, port = f.variables, f.port
    others = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        total, losses = f.jax_loss({**others, "params": params})
        return total, losses

    with jax_policy(jnp.bfloat16):
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        out = jax.jit(lambda v: f.jax_apply(v, capture_intermediates=True, mutable=["intermediates"]))(variables)
    inter = jax.device_get(out[1]["intermediates"])
    state = {k: v.clone() for k, v in port.module.state_dict().items()}
    port.train() if f.train_apply else port.eval()
    run = {"jlosses": {k: float(v) for k, v in jax.device_get(jlosses).items()}, "jgrads": flat(jax.device_get(jgrads)),
           "inter": inter}
    for dtype in (None, torch.bfloat16):
        port.module.load_state_dict(state)
        port.train() if f.train_apply else port.eval()
        with precision.precision_policy(dtype):
            run[dtype, "head"] = _port_forward(port, f, set(f.head))
            if dtype is not None:
                port.module.load_state_dict(state)
                run["stages"] = _port_forward(port, f, None)
        port.module.load_state_dict(state)
        port.train()
        port.module.zero_grad(set_to_none=True)
        with precision.precision_policy(dtype):
            total, losses = f.port_loss(port)
        total.backward()
        run[dtype, "losses"] = {k: float(v.detach()) for k, v in losses.items()}
        run[dtype, "grads"] = _grads(port, f)
        run[dtype, "total_dtype"] = total.dtype
    port.module.load_state_dict(state)
    run["family"] = f
    _RUNS[name] = run
    return run


def _jax_output(inter, name):
    """The intermediates' output of the module at dotted path ``name``."""
    node = inter
    for part in name.split("."):
        node = node[part]
    return node["__call__"][0]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_dtype_flow_matches_jax(name):
    """Every stage both packages name gives the JAX package's dtypes under
    the bf16 policy; the heads are among them."""
    r = family_run(name)
    compared = []
    for stage, out in r["stages"].items():
        try:
            jout = _jax_output(r["inter"], stage)
        except (KeyError, TypeError):
            continue
        got = sorted(str(t.dtype).removeprefix("torch.") for t in _leaves(out) if torch.is_tensor(t))
        want = sorted(str(np.asarray(t).dtype) for t in _leaves(jout))
        if len(got) != len(want):  # another packing of the same outputs (the RPN's flattened levels)
            got, want = sorted(set(got)), sorted(set(want))
        assert got == want, (stage, got, want)
        compared.append(stage)
    assert all(h in compared for h in r["family"].head), (compared, r["family"].head)
    assert len(compared) >= 4, compared


@pytest.mark.parametrize("name", list(FAMILIES))
def test_head_outputs_match_jax_bf16(name):
    r = family_run(name)
    f = r["family"]
    want = [np.asarray(t, np.float64) for h in f.head for t in _leaves(_jax_output(r["inter"], h))]
    got = [_as_jax_layout(t, w) for t, w in zip([t for h in f.head for t in _leaves(r[torch.bfloat16, "head"][h])], want)]
    ref = [_as_jax_layout(t, w) for t, w in zip([t for h in f.head for t in _leaves(r[None, "head"][h])], want)]
    assert len(got) == len(want) == len(ref)
    got, ref, want = (np.concatenate([a.reshape(-1) for a in x]) for x in (got, ref, want))
    noise = np.abs(want - ref).mean()  # the JAX package's bf16 against f32
    err = np.abs(got - want).mean()
    assert noise > 0 and err <= 1.5 * noise, (err, noise)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_losses_and_gradients_match_jax_bf16(name):
    r = family_run(name)
    assert r[torch.bfloat16, "total_dtype"] == torch.float32
    losses, jlosses, f32 = r[torch.bfloat16, "losses"], r["jlosses"], r[None, "losses"]
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        assert math.isfinite(v) and abs(v - jlosses[k]) <= 0.1 * abs(jlosses[k]), (k, v, jlosses[k], f32[k])
    grads, jgrads = r[torch.bfloat16, "grads"], r["jgrads"]
    norm, jnorm = _norm(grads), _norm(jgrads)
    assert abs(norm - jnorm) <= 0.15 * jnorm, (norm, jnorm, _norm(r[None, "grads"]))
    port, yardstick = _cosine(grads, jgrads), _cosine(r[None, "grads"], jgrads)
    assert yardstick >= 0.5 and port >= 0.5 * yardstick, (port, yardstick)


@pytest.mark.parametrize("config", ["ATSSConfig", "OTAConfig", "FreeAnchorConfig"])
def test_one_amp_train_step(config):
    """One ``make_train_step`` step under ``TRAINER.AMP.ENABLE``: finite
    losses, f32 parameters and gradients, the policy off again after it."""
    from basedet_tpu_torch import configs as P
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import DetSolver
    from tests.test_torch_fcos import make_batch
    from tests.tiny import shrink

    cfg = shrink(getattr(P, config)())
    cfg.DATA.MAX_INSTANCES = 6
    cfg.MODEL.BATCHSIZE = 2
    cfg.merge(["TRAINER.AMP.ENABLE", "True"])
    model = build_model(cfg, "cpu").train()
    solver = DetSolver.build(cfg)
    state = TrainState(model, solver)
    metrics = make_train_step(model, solver, cfg)(state, make_batch())
    assert metrics and all(math.isfinite(float(v)) for v in metrics.values())
    assert precision.compute_dtype() is None
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
