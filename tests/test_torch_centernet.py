"""The port's CenterNet (basedet_tpu_torch) against the JAX package on the
CPU: the DCN's block bilinear sampling and ``ModulatedDeformConv`` (forward
and ``jax.vjp`` in input and parameters, with random offsets, so that taps
are fractional and some fall off the map), ``DeconvLayer`` in train mode with
a random, non-symmetric transposed-convolution kernel, the targets of
``_gt_single``, and tiny CenterNet (``tests/tiny.shrink``: resnet10,
``DECONV_CHANNEL [512, 64, 32, 16]``, batch 2 of 128x128): head outputs,
losses, gradients, BN statistics, the top-100 decode (with ties) and one
SGD step, on weights carried across by ``utils/weights.py``.

Inputs come from numpy with fixed seeds. Tolerances, and why:
  * one layer's outputs and gradients to 1e-5 of each tensor's largest
    entry: both sides compute the same f32 operations, summing convolutions
    and the dense tap mix in their own order;
  * targets: the gaussians to 1e-6 (``exp`` of XLA and of PyTorch may differ
    by an ulp), the positives (exactly 1) and the rest exactly;
  * through the tiny model, head outputs to 1e-3 of their largest entry
    and losses to 1e-3 relative (``docs/PARITY.md:58-66`` budgets 1e-3 per
    stage), the BN statistics to 1e-4 of their largest entry;
  * each gradient to 1e-2 of its tensor's largest entry. Train-mode BN at
    batch 2 and random DCN offsets amplify f32 rounding through the
    network, and XLA:CPU's f32 gradients are the noisier side: against a
    float64 run of the port on this batch and these weights
    (``test_gradients_track_a_float64_run_of_the_port``) they lie up to
    7.8e-3 of a tensor's largest entry away (the stem BN's bias), the port's
    own f32 gradients 1.1e-3. A wrong layout or formula moves a gradient by
    its own size;
  * the decode: the same labels and cells in the same order wherever the
    JAX package's detection is valid, boxes to 1e-3 absolute (pixels);
  * after one SGD step each parameter to 1e-2 of its change plus 4 ulp of
    its largest value, the gradients' tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.utils import all_register
from basedet_tpu_torch import build_model
from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
from basedet_tpu_torch.layers.blocks.deformable import ModulatedDeformConv, bilinear_sample_batched
from basedet_tpu_torch.layers.head.center_head import DeconvLayer
from basedet_tpu_torch.models.det.centernet import centernet_targets
from basedet_tpu_torch.ops.scatter_rows import scatter_rows_plain
from basedet_tpu_torch.solver import DetSolver
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_yolox_train import flat
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

IMG = (128, 128)
MAX_INST = 6
LOSSES = {"total_loss", "loss_cls", "loss_box_wh", "loss_center_reg"}
GRAD_RTOL = 1e-2  # through the tiny model: see the module docstring


def randomise(variables, rng):
    """BN statistics, scales and every bias drawn from rng; the DCN offset
    branch (zero at init) and the transposed-conv kernels (bilinear,
    symmetric at init) given random weights, so that offsets are fractional
    and reach off the map, and a swapped kernel layout would show."""
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
            elif "conv_offset" in path:
                fan_in = np.prod(v.shape[:-1]) if k == "kernel" else 1
                v = rng.normal(0.0, 1.0 if k == "bias" else 2.0 / np.sqrt(fan_in), v.shape)
            elif "up_sample" in path:
                v = rng.normal(0.0, 0.25, v.shape)
            elif k == "bias":
                v = v + rng.normal(0.0, 0.3, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(jax.device_get(variables), ())


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("backend,C", [("onehot", 3), ("pallas", 32)])
def test_bilinear_sample_matches_jax(monkeypatch, backend, C):
    """Samples and their gradients in the image and the coordinates,
    coordinates spread beyond the image on every side."""
    from basedet_tpu.layers.blocks.deformable import _bilinear_sample_batched

    monkeypatch.setenv("BASEDET_DCN_SCATTER", backend)
    rng = np.random.RandomState(C)
    img = rng.randn(2, 5, 6, C).astype(np.float32)
    y = rng.uniform(-3.0, 7.0, (2, 7, 9)).astype(np.float32)
    x = rng.uniform(-3.0, 8.0, (2, 7, 9)).astype(np.float32)
    cot = rng.randn(2, 7, 9, C).astype(np.float32)
    out, vjp = jax.vjp(_bilinear_sample_batched, *map(jnp.asarray, (img, y, x)))
    grads = vjp(jnp.asarray(cot))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (img, y, x)]
    got = bilinear_sample_batched(*leaves)
    assert_rel(got.detach(), out, 1e-6, "out")
    calls = scatter_rows_plain.calls
    got.backward(torch.from_numpy(cot))
    assert scatter_rows_plain.calls == calls + 1
    for name, leaf, want in zip(("img", "y", "x"), leaves, grads):
        assert_rel(leaf.grad, want, 1e-5, name)


def _vjp_pair(jmodule, variables, x, port, cot, mutable=False):
    """JAX: output, new batch stats, and the vjp in params and input; the
    port: the same after one forward and ``backward(cot)``."""
    def f(params, xj):
        v = {**variables, "params": params}
        if mutable:
            return jmodule.apply(v, xj, mutable=["batch_stats"])
        return jmodule.apply(v, xj), {}

    @jax.jit
    def run(params, xj, ct):
        out, vjp, state = jax.vjp(f, params, xj, has_aux=True)
        return out, state, vjp(ct)

    out, state, (dparams, dx) = run(variables["params"], jnp.asarray(x), jnp.asarray(cot))
    xt = nchw(x).requires_grad_()
    got = port(xt)
    got.backward(nchw(cot))
    named = dict(port.named_parameters())
    pgrads = flat(jax_from_state_dict({n: p.grad for n, p in named.items()})["params"])
    return dict(out=out, state=state, dparams=flat(jax.device_get(dparams)), dx=dx,
                got=nhwc(got), pgrads=pgrads, gx=nhwc(xt.grad))


def is_zero_gradient(key):
    """The DCN mix's bias, which a train-mode BN follows: the BN takes away
    any per-channel constant, so its gradient is zero but for rounding."""
    return key.endswith("dcn/weight/bias")


def check_grads(got, want, rtol):
    """Each gradient to ``rtol`` of its tensor's largest entry; a gradient
    that is zero but for rounding to ``rtol`` of the largest of all."""
    assert set(got) == set(want)
    largest = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if is_zero_gradient(k):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= rtol * largest, k
            continue
        assert np.abs(w).max() > 0, k
        assert_rel(got[k], w, rtol, k)


def _check_vjp(r):
    assert_rel(r["got"], r["out"], 1e-5, "out")
    assert_rel(r["gx"], r["dx"], 1e-5, "dx")
    check_grads(r["pgrads"], r["dparams"], 1e-5)


def test_modulated_deform_conv_matches_jax_vjp():
    from basedet_tpu.layers.blocks.deformable import ModulatedDeformConv as JDCN

    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 7, 4).astype(np.float32)
    jmod = JDCN(out_channels=5)
    variables = randomise(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    port = ModulatedDeformConv(4, 5)
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    assert set(port.state_dict()) == {"conv_offset.weight", "conv_offset.bias", "weight.weight",
                                      "weight.bias"}
    cot = rng.randn(2, 6, 7, 5).astype(np.float32)
    r = _vjp_pair(jmod, variables, x, port, cot)
    # the offsets are fractional and some taps leave the map
    off = port.conv_offset(nchw(x)).detach()[:, :18]
    assert (off.frac().abs() > 0.05).float().mean() > 0.8 and off.abs().max() > 3
    _check_vjp(r)


def test_deconv_layer_matches_jax_in_train_mode():
    """DCN → BN → ReLU → transposed conv (a random, non-symmetric kernel:
    the bilinear init could not tell a channel swap) → BN → ReLU, with the
    BN statistics of the batch and their running update."""
    from basedet_tpu.layers.head.center_head import DeconvLayer as JDeconv

    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 5, 4).astype(np.float32)
    jmod = JDeconv(out_channels=6, train=True)
    variables = randomise(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    kernel = variables["params"]["up_sample"]["kernel"]
    assert not np.allclose(kernel, kernel.transpose(0, 1, 3, 2))
    port = DeconvLayer(4, 6).train()
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    cot = rng.randn(2, 10, 10, 6).astype(np.float32)
    r = _vjp_pair(jmod, variables, x, port, cot, mutable=True)
    _check_vjp(r)
    stats = flat(jax_from_state_dict(port.state_dict())["batch_stats"])
    for k, want in flat(jax.device_get(r["state"]["batch_stats"])).items():
        assert_rel(stats[k], want, 1e-5, k)


def _target_batch():
    """Two images of 8 gt rows at stride 4 on a 32x32 map: valid boxes, two
    overlapping ones of one class, zero and negative sizes, centres off the
    map, a centre on the map's last cell, and rows past num_valid."""
    gt = np.array([
        [[10, 12, 60, 50, 3], [14, 16, 58, 44, 3], [30, 30, 30, 70, 5], [40, 40, 20, 60, 1],
         [120, 4, 140, 30, 80], [-30, -20, -2, 10, 2], [100, 100, 127.9, 127.5, 7], [0, 0, 9, 9, 4]],
        [[0, 0, 127, 127, 80], [50.5, 60.25, 77.75, 90, 1], [64, 64, 66, 66, 2], [1, 1, 3, 3, 9],
         [0, 0, 0, 0, 0], [5, 5, 20, 20, 4], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
    ], np.float32)
    return gt, np.array([7, 6], np.int32)


def test_targets_match_gt_single():
    all_register()
    jmodel = C.CenterNetConfig().build_model()
    gt, num_valid = _target_batch()
    want = jax.device_get(jax.jit(jax.vmap(functools.partial(jmodel._gt_single, (32, 32))))(
        jnp.asarray(gt), jnp.asarray(num_valid)))
    got = centernet_targets(torch.from_numpy(gt), torch.from_numpy(num_valid), (32, 32), 80, 4, 0.7)
    score, wh, reg, mask, index = (t.numpy() for t in got)
    np.testing.assert_array_equal(mask, want[3])
    assert 0 < mask.sum() < 16
    np.testing.assert_array_equal(index, want[4])
    np.testing.assert_array_equal(wh, want[1])
    np.testing.assert_array_equal(reg, want[2])
    np.testing.assert_array_equal(score == 1.0, want[0] == 1.0)
    np.testing.assert_allclose(score, want[0], rtol=0, atol=1e-6)


def tiny_cfg():
    cfg = shrink(C.CenterNetConfig())
    cfg.DATA.MAX_INSTANCES = MAX_INST
    cfg.MODEL.BATCHSIZE = 2
    return cfg


def make_batch(it=0):
    batch = DummyLoader(batch_size=2, image_size=IMG, max_instances=MAX_INST).make_batch(it)
    batch["im_info"][1, 4] = 2
    batch["gt_boxes"][1, 2:] = 0.0
    return batch


def make_pair(cfg, seed=0):
    """(JAX model, its randomised variables as numpy, the port's model with
    the same weights in train mode)."""
    all_register()
    jmodel = cfg.build_model()
    variables = randomise(jmodel.init_variables(jax.random.PRNGKey(seed), image_size=IMG),
                          np.random.RandomState(seed))
    return jmodel, variables, port_with(variables, cfg).train()


@pytest.fixture(scope="module")
def tiny():
    """One batch through both models in train mode from the same weights:
    the JAX package's losses, new BN statistics and gradients (one compiled
    program), the port's the same, and the JAX eval-mode head outputs."""
    cfg = tiny_cfg()
    jmodel, variables, port = make_pair(cfg)
    batch = make_batch()

    def loss_fn(params, batch):
        total, losses, state = jmodel.get_losses({**variables, "params": params}, batch)
        return total, (losses, state)

    (_, (jlosses, jstate)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], batch)
    image = jmodel.pre_process(batch, train=False)["image"]
    jheads = jax.jit(jmodel.make_module(train=False).apply)(variables, image)
    port.module.zero_grad(set_to_none=True)
    calls = scatter_rows_plain.calls
    total, losses = port.get_losses(batch)
    total.backward()
    named = dict(port.module.named_parameters())
    grads = jax_from_state_dict({n: p.grad for n, p in named.items()})
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, port=port, batch=batch,
                jheads=jax.device_get(jheads), jlosses=jax.device_get(jlosses),
                jstate=flat(jax.device_get(jstate["batch_stats"])),
                jgrads=flat(jax.device_get(jgrads)), grads=flat(grads["params"]),
                losses={k: float(v.detach()) for k, v in losses.items()},
                stats=flat(jax_from_state_dict(port.module.state_dict())["batch_stats"]),
                scatter_calls=scatter_rows_plain.calls - calls)


def port_with(variables, cfg):
    """A fresh port model holding ``variables``."""
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    return port


def test_head_outputs_match_jax(tiny):
    port = port_with(tiny["variables"], tiny["cfg"])
    with torch.no_grad():
        got = port.module(port.pre_process(tiny["batch"])["image"])
    assert got["cls"].shape == (2, 32, 32, 80)
    for k in ("cls", "wh", "reg"):
        assert_rel(got[k], tiny["jheads"][k], 1e-3, k)


def test_centernet_module_runs_f32_whatever_the_process_set(tiny):
    """TF32 is off inside the forward even where the process turned it on
    (cuDNN's default), and the process's settings are back after it."""
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    port = port_with(tiny["variables"], tiny["cfg"])
    seen = []
    hook = port.module.upsample.register_forward_pre_hook(lambda *_: seen.append(flags()))
    saved = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            port.module(port.pre_process(tiny["batch"])["image"])
        after = flags()
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [(False, False)]
    assert after == (True, True)


def test_losses_and_bn_statistics_match_jax(tiny):
    assert set(tiny["losses"]) == LOSSES == set(tiny["jlosses"])
    for k, v in tiny["losses"].items():
        ref = float(tiny["jlosses"][k])
        assert ref > 0, k
        assert abs(v - ref) <= 1e-3 * abs(ref), (k, v, ref)
    assert set(tiny["stats"]) == set(tiny["jstate"])
    for k, want in tiny["jstate"].items():
        assert_rel(tiny["stats"][k], want, 1e-4, k)


def test_gradients_match_jax(tiny):
    assert tiny["scatter_calls"] == 3  # one scatter per DCN stage
    # FREEZE_AT 0: every tensor trains, and each gradient is nonzero
    check_grads(tiny["grads"], tiny["jgrads"], GRAD_RTOL)


def test_gradients_track_a_float64_run_of_the_port(tiny, monkeypatch):
    """The yardstick behind GRAD_RTOL: the same batch and weights through the
    port in float64 (the scatter as a float64 ``index_add_``). The port's f32
    gradients stay within 2e-3 of each tensor's largest entry of it, XLA:CPU's
    within GRAD_RTOL, so the distance between the two is rounding."""
    from basedet_tpu_torch.ops import scatter_rows_kernel

    def scatter64(idx, values, n_rows, out_dtype=torch.float64):  # the backward asks for the table's dtype
        B, N, D = values.shape
        key = torch.where((idx >= 0) & (idx < n_rows), idx.long() + torch.arange(B)[:, None] * n_rows,
                          B * n_rows).flatten()
        out = torch.zeros(B * n_rows + 1, D, dtype=values.dtype).index_add_(0, key, values.reshape(-1, D))
        return out[:-1].view(B, n_rows, D).to(out_dtype)

    monkeypatch.setattr(scatter_rows_kernel, "scatter_rows", scatter64)
    port = port_with(tiny["variables"], tiny["cfg"]).train()
    port.module.double()
    x = port.pre_process(tiny["batch"], train=True)
    losses = port.losses(port.module(x["image"].double()), x["img_info"], x["gt_boxes"])
    losses["total_loss"].backward()
    ref = flat(jax_from_state_dict({n: p.grad for n, p in port.module.named_parameters()})["params"])
    for k, r in ref.items():
        if is_zero_gradient(k):
            continue
        assert_rel(tiny["grads"][k], r, 2e-3, k)
        assert_rel(tiny["jgrads"][k], r, GRAD_RTOL, k)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "all-tied"])
def test_inference_matches_jax(tiny, ties):
    """The decode on the randomised weights, and with the class logits
    constant (a zero kernel), where every location is a peak of one score
    and the top 100 is decided by the tie-break alone."""
    jmodel, variables = tiny["jmodel"], tiny["variables"]
    if ties:
        variables = jax.tree_util.tree_map(lambda a: a, variables)
        out_conv = variables["params"]["head"]["cls_head"]["out_conv"]
        out_conv["kernel"] = np.zeros_like(out_conv["kernel"])
    want = jax.device_get(jmodel.inference_jit(variables, tiny["batch"]))
    got = {k: v.numpy() for k, v in port_with(variables, tiny["cfg"]).inference(tiny["batch"]).items()}
    valid = want["valid"]
    assert valid.sum() > 0
    np.testing.assert_array_equal(got["valid"], valid)
    np.testing.assert_array_equal(got["box_labels"][valid], want["box_labels"][valid])
    np.testing.assert_allclose(got["box_scores"], want["box_scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"][valid], want["boxes"][valid], rtol=0, atol=1e-3)
    if ties:
        assert len(set(want["box_scores"][0].tolist())) == 1


def test_one_sgd_step_matches_jax(tiny):
    """The port's whole train step (forward, targets, losses, backward
    through the scatter, ``DetSolver`` SGD with momentum and weight decay in
    warm-up) against the JAX package's solver applied to its gradients of
    the same batch from the same weights; then the parameters and BN
    statistics."""
    import optax

    from basedet_tpu.solver.build import DetSolver as JDetSolver

    cfg = tiny["cfg"]
    jsolver = JDetSolver.build(cfg, world_size=1)
    params = tiny["variables"]["params"]
    updates, _ = jax.jit(jsolver.tx.update)(
        jax.tree_util.tree_map(jnp.asarray, unflat(tiny["jgrads"])), jsolver.tx.init(params), params)
    want = flat(jax.device_get(optax.apply_updates(params, updates)))
    port = port_with(tiny["variables"], cfg).train()
    solver = DetSolver.build(cfg)
    m = make_train_step(port, solver, cfg)(TrainState(port, solver), tiny["batch"])
    assert m["lr"] == pytest.approx(float(jsolver.lr_schedule(0)), rel=1e-6)
    for k in LOSSES:
        assert abs(float(m[k]) - tiny["losses"][k]) <= 1e-6 * abs(tiny["losses"][k]), k
    before = flat(params)
    got = flat(jax_from_state_dict(dict(port.module.named_parameters()))["params"])
    for k, r in want.items():
        change = np.abs(r - before[k]).max()
        if is_zero_gradient(k):  # no decay on a bias, and a gradient of rounding
            np.testing.assert_allclose(got[k], r, rtol=0, atol=4 * np.spacing(np.abs(r).max()))
            continue
        assert change > 0, k
        bound = GRAD_RTOL * change + 4 * np.spacing(np.abs(r).max())
        assert np.abs(got[k] - r).max() <= bound, (k, np.abs(got[k] - r).max(), bound)
    stats = flat(jax_from_state_dict(port.module.state_dict())["batch_stats"])
    for k, r in tiny["jstate"].items():
        assert_rel(stats[k], r, 1e-4, k)


def unflat(d):
    tree = {}
    for k, v in d.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
