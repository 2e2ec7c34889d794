"""The port's Faster R-CNN training path (basedet_tpu_torch) against the JAX
package on the CPU: ``get_losses`` and its gradients, the ``multistep_lr``
schedule, ``DetSolver``, and two whole train steps.

Tiny Faster R-CNN (``tests/tiny.shrink``: resnet10, FPN width 64, two
anchors per location, RPN top-k 200 before and 100 after NMS, 64 RoIs) on
two 128x192 images with 3 and 2 gt boxes of 6 padded rows. Weights come from
the JAX ``init_variables`` tree, randomised as tests/test_torch_faster_rcnn.py
does, through ``utils/weights.py``. Both sides get the same sampling noise:
the JAX package draws it from its key, ``jax_noise`` draws the same arrays
for the port (tests/test_torch_frcnn_targets.py).

Tolerances, and why:
  * the five losses to 1e-4 relative: the two frameworks sum each convolution
    in their own order (tests/test_torch_faster_rcnn.py holds the FPN levels
    to 1e-4 absolute), and the losses are means over a few hundred terms;
  * each gradient to 1e-3 of its tensor's largest entry, the bound of
    tests/test_torch_yolox_train.py, whose docstring measures XLA:CPU's own
    f32 rounding at 4.9e-4 of a tensor's largest magnitude against float64;
  * after two SGD steps each parameter to 5e-3 of its largest change plus 4
    ulp of its largest value, as tests/test_torch_train_step.py sets it for
    YOLOX and for the same reason: the second step's gradients are taken at
    parameters that already differ;
  * the schedule to 1e-6 relative: the JAX package computes it in f32, whose
    steps are 6e-8 relative, through four rounded operations.
Frozen parameters (the stem and layer1) get no gradient in the port and a
zero one in the JAX package, and stay unchanged bit for bit.
"""
import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from basedet_tpu import configs as C
from basedet_tpu.engine.train_state import TrainState as JTrainState
from basedet_tpu.engine.train_state import make_train_step as jmake_train_step
from basedet_tpu.solver.build import DetSolver as JDetSolver
from basedet_tpu.solver.schedules import multistep_lr as jmultistep_lr
from basedet_tpu.utils import all_register
from basedet_tpu_torch import build_model
from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
from basedet_tpu_torch.solver import DefaultSolver, DetSolver, multistep_lr
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_faster_rcnn import _randomise
from tests.test_torch_frcnn_targets import as_torch, jax_noise
from tests.test_torch_yolox_train import flat
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

IMG = (128, 192)
MAX_INST = 6
LOSSES = {"total_loss", "rpn_cls_loss", "rpn_reg_loss", "rcnn_cls_loss", "rcnn_reg_loss"}
FROZEN = ("bottom_up/conv1/", "bottom_up/layer1_")


def tiny_cfg():
    cfg = shrink(C.FasterRCNNConfig())
    cfg.DATA.MAX_INSTANCES = MAX_INST
    cfg.MODEL.BATCHSIZE = 2
    return cfg


def make_pair(cfg, seed=0):
    """(JAX model, its randomised variables as numpy, the port's model with
    the same weights in train mode)."""
    all_register()
    jmodel = cfg.build_model()
    variables = _randomise(jmodel.init_variables(jax.random.PRNGKey(seed), image_size=IMG),
                           np.random.RandomState(seed))
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    return jmodel, variables, port.train()


def make_batch(it=0):
    batch = DummyLoader(batch_size=2, image_size=IMG, max_instances=MAX_INST).make_batch(it)
    batch["im_info"][1, 4] = 2
    batch["gt_boxes"][1, 2:] = 0.0
    return batch


def port_noise(port, rng):
    """The noise that the JAX ``get_losses`` draws when given ``rng``, at the
    tiny model's sizes: all anchors of a 128x192 image, and 100 proposals
    plus the padded gt rows. flax does not hand the module the key it was
    given: ``make_rng("sampling")`` folds the module's path and a call count
    into it, so the derivation starts from that key, read here from the
    bound top-level module as ``FasterRCNNModule.__call__`` reads it."""
    module = C.FasterRCNNConfig().build_model().make_module(train=True)
    rng = nn.apply(lambda m: m.make_rng("sampling"), module)({}, rngs={"sampling": rng})
    gen = port.module.anchor_gen
    num_anchors = sum((IMG[0] // s) * (IMG[1] // s) for s in gen.strides) * gen.num_anchors
    return as_torch(jax_noise(rng, 2, num_anchors, port.cfg.MODEL.RPN.TRAIN_POST_NMS_TOPK + MAX_INST))


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_cfg()
    jmodel, variables, port = make_pair(cfg)
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, port=port, batch=make_batch())


@pytest.fixture(scope="module")
def losses_and_grads(pair):
    jmodel, variables, port = pair["jmodel"], pair["variables"], pair["port"]
    rng = jax.random.PRNGKey(11)

    def loss_fn(params, frozen, batch):
        total, loss_dict, _ = jmodel.get_losses({"params": params, "frozen": frozen}, batch, rng)
        return total, loss_dict

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["frozen"], pair["batch"])
    port.module.zero_grad(set_to_none=True)
    total, losses = port.get_losses(pair["batch"], noise=port_noise(port, rng))
    total.backward()
    named = dict(port.module.named_parameters())
    grads = jax_from_state_dict({n: p.grad for n, p in named.items() if p.grad is not None})
    return dict(jlosses=jax.device_get(jlosses), jgrads=flat(jax.device_get(jgrads)),
                losses={k: float(v.detach()) for k, v in losses.items()},
                grads=flat(grads["params"]),
                no_grad={n for n, p in named.items() if p.grad is None})


def test_losses_match_jax(losses_and_grads):
    r = losses_and_grads
    assert set(r["losses"]) == LOSSES == set(r["jlosses"])
    for k, v in r["losses"].items():
        ref = float(r["jlosses"][k])
        assert ref > 0, k
        assert abs(v - ref) <= 1e-4 * abs(ref), (k, v, ref)
    parts = sum(v for k, v in r["losses"].items() if k != "total_loss")
    assert abs(parts - r["losses"]["total_loss"]) <= 1e-6 * parts


def test_gradients_match_jax(losses_and_grads):
    r = losses_and_grads
    frozen = {k for k in r["jgrads"] if k.startswith(FROZEN)}
    assert frozen and set(r["grads"]) == set(r["jgrads"]) - frozen
    for k in frozen:  # cut by stop_gradient there, by requires_grad here
        assert np.abs(r["jgrads"][k]).max() == 0, k
    assert r["no_grad"] == {"bottom_up.conv1.weight", "bottom_up.layer1_0.conv1.weight",
                            "bottom_up.layer1_0.conv2.weight"}
    for k, got in r["grads"].items():
        ref = r["jgrads"][k]
        scale = np.abs(ref).max()
        assert scale > 0, k  # every trainable tensor is reached, the RoIAlign's backward included
        err = np.abs(got - ref).max()
        assert err <= 1e-3 * scale, (k, err, scale)


def test_get_losses_draws_from_seed_and_step(pair):
    """Without ``noise`` the draw is a function of (seed, step) alone."""
    port, batch = pair["port"], pair["batch"]
    with torch.no_grad():
        a = port.get_losses(batch, seed=42, step=5)[0]
        b = port.get_losses(batch, seed=42, step=5)[0]
        c = port.get_losses(batch, seed=42, step=6)[0]
    assert float(a) == float(b) != float(c)


def test_seed_zero_draws_unlike_an_unset_seed(monkeypatch):
    """``SEED 0`` is a seed of its own: the train step hands the model 0, not
    the default 42, so its sampling noise differs from an unset seed's, as
    the JAX package keys ``PRNGKey(cfg.get("SEED", 42))``."""
    from basedet_tpu_torch.models.det import faster_rcnn

    drawn = []
    real = faster_rcnn.draw_sampling_noise
    monkeypatch.setattr(faster_rcnn, "draw_sampling_noise",
                        lambda *a: drawn.append(real(*a)) or drawn[-1])
    for seed in (None, 0, 42):
        cfg = tiny_cfg()
        if seed is not None:
            cfg.SEED = seed
        port = build_model(cfg, "cpu").train()
        solver = DetSolver.build(cfg)
        make_train_step(port, solver, cfg)(TrainState(port, solver), make_batch())
    unset, zero, forty_two = drawn
    assert unset.keys() == zero.keys()
    for k in unset:
        assert torch.equal(unset[k], forty_two[k]), k
        assert not torch.equal(unset[k], zero[k]), k


def test_get_losses_with_an_image_without_gt(pair):
    """No gt in the second image: its anchors are all background, none of its
    RoIs weighs anything, and the losses stay finite and match."""
    jmodel, variables, port = pair["jmodel"], pair["variables"], pair["port"]
    batch = make_batch(1)
    batch["im_info"][1, 4] = 0
    batch["gt_boxes"][1] = 0.0
    rng = jax.random.PRNGKey(12)
    _, jlosses, _ = jax.jit(lambda v, b: jmodel.get_losses(v, b, rng))(variables, batch)
    with torch.no_grad():
        _, losses = port.get_losses(batch, noise=port_noise(port, rng))
    for k in LOSSES:
        ref = float(jlosses[k])
        assert np.isfinite(ref) and abs(float(losses[k]) - ref) <= 1e-4 * abs(ref), (k, float(losses[k]), ref)


@pytest.mark.parametrize("warm", [500, 0])
def test_multistep_lr_matches_jax(warm):
    base, milestones = 0.02 / 16 * 2, [12 * 40000, 16 * 40000]
    ours, ref = multistep_lr(base, milestones, 0.1, warm), jmultistep_lr(base, milestones, 0.1, warm)
    steps = [0, 1, 499, 500, 501, *(m + d for m in milestones for d in (-1, 0, 1)), 18 * 40000]
    np.testing.assert_allclose([ours(s) for s in steps], [float(ref(s)) for s in steps], rtol=1e-6, atol=0)
    assert ours(0) == (base * 0.001 if warm else base)
    assert ours(500) == base and ours(milestones[0]) == base * 0.1
    assert abs(ours(milestones[1]) - base * 0.01) <= 1e-12 * base


def test_det_solver_matches_jax():
    """One SGD step with zero gradients moves a parameter by -lr · wd · p:
    every trainable tensor, biases too, and none of the frozen ones. And the
    names: AdamW and CosineLR build (tests/test_torch_detr_solver.py holds
    them to optax); an unknown optimizer or schedule is refused."""
    cfg = tiny_cfg()
    cfg.SOLVER.merge(dict(WARM_ITERS=0, BASIC_LR=2.0))  # updates far above the params' ulp
    jmodel, variables, port = make_pair(cfg)
    params = variables["params"]
    jsolver = JDetSolver.build(cfg, world_size=1)
    updates, _ = jax.jit(jsolver.tx.update)(jax.tree_util.tree_map(np.zeros_like, params),
                                           jsolver.tx.init(params), params)
    solver = DetSolver.build(cfg)
    assert solver.base_lr == jsolver.base_lr == 4.0 and solver.max_iters == jsolver.max_iters
    assert not solver.nesterov and solver.momentum == 0.9
    opt = TrainState(port, solver).optimizer
    given = {id(p) for g in opt.param_groups for p in g["params"]}
    before = {n: p.detach().clone() for n, p in port.module.named_parameters()}
    for n, p in port.module.named_parameters():
        assert (id(p) in given) == p.requires_grad, n
        if p.requires_grad:
            p.grad = torch.zeros_like(p)
    opt.step()
    moved = flat(jax_from_state_dict({n: p.detach() - before[n]
                                      for n, p in port.module.named_parameters()})["params"])
    ref = flat(jax.device_get(updates))
    assert moved.keys() == ref.keys()
    for k, v in ref.items():
        if k.startswith(FROZEN):
            assert np.abs(v).max() == 0 and np.abs(moved[k]).max() == 0, k
        else:
            np.testing.assert_allclose(moved[k], v, rtol=1e-3, atol=1e-7, err_msg=k)
    biases = [k for k in ref if k.endswith("/bias")]
    assert biases and all(np.abs(moved[k]).max() > 0 for k in biases)  # the biases decay too

    assert DefaultSolver.build(cfg).lr_schedule(0) == 4.0
    for key, value in (("OPTIMIZER_NAME", "AdamW"), ("LR_SCHEDULER_NAME", "CosineLR")):
        other = tiny_cfg()
        other.SOLVER[key] = value
        built = DetSolver.build(other)
        assert built.optimizer == "AdamW" if key == "OPTIMIZER_NAME" else built.lr_schedule(built.max_iters) == 0.0
    for key, value, error in (("OPTIMIZER_NAME", "LAMB", ValueError), ("LR_SCHEDULER_NAME", "PolyLR", NotImplementedError)):
        bad = tiny_cfg()
        bad.SOLVER[key] = value
        with pytest.raises(error, match=value):
            DetSolver.build(bad)


def test_two_faster_rcnn_train_steps_match_jax():
    """Two whole train steps from the same weights on two batches: forward,
    sampling, losses, backward (through the RoIAlign backward), SGD with
    momentum and weight decay under the warm-up schedule. The JAX step is
    given the key that the port's noise is drawn from."""
    cfg = tiny_cfg()
    cfg.SOLVER.merge(dict(BASIC_LR=0.005, WARM_ITERS=4))
    jmodel, variables, port = make_pair(cfg)
    jsolver = JDetSolver.build(cfg, world_size=1)
    jstate = JTrainState.create(variables, jsolver)
    jstep = jax.jit(jmake_train_step(jmodel, jsolver, cfg))
    solver = DetSolver.build(cfg)
    state = TrainState(port, solver)
    assert state.ema_params is None
    step = make_train_step(port, solver, cfg)
    before = flat(variables["params"])

    noises = []
    real_get_losses = port.get_losses
    port.get_losses = lambda batch, seed, step: real_get_losses(batch, noise=noises[step])
    for i, batch in enumerate((make_batch(0), make_batch(1))):
        rng = jax.random.PRNGKey(20 + i)
        noises.append(port_noise(port, rng))
        jstate, jm = jstep(jstate, batch, rng)
        m = step(state, batch)
        assert abs(m["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
        assert set(m) == LOSSES | {"lr"}
        for k in LOSSES:
            assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), (i, k)
    assert state.step == 2 and m["lr"] == pytest.approx(0.01 * (0.001 * 0.75 + 0.25))

    got = flat(jax_from_state_dict(dict(port.module.named_parameters()))["params"])
    for k, r in flat(jax.device_get(jstate.params)).items():
        if k.startswith(FROZEN):
            np.testing.assert_array_equal(r, before[k], err_msg=k)
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            continue
        change = np.abs(r - before[k]).max()
        assert change > 0, k
        bound = 5e-3 * change + 4 * np.spacing(np.abs(r).max())
        err = np.abs(got[k] - r).max()
        assert err <= bound, (k, err, bound)
    # the frozen BN statistics and affine are buffers and stay as they were
    frozen = flat(jax_from_state_dict(port.module.state_dict())["frozen"])
    for k, r in flat(variables["frozen"]).items():
        np.testing.assert_array_equal(frozen[k], r, err_msg=k)
