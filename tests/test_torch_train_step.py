"""The port's solver and train step (basedet_tpu_torch/solver, engine/
train_state.py) against the JAX package's optax chain and ``make_train_step``
on the CPU.

optax's ``add_decayed_weights → trace(nesterov) → scale(-lr)`` and
``torch.optim.SGD(weight_decay, momentum, nesterov=True)`` with the LR set
before each step are the same update; these tests show it rather than argue
it: on a small quadratic model over ten steps that cross warm-up, cosine and
the no-aug floor, with EMA burn-in and an update period, with and without
gradient clipping (held to 1e-6); and on tiny YOLOX-S over two steps of the
whole train step (see the tolerances there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.engine.train_state import TrainState as JTrainState
from basedet_tpu.engine.train_state import make_train_step as jmake_train_step
from basedet_tpu.solver.build import YOLOXSolver as JYOLOXSolver
from basedet_tpu.solver.schedules import yolox_cosine_lr as jyolox_cosine_lr
from basedet_tpu_torch.engine.train_state import TrainState, ema_momentum, make_train_step
from basedet_tpu_torch.solver import YOLOXSolver, yolox_cosine_lr
from basedet_tpu_torch.utils.weights import jax_from_state_dict
from tests.test_torch_yolox_train import flat, make_batch, make_pair, tiny_cfg


@pytest.mark.parametrize("warm,total,no_aug", [(5, 40, 10), (0, 30, 30), (2000, 4, 60)])
def test_yolox_cosine_lr_matches_jax(warm, total, no_aug):
    ours, ref = yolox_cosine_lr(0.04, total, warm, no_aug), jyolox_cosine_lr(0.04, total, warm, no_aug)
    steps = range(0, max(total, warm) + 5)
    np.testing.assert_allclose([ours(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-6, atol=1e-12)


def test_ema_momentum_matches_jax():
    from basedet_tpu.engine.train_state import ema_momentum as jema_momentum

    for ema in (dict(ALPHA=5e-4, MOMENTUM=None, UPDATE_PERIOD=1),
                dict(ALPHA=5e-4, MOMENTUM=None, UPDATE_PERIOD=2), dict(MOMENTUM=0.9)):
        cfg = C.YOLOXSConfig().TRAINER.EMA.clone()
        cfg.merge(ema)
        for iters in (4, 90000, 4_500_000):
            assert ema_momentum(cfg, iters) == jema_momentum(cfg, iters)


class _JaxQuad:
    """mean((x @ kernel + bias - y)²), as a JAX model's get_losses."""

    def get_losses(self, variables, batch, rng=None):
        p = variables["params"]
        loss = jnp.mean((batch["x"] @ p["kernel"] + p["bias"] - batch["y"]) ** 2)
        return loss, {"total_loss": loss}, {}


class _TorchQuad:
    def __init__(self, kernel, bias):
        self.module = torch.nn.Module()
        self.module.kernel = torch.nn.Parameter(torch.tensor(kernel))
        self.module.bias = torch.nn.Parameter(torch.tensor(bias))

    def get_losses(self, batch):
        m = self.module
        loss = torch.mean((torch.as_tensor(batch["x"]) @ m.kernel + m.bias
                           - torch.as_tensor(batch["y"])) ** 2)
        return loss, {"total_loss": loss}


def _quad_cfg(clip):
    cfg = C.YOLOXSConfig()
    cfg.MODEL.BATCHSIZE = 2
    cfg.SOLVER.merge(dict(BASIC_LR=0.05, WARM_ITERS=3, NUM_IMAGE_PER_EPOCH=2, MAX_EPOCH=10,
                          EXTRA_LR_ARGS=dict(NO_AUG_EPOCH=3, MIN_LR_RATIO=0.05)))
    cfg.TRAINER.EMA.merge(dict(ENABLE=True, MOMENTUM=0.8, BURNIN_ITER=2, UPDATE_PERIOD=3))
    if clip:
        cfg.TRAINER.GRAD_CLIP.merge(dict(ENABLE=True, TYPE=clip,
                                         ARGS=dict(upper=0.3, max_norm=0.5)))
    return cfg


@pytest.mark.parametrize("clip", [None, "value", "norm"])
def test_train_step_matches_jax_on_a_small_model(clip):
    """Ten steps: warm-up (steps 0-2, LR 0 at step 0), cosine (3-6), floor
    (7-9); EMA equal to the params before burn-in ends (steps 0-1), then
    momentum 0.8 on steps 2 (burn-in's last), 3, 6 and 9 only. Params, EMA
    and LR each step."""
    cfg = _quad_cfg(clip)
    rng = np.random.RandomState(0)
    kernel, bias = rng.normal(0, 1, (3, 2)).astype(np.float32), rng.normal(0, 1, 2).astype(np.float32)
    jsolver = JYOLOXSolver.build(cfg, world_size=1)
    jstate = JTrainState.create({"params": {"kernel": kernel, "bias": bias}}, jsolver, ema=True)
    jstep = jax.jit(jmake_train_step(_JaxQuad(), jsolver, cfg))
    model = _TorchQuad(kernel, bias)
    solver = YOLOXSolver.build(cfg)
    state = TrainState(model, solver, ema=True)
    step = make_train_step(model, solver, cfg)
    assert solver.max_iters == jsolver.max_iters == 10
    lrs = []
    for i in range(10):
        batch = {"x": rng.normal(0, 1, (4, 3)).astype(np.float32),
                 "y": rng.normal(0, 1, (4, 2)).astype(np.float32)}
        jstate, jm = jstep(jstate, batch)
        m = step(state, batch)
        lrs.append(m["lr"])
        assert abs(m["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"]) + 1e-12, i
        assert abs(float(m["total_loss"]) - float(jm["total_loss"])) <= 1e-6 * float(jm["total_loss"]), i
        for name in ("kernel", "bias"):
            np.testing.assert_allclose(getattr(model.module, name).detach().numpy(),
                                       np.asarray(jstate.params[name]), rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {name}")
            np.testing.assert_allclose(state.ema_params[name].numpy(),
                                       np.asarray(jstate.ema_params[name]), rtol=0, atol=1e-6,
                                       err_msg=f"step {i} ema {name}")
    assert state.step == 10
    assert lrs[0] == 0.0 and lrs[1] < lrs[2] and lrs[3] > lrs[6] > lrs[7] == lrs[9]
    assert not np.allclose(state.ema_params["kernel"].numpy(), model.module.kernel.detach().numpy())


def test_yolox_solver_groups_match_jax():
    """One SGD step with zero gradients moves only the weight-decayed
    tensors, by -lr·(1 + momentum)·wd·p: the conv kernels, not the biases
    or the BN weights."""
    cfg = tiny_cfg()
    cfg.SOLVER.merge(dict(WARM_ITERS=0, BASIC_LR=2.0))  # updates far above the params' ulp
    jmodel, variables, port = make_pair(cfg)
    params = variables["params"]
    jsolver = JYOLOXSolver.build(cfg, world_size=1)
    updates, _ = jax.jit(jsolver.tx.update)(jax.tree_util.tree_map(jnp.zeros_like, params),
                                           jsolver.tx.init(params), params)
    solver = YOLOXSolver.build(cfg)
    assert solver.base_lr == jsolver.base_lr
    opt = TrainState(port, solver).optimizer
    before = {n: p.detach().clone() for n, p in port.module.named_parameters()}
    for p in port.module.parameters():
        p.grad = torch.zeros_like(p)
    for g in opt.param_groups:
        g["lr"] = solver.lr_schedule(0)
    opt.step()
    moved = flat(jax_from_state_dict({n: p.detach() - before[n]
                                      for n, p in port.module.named_parameters()})["params"])
    ref = flat(jax.device_get(updates))
    assert moved.keys() == ref.keys()
    decayed = {k for k, v in ref.items() if np.abs(v).max() > 0}
    assert decayed == {k for k in ref if k.endswith("/kernel") and ref[k].ndim == 4}
    for k, v in ref.items():
        np.testing.assert_allclose(moved[k], v, rtol=1e-3, atol=1e-7, err_msg=k)


def test_two_yolox_train_steps_match_jax():
    """Two whole train steps from the same weights on two batches: forward,
    SimOTA, losses, backward, nesterov SGD with decay groups, EMA with
    momentum 0.9 after a one-step burn-in. The gradients agree to 1e-3 of
    each tensor's largest entry (tests/test_torch_yolox_train.py says why),
    and the second step's are taken at parameters that already differ, so
    each tensor of params and EMA is held to 5e-3 of its largest change over
    the two steps (2.4e-3 measured), plus 4 ulp of its largest value for the
    rounding of the params themselves; losses to 1e-4 relative. A wrong
    sign, decay group, momentum or EMA rule moves a change by O(1); the
    small-model test above holds that arithmetic to 1e-6. BN statistics to
    1e-4 relative or 5e-5 absolute: each step adds 3% of a batch mean taken
    deep in the network, where activations differ by up to ~1e-3.

    The LR is kept at 0.002: at ten times that, the first step's parameters
    differ by ~1e-7 between the frameworks, and that flips one of the 16
    foreground anchors of the second batch at a near-tie of SimOTA's cost,
    after which the two runs train on different assignments."""
    cfg = tiny_cfg()
    cfg.SOLVER.merge(dict(BASIC_LR=0.001, WARM_ITERS=0, NUM_IMAGE_PER_EPOCH=20, MAX_EPOCH=20))
    cfg.TRAINER.EMA.merge(dict(ENABLE=True, MOMENTUM=0.9, BURNIN_ITER=1))
    jmodel, variables, port = make_pair(cfg)
    jsolver = JYOLOXSolver.build(cfg, world_size=1)
    jstate = JTrainState.create(variables, jsolver, ema=True)
    jstep = jax.jit(jmake_train_step(jmodel, jsolver, cfg))
    solver = YOLOXSolver.build(cfg)
    state = TrainState(port, solver, ema=True)
    step = make_train_step(port, solver, cfg)
    before = flat(variables["params"])

    for i, batch in enumerate((make_batch(0), make_batch(1))):
        jstate, jm = jstep(jstate, batch)
        m = step(state, batch)
        assert abs(m["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
        for k, v in m.items():
            if k != "lr":
                assert abs(float(v) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), (i, k)
    assert m["l1_loss"] == 0 and state.step == 2

    got = {"params": flat(jax_from_state_dict(dict(port.module.named_parameters()))["params"]),
           "ema": flat(jax_from_state_dict(state.ema_params)["params"])}
    ref = {"params": flat(jax.device_get(jstate.params)),
           "ema": flat(jax.device_get(jstate.ema_params))}
    for tree in ("params", "ema"):
        for k, r in ref[tree].items():
            bound = 5e-3 * np.abs(r - before[k]).max() + 4 * np.spacing(np.abs(r).max())
            err = np.abs(got[tree][k] - r).max()
            assert err <= bound, (tree, k, err, bound)
    # the EMA acted: 0.9 of the first step's params and 0.1 of the second's
    k = "backbone/stem/conv/conv/kernel"
    assert not np.allclose(got["ema"][k], got["params"][k], rtol=0, atol=1e-7)

    stats = flat(jax_from_state_dict(port.module.state_dict())["batch_stats"])
    for k, r in flat(jax.device_get(jstate.model_state["batch_stats"])).items():
        np.testing.assert_allclose(stats[k], r, rtol=1e-4, atol=5e-5, err_msg=k)
