"""``TRAINER.REMAT`` (``--remat``) in the port (``layers/remat.py``) on the
CPU, in f32, at the ``tests/tiny.py`` sizes.

  * ``False``, ``True`` and ``"selective"`` give equal losses, gradients and
    new BN running statistics, within 1e-6 relative (measured: bit-equal,
    since every segment reruns the same operations on the same inputs), on
    tiny YOLOX-S, Faster R-CNN (its sampling drawn from (seed, step)),
    CenterNet and DETR; the BN statistics move once a step, not again when a
    segment is recomputed;
  * the activations kept outside the segments shrink: ``True`` keeps less
    than half of what a step without REMAT keeps, ``"selective"`` (the
    convolutions' outputs of YOLOX's ConvBNActs kept) lies between;
  * one train step with REMAT matches the JAX package's REMAT step (its
    ``jax.checkpoint``, whole or saving only ``conv_out``) on tiny YOLOX at
    64x64, the setup of ``tests/engine/test_remat.py``, within its rtol of
    1e-4.
"""
import math

import numpy as np
import pytest
import torch

from basedet_tpu_torch import build_model
from basedet_tpu_torch.layers import remat
from basedet_tpu_torch.layers.common.function import full_f32
from basedet_tpu_torch.utils.dummy import DummyLoader
from tests.test_torch_amp import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

RTOL = 1e-6
MODES = (None, "full", "selective")


def _model(name):
    from basedet_tpu import configs as C

    cfg = shrink(getattr(C, name)())
    cfg.DATA.MAX_INSTANCES = 6
    cfg.MODEL.BATCHSIZE = 2
    if name == "DETRConfig":
        cfg.MODEL.TRANSFORMER.DROPOUT = 0.1  # drawn from the step's generator, the same on recompute
    batch = DummyLoader(batch_size=2, image_size=(128, 128), max_instances=6).make_batch()
    batch["im_info"][1, 4] = 2
    batch["gt_boxes"][1, 2:] = 0.0
    return build_model(cfg, "cpu").train(), batch


def _step(model, batch, mode, saved=None):
    """One forward and backward under REMAT ``mode``: (losses, gradients,
    running statistics); ``saved`` collects the bytes autograd keeps outside
    the segments."""
    kwargs = {"seed": 42, "step": 3} if getattr(model, "draws_per_step", False) else {}
    model.module.zero_grad(set_to_none=True)

    def pack(t):
        if saved is not None:
            saved.append(t.numel() * t.element_size())
        return t

    with full_f32(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with remat.remat_policy(mode):
            total, losses = model.get_losses(batch, **kwargs)
    with full_f32():
        total.backward()
    grads = {n: p.grad.clone() for n, p in model.module.named_parameters() if p.grad is not None}
    stats = {f"{n}.{k}": getattr(m, k).clone() for n, m in model.module.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d) for k in ("running_mean", "running_var")}  # train-mode BN
    return {k: float(v.detach()) for k, v in losses.items()}, grads, stats


@pytest.mark.parametrize("name", ["YOLOXSConfig", "FasterRCNNConfig", "CenterNetConfig", "DETRConfig"])
def test_remat_modes_agree(name):
    model, batch = _model(name)
    state = {k: v.clone() for k, v in model.module.state_dict().items()}
    runs = {}
    for mode in MODES:
        model.module.load_state_dict(state)
        runs[mode] = _step(model, batch, mode)
    losses, grads, stats = runs[None]
    assert grads and all(math.isfinite(v) for v in losses.values())
    for mode in MODES[1:]:
        got_losses, got_grads, got_stats = runs[mode]
        assert got_losses.keys() == losses.keys()
        for k, v in losses.items():
            assert abs(got_losses[k] - v) <= RTOL * abs(v), (mode, k)
        assert got_grads.keys() == grads.keys()
        for k, g in grads.items():
            assert float((got_grads[k] - g).abs().max()) <= RTOL * max(float(g.abs().max()), 1e-30), (mode, k)
        # the running statistics move once a step: as without REMAT, and away from their start
        for k, s in stats.items():
            assert torch.allclose(got_stats[k], s, rtol=RTOL, atol=0), (mode, k)
    moved = [k for k, s in stats.items() if not torch.equal(s, state[k])]
    assert moved == list(stats), set(stats) - set(moved)
    assert bool(stats) == (name in ("YOLOXSConfig", "CenterNetConfig"))  # train-mode BN


def test_remat_keeps_fewer_activations():
    model, batch = _model("YOLOXSConfig")
    state = {k: v.clone() for k, v in model.module.state_dict().items()}
    kept = {}
    for mode in MODES:
        model.module.load_state_dict(state)
        saved = []
        _step(model, batch, mode, saved)
        kept[mode] = sum(saved)
    assert kept["full"] < 0.5 * kept[None], kept
    assert kept["full"] < kept["selective"] < kept[None], kept


@pytest.fixture(scope="module")
def yolox_pair():
    """Tiny YOLOX at 64x64, as ``tests/engine/test_remat.py`` sets it up:
    the JAX model on the port's initial weights, the batch."""
    from basedet_tpu.configs import YOLOXConfig
    from basedet_tpu.utils.dummy import DummyLoader as JDummyLoader
    from basedet_tpu_torch.utils.weights import jax_from_state_dict

    def cfg_for(mode):
        cfg = shrink(YOLOXConfig())
        cfg.MODEL.BATCHSIZE = 2
        cfg.DATA.MAX_INSTANCES = 4
        cfg.SOLVER.WARM_ITERS = 0
        cfg.SOLVER.NUM_IMAGE_PER_EPOCH = 64
        cfg.TRAINER.REMAT = mode
        cfg.TRAINER.EMA.ENABLE = False
        return cfg

    port = build_model(cfg_for(False), "cpu")
    variables = jax_from_state_dict(port.module.state_dict())
    batch = JDummyLoader(batch_size=2, image_size=(64, 64), max_instances=4).make_batch()
    return cfg_for, variables, batch


@pytest.mark.parametrize("mode", [True, "selective"])
def test_remat_step_matches_jax(yolox_pair, mode):
    import jax

    from basedet_tpu.engine.train_state import TrainState as JTrainState
    from basedet_tpu.engine.train_state import make_train_step as jmake_train_step
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import YOLOXSolver
    from basedet_tpu_torch.utils.weights import state_dict_from_jax

    cfg_for, variables, batch = yolox_pair
    cfg = cfg_for(mode)
    jmodel, jsolver = cfg.build_model(), cfg.build_solver()
    _, jmetrics = jax.jit(jmake_train_step(jmodel, jsolver, cfg))(JTrainState.create(variables, jsolver), batch)
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    port.train()
    solver = YOLOXSolver.build(cfg)
    metrics = make_train_step(port, solver, cfg)(TrainState(port, solver), batch)
    want = float(jmetrics["total_loss"])
    assert math.isfinite(want)
    np.testing.assert_allclose(float(metrics["total_loss"]), want, rtol=1e-4)
