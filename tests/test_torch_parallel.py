"""Data-parallel training of the port (``basedet_tpu_torch/parallel``) over two
ranks on the CPU (gloo), against one process on the global batch and against
the JAX package's own 8-device mesh step.

Two rank processes are started once for the module (``ranks``) with
torchrun's environment and run every scenario under one process group;
each writes its results to a file the tests read, while the test process
computes the references. A scenario is one function run unchanged at both
world sizes: it feeds global batches through ``parallel.shard_batch``, and
sets ``MODEL.BATCHSIZE`` to the global batch over the world size, so the
solver's LR and schedule are the same in both runs.

- (a) tiny RetinaNet, one step on a global batch of 8 (4 a rank), against
  ``tests/parallel/test_dp_equivalence.py``'s step on the JAX package's
  8-device mesh, with the port's initial weights carried over by
  ``utils/weights.py``: every parameter and the total loss to rtol 1e-4,
  atol 1e-6, the JAX test's tolerance.
- (b) tiny YOLOX-S (train-mode BN, SimOTA) and tiny Faster R-CNN (the
  sampling draws), two steps against one process on the global batch; the
  second batch has gts on rank 0's images only, where a per-rank loss
  normaliser would weigh rank 1's empty images as much as rank 0's. Also the
  whole ``det_train -d DIR --multi-host`` (loader, broadcast, hooks) on
  tiny YOLOX-S against ``det_train`` at world size 1, and DETR's dropout
  masks.
- (c) ``CrossRankBatchNorm`` against ``FlaxBatchNorm2d`` on the concatenated
  batch, in f32 and under the bf16 policy.
- (d) the ranks' states bit-equal after every scenario.
- (h) the fused CSP chain (``TRAINER.AMP.FUSED_BN`` under the bf16 policy,
  the kernels' plain versions on the CPU), its BN sums all-reduced: one
  ``CSPLayer`` (n=2, shortcuts) on a global batch of 4, and one tiny YOLOX-S
  ``--amp`` step, against one process on the global batch.
- (e) a checkpoint saved by ``CheckpointHook`` after 2 steps (EMA on) and
  restored by ``ResumeHook`` into a model drawn from another seed: 2 more
  steps bit-equal to 4 uninterrupted ones, as
  ``tests/parallel/test_sharded_ckpt_roundtrip.py`` holds the JAX package.

Tolerances of (b): the two runs differ only in the order of their sums (the
rank's partial sums, then the all-reduce; the cross-rank BN's statistics in
float64 against ``F.batch_norm``), so the losses agree to 1e-5 relative and,
after two SGD steps, each parameter tensor and BN buffer to 1e-4 of its
largest change plus 4 f32 ulps of its largest magnitude, 20× tighter than
``tests/test_torch_train_step.py`` holds the port to the JAX package (whose
gap includes XLA:CPU's own rounding).
"""
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.nn as nn

from basedet_tpu_torch import build_model, parallel
from basedet_tpu_torch.configs import FasterRCNNConfig, RetinaNetConfig, YOLOXSConfig
from basedet_tpu_torch.engine.hooks import CheckpointHook, ResumeHook
from basedet_tpu_torch.engine.progress import Progress
from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
from basedet_tpu_torch.layers.blocks.drop import batch_keep_mask, keep_mask
from basedet_tpu_torch.layers.blocks.yolo_block import CSPLayer
from basedet_tpu_torch.layers.common.blocks import FlaxBatchNorm2d
from basedet_tpu_torch.layers.common.sampling import step_generator
from basedet_tpu_torch.layers.precision import precision_policy
from basedet_tpu_torch.solver import DefaultSolver, DetSolver, YOLOXSolver
from basedet_tpu_torch.utils.dummy import DummyLoader
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YOLOX_CONFIG = "basedet_tpu_torch/playground/yolox_s/config.py"


# ---------------------------------------------------------------- scenarios
# Each runs under the rank's process group in the rank processes, and with
# no process group (world size 1, the global batch) in the test process.

def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _steps(model, cfg, solver, batches, ema=False):
    """Train steps on the rank's rows of each global batch → (the global
    losses of each step, the state)."""
    parallel.broadcast_module(model.module)
    model.train()
    state = TrainState(model, solver, ema=ema)
    step = make_train_step(model, solver, cfg)
    losses = []
    for b in batches:
        metrics = step(state, parallel.shard_batch(b))
        losses.append({k: float(v) for k, v in parallel.reduce_metrics(metrics).items()})
    return losses, state


def yolox_cfg(global_batch=4, ema=False):
    cfg = shrink(YOLOXSConfig())
    cfg.DATA.MAX_INSTANCES = 6
    cfg.MODEL.BATCHSIZE = global_batch // parallel.world_size()
    cfg.SOLVER.NUM_IMAGE_PER_EPOCH = 64
    cfg.TRAINER.EMA.ENABLE = ema
    return cfg


def yolox_batches(n=2, global_batch=4, size=64):
    """Dummy batches of 5 gts an image; the second has gts on the first half
    of its images only (rank 0's rows at world size 2)."""
    batches = [DummyLoader(batch_size=global_batch, image_size=(size, size), max_instances=6,
                           num_instances=5).make_batch(i) for i in range(n)]
    if n > 1:
        half = global_batch // 2
        batches[1]["im_info"][half:, 4] = 0
        batches[1]["gt_boxes"][half:] = 0.0
    return batches


def run_yolox():
    cfg = yolox_cfg()
    model = build_model(cfg, "cpu")
    losses, _ = _steps(model, cfg, YOLOXSolver.build(cfg, parallel.world_size()), yolox_batches())
    return {"losses": losses, "state": _sd(model.module)}


def frcnn_cfg():
    cfg = shrink(FasterRCNNConfig())
    cfg.DATA.MAX_INSTANCES = 6
    cfg.MODEL.BATCHSIZE = 2 // parallel.world_size()
    return cfg


def frcnn_batches():
    batches = [DummyLoader(batch_size=2, image_size=(128, 192), max_instances=6).make_batch(i) for i in range(2)]
    batches[1]["im_info"][1, 4] = 0
    batches[1]["gt_boxes"][1] = 0.0
    return batches


def run_frcnn():
    cfg = frcnn_cfg()
    model = build_model(cfg, "cpu")
    losses, _ = _steps(model, cfg, DetSolver.build(cfg, parallel.world_size()), frcnn_batches())
    return {"losses": losses, "state": _sd(model.module)}


def retina_cfg():
    """``tests/parallel/test_dp_equivalence.py``'s configuration."""
    cfg = shrink(RetinaNetConfig())
    cfg.MODEL.BATCHSIZE = 1
    cfg.DATA.MAX_INSTANCES = 4
    cfg.SOLVER.WARM_ITERS = 0
    cfg.SOLVER.NUM_IMAGE_PER_EPOCH = 64
    return cfg


def retina_batch():
    return DummyLoader(batch_size=8, image_size=(64, 64), max_instances=4).make_batch()


def run_retina():
    """One step on the global batch of 8, with the JAX test's solver (built
    at world size 1, as there)."""
    cfg = retina_cfg()
    model = build_model(cfg, "cpu")
    init = _sd(model.module)
    losses, _ = _steps(model, cfg, DefaultSolver.build(cfg, world_size=1), [retina_batch()])
    return {"init": init, "losses": losses, "state": _sd(model.module)}


def bn_inputs(dtype):
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(4, 8, 5, 6, generator=g) * 3 + 1).to(dtype)
    dy = torch.randn(4, 8, 5, 6, generator=g).to(dtype)
    weight, bias = torch.randn(8, generator=g), torch.randn(8, generator=g)
    return x, dy, weight, bias


def run_bn():
    """FlaxBatchNorm2d in train mode on the rank's rows, f32 and under the
    bf16 policy: output, input gradient, running statistics, and the
    parameter gradients averaged over ranks (``all_reduce_grads``)."""
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x, dy, weight, bias = bn_inputs(dtype)
        bn = FlaxBatchNorm2d(8, eps=1e-5, momentum=0.1)
        with torch.no_grad():
            bn.weight.copy_(weight), bn.bias.copy_(bias)
        bn.train()
        x = parallel.shard_rows(x).clone().requires_grad_(True)
        with precision_policy(torch.bfloat16 if dtype == torch.bfloat16 else None, False):
            y = bn(x)
        (y.float() * parallel.shard_rows(dy).float()).sum().backward()
        parallel.all_reduce_grads(bn.parameters())
        out[name] = {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
                     "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}
    return out


def fused_inputs():
    """A fused-eligible CSPLayer (dense, SiLU, n=2 with shortcuts) with BN
    affine and running statistics drawn from a seed, and a global batch of 4
    (bf16, the second half scaled and shifted) with its output cotangent."""
    g = torch.Generator().manual_seed(11)
    layer = CSPLayer(16, 32, n=2)
    with torch.no_grad():
        for m in layer.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / m.weight[0].numel() ** 0.5)
            elif isinstance(m, FlaxBatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g), m.bias.normal_(0.0, 0.3, generator=g)
                m.running_mean.normal_(0.0, 0.2, generator=g), m.running_var.uniform_(0.5, 2.0, generator=g)
    x = torch.randn(4, 16, 8, 8, generator=g) * 2
    x[2:] = x[2:] * 3 + 1  # rank 1's rows: statistics over one rank's rows would be far off the batch's
    dy = torch.randn(4, 32, 8, 8, generator=g)
    return layer, x.to(torch.bfloat16), dy


def run_fused_layer():
    """The fused CSP chain (``TRAINER.AMP.FUSED_BN`` under the bf16 policy) on
    the rank's rows in train mode: output, input gradient, the parameter
    gradients averaged over ranks and the running statistics."""
    layer, x, dy = fused_inputs()
    layer.train()
    x = parallel.shard_rows(x).clone().requires_grad_(True)
    with precision_policy(torch.bfloat16, True):
        y = layer(x)
    (y.float() * parallel.shard_rows(dy)).sum().backward()
    parallel.all_reduce_grads(list(layer.parameters()))
    return {"y": y.detach(), "dx": x.grad, "grads": {n: p.grad for n, p in layer.named_parameters()},
            "stats": {k: v.clone() for k, v in layer.state_dict().items() if "running" in k}}


def fused_yolox_cfg():
    cfg = yolox_cfg()
    cfg.TRAINER.AMP.ENABLE = True
    cfg.TRAINER.AMP.FUSED_BN = True
    return cfg


def run_fused_yolox():
    """One tiny YOLOX-S step under ``--amp TRAINER.AMP.FUSED_BN True``."""
    cfg = fused_yolox_cfg()
    model = build_model(cfg, "cpu")
    init = _sd(model.module)
    losses, _ = _steps(model, cfg, YOLOXSolver.build(cfg, parallel.world_size()), yolox_batches(1))
    return {"init": init, "losses": losses, "state": _sd(model.module)}


def run_fused():
    return {"layer": run_fused_layer(), **run_fused_yolox()}


def run_dropout():
    """DETR's dropout masks and Faster R-CNN's noise: the rank's rows of the
    global draw."""
    return {"dropout": batch_keep_mask((4 // parallel.world_size(), 5, 3), 0.5, step_generator(42, 3, "cpu"), "cpu")}


class _FakeTrainer:
    """What CheckpointHook and ResumeHook touch of a trainer."""

    def __init__(self, model, state):
        self.model, self.state = model, state
        self.progress = Progress(max_epoch=2, max_iter=2)
        self.ema_enabled = True


def run_ckpt_roundtrip(save_dir):
    """tests/parallel/test_sharded_ckpt_roundtrip.py's contract: 4 steps
    uninterrupted; 2 steps, CheckpointHook, ResumeHook into a model from
    another seed, 2 more steps."""
    cfg = yolox_cfg(ema=True)
    batches = yolox_batches(4)
    solver = YOLOXSolver.build(cfg, parallel.world_size())
    ref = build_model(cfg, "cpu")
    _, ref_state = _steps(ref, cfg, solver, batches, ema=True)

    model = build_model(cfg, "cpu")
    _, state = _steps(model, cfg, solver, batches[:2], ema=True)
    trainer = _FakeTrainer(model, state)
    trainer.progress.epoch = 1
    hook = CheckpointHook(save_dir)
    hook.trainer = trainer
    hook.after_epoch()

    fresh = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(123 + parallel.rank()))
    fresh.train()
    trainer2 = _FakeTrainer(fresh, TrainState(fresh, solver, ema=True))
    resume = ResumeHook(save_dir)
    resume.trainer = trainer2
    resume.before_train()
    restored = _sd(fresh.module)
    step = make_train_step(fresh, solver, cfg)
    for b in batches[2:]:
        step(trainer2.state, parallel.shard_batch(b))
    return {"uninterrupted": _sd(ref.module), "uninterrupted_ema": ref_state.ema_params,
            "uninterrupted_opt": ref_state.optimizer.state_dict()["state"],
            "resumed": _sd(fresh.module), "resumed_ema": trainer2.state.ema_params,
            "resumed_opt": trainer2.state.optimizer.state_dict()["state"], "restored": restored,
            "mid": _sd(model.module), "epoch": trainer2.progress.epoch, "step": trainer2.state.step}


def det_train_opts(out, per_rank=4):
    return ["MODEL.WIDTH_FACTOR", "0.25", "MODEL.BATCHSIZE", str(per_rank),
            "DATA.MAX_INSTANCES", "8", "DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy",
            "AUG.TRAIN_SETTING.INPUT_SIZE", "(96,96)", "AUG.TRAIN_SETTING.MULTISCALE_RANGE", "(2,4)",
            "AUG.TRAIN_SETTING.SYNC_ITER", "2", "SOLVER.MAX_EPOCH", "2", "SOLVER.NUM_IMAGE_PER_EPOCH", "8",
            "GLOBAL.LOG_INTERVAL", "1", "GLOBAL.OUTPUT_DIR", out, "GLOBAL.CKPT_SAVE_DIR", os.path.join(out, "ckpt")]


def run_det_train(out, multi_host):
    """``det_train`` on tiny YOLOX-S: at world size 1 with ``-f``; under
    ``--multi-host`` with ``-d`` over a directory holding the same config."""
    from basedet_tpu_torch.tools import det_train

    if multi_host:
        configs = os.path.join(out, f"configs_rank{os.environ['RANK']}")
        os.makedirs(configs, exist_ok=True)
        shutil.copy(os.path.join(REPO, YOLOX_CONFIG), configs)
        flags = ["-d", configs, "--multi-host", "--dist-backend", "gloo"]
    else:
        flags = ["-f", YOLOX_CONFIG]
    opts = det_train_opts(out, per_rank=4 // WORLD if multi_host else 4)
    trainer = det_train.main([*flags, "--device", "cpu", *opts])
    return {"state": _sd(trainer.model.module), "ema": trainer.state.ema_params, "step": trainer.state.step,
            "iters": trainer.progress.max_iter, "global_batch": trainer.global_batch_size,
            "world": trainer.world_size, "base_lr": trainer.solver.base_lr,
            "losses": {k: m.latest for k, m in trainer.meters.items() if "loss" in k}}


def rank_main(out_dir):
    """One rank: every scenario under the process group from torchrun's
    environment, then ``det_train --multi-host`` over a second group (on
    ``DP_SECOND_PORT``); results into ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(2)
    device = parallel.init_from_env(torch.device("cpu"), "gloo")
    assert device.type == "cpu" and parallel.world_size() == WORLD
    r = parallel.rank()
    timings, results = {}, {}
    for name, fn in (("bn", run_bn), ("dropout", run_dropout), ("retina", run_retina), ("yolox", run_yolox),
                     ("frcnn", run_frcnn), ("fused", run_fused),
                     ("ckpt", lambda: run_ckpt_roundtrip(os.path.join(out_dir, "ckpt")))):
        t0 = time.perf_counter()
        results[name] = fn()
        timings[name] = time.perf_counter() - t0
    parallel.shutdown()
    os.environ["MASTER_PORT"] = os.environ["DP_SECOND_PORT"]
    t0 = time.perf_counter()
    results["det_train"] = run_det_train(os.path.join(out_dir, "det_train"), multi_host=True)
    timings["det_train"] = time.perf_counter() - t0
    assert not parallel.is_active()
    results["timings"] = timings
    torch.save(results, os.path.join(out_dir, f"rank{r}.pt"))


# ------------------------------------------------------------ the harness

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    def __init__(self, out_dir):
        self.out_dir = str(out_dir)
        ports = [_free_port(), _free_port()]
        self.procs, self.logs = [], []
        for r in range(WORLD):
            env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(WORLD),
                   "LOCAL_WORLD_SIZE": str(WORLD), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(ports[0]),
                   "DP_SECOND_PORT": str(ports[1]), "OMP_NUM_THREADS": "2"}
            log = open(os.path.join(self.out_dir, f"rank{r}.log"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", f"from tests.test_torch_parallel import rank_main; rank_main({self.out_dir!r})"],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        self._results = None

    def results(self):
        if self._results is None:
            for r, p in enumerate(self.procs):
                rc = p.wait(timeout=600)
                self.logs[r].close()
                if rc != 0:
                    with open(os.path.join(self.out_dir, f"rank{r}.log")) as f:
                        raise AssertionError(f"rank {r} exited {rc}:\n{f.read()[-6000:]}")
            self._results = [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"), weights_only=False)
                             for r in range(WORLD)]
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    handle = Ranks(tmp_path_factory.mktemp("dp"))
    yield handle
    handle.close()


def _change_tol(got, want, init, name, rel=1e-4):
    """Each tensor within ``rel`` of its largest change from ``init`` plus 4
    ulps of its largest magnitude (see the module docstring); integer
    buffers exactly."""
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            assert torch.equal(g, w), f"{name}: {k}"
            continue
        change = float((w - init[k]).abs().max())
        tol = rel * change + 4 * float(torch.finfo(torch.float32).eps) * float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol, f"{name}: {k} off by {err:.3e} (largest change {change:.3e}, tolerance {tol:.3e})"


def _assert_ranks_equal(results, key):
    a, b = results[0][key], results[1][key]
    for k in ("state", "uninterrupted", "resumed"):
        if k in a:
            for name, v in a[k].items():
                assert torch.equal(v, b[k][name]), f"{key}/{k}: ranks differ at {name}"


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("scenario", ["retina", "yolox", "frcnn", "ckpt", "det_train", "fused"])
def test_ranks_end_bit_equal(ranks, scenario):
    """(d) After every scenario both ranks hold the same state, bit for bit."""
    _assert_ranks_equal(ranks.results(), scenario)


def test_two_rank_retinanet_step_matches_jax_mesh_step(ranks):
    """(a) The port's step over two ranks against the JAX package's step over
    its 8-device mesh, on the same global batch and initial weights."""
    import jax

    from basedet_tpu import configs as C
    from basedet_tpu.engine.train_state import TrainState as JTrainState
    from basedet_tpu.engine.train_state import make_train_step as jmake_train_step
    from basedet_tpu.parallel import make_mesh, replicate_state, shard_batch
    from basedet_tpu.solver.build import DefaultSolver as JDefaultSolver
    from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax

    res = ranks.results()[0]["retina"]
    jcfg = shrink(C.RetinaNetConfig())
    jcfg.MODEL.BATCHSIZE = 1
    jcfg.DATA.MAX_INSTANCES = 4
    jcfg.SOLVER.WARM_ITERS = 0
    jcfg.SOLVER.NUM_IMAGE_PER_EPOCH = 64
    jmodel = jcfg.build_model()
    solver = JDefaultSolver.build(jcfg, world_size=1)
    variables = jax_from_state_dict(res["init"])
    mesh = make_mesh()
    assert mesh.devices.size == 8
    state = replicate_state(JTrainState.create(variables, solver, ema=False), mesh)
    state, metrics = jax.jit(jmake_train_step(jmodel, solver, jcfg))(state, shard_batch(dict(retina_batch()), mesh))
    np.testing.assert_allclose(res["losses"][0]["total_loss"], float(metrics["total_loss"]), rtol=1e-4, atol=1e-6)
    want = state_dict_from_jax(jax.device_get(state.variables()), res["state"])
    for k, v in want.items():
        if v.is_floating_point():
            np.testing.assert_allclose(res["state"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["yolox", "frcnn"])
def test_two_ranks_match_one_on_the_global_batch(ranks, name):
    """(b) Two steps over two ranks against one process on the global batch;
    the second batch's gts lie on rank 0's images only."""
    got = ranks.results()[0][name]
    cfg = yolox_cfg() if name == "yolox" else frcnn_cfg()
    init = _sd(build_model(cfg, "cpu").module)
    want = run_yolox() if name == "yolox" else run_frcnn()
    for g, w in zip(got["losses"], want["losses"]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)
    _change_tol(got["state"], want["state"], init, name)


def test_det_train_multi_host_matches_world_size_one(ranks, tmp_path):
    """(b) ``det_train -d DIR --multi-host --dist-backend gloo`` over two CPU
    ranks (2 images each) against ``det_train`` on one process (4 images): the same
    global batches, multiscale sizes, LR, schedule and EMA, so the same
    state after 4 steps; as three updates lie behind the last step, the
    losses are held to 1e-4 relative and the state to 1e-3 of its largest
    change (measured: 1.1e-5 and 1.0e-4); checkpoints from rank 0 only."""
    got = ranks.results()[0]["det_train"]
    want = run_det_train(str(tmp_path / "w1"), multi_host=False)
    assert (got["world"], got["global_batch"], got["iters"], got["step"]) == (2, 4, 2, 4)
    assert (want["world"], want["global_batch"], want["iters"], want["step"]) == (1, 4, 2, 4)
    assert got["base_lr"] == want["base_lr"]
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    init = _sd(build_model(yolox_cfg(), "cpu").module)
    _change_tol(got["state"], want["state"], init, "det_train", rel=1e-3)
    _change_tol(got["ema"], want["ema"], init, "det_train EMA", rel=1e-3)
    out = os.path.join(ranks.out_dir, "det_train")
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["dumped_model.pt", "epoch_1.pt", "epoch_2.pt",
                                                              "last_checkpoint", "latest.pt"]
    assert not [f for f in os.listdir(out) if f.startswith("train_log") and "rank" in f]  # rank 1 logs nowhere


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_rank_bn_matches_bn_on_the_concatenated_batch(ranks, dtype):
    """(c) Each rank's output and input gradient are its rows of
    ``FlaxBatchNorm2d``'s on the whole batch; the averaged parameter
    gradients times the world size, and the running statistics, are the
    whole batch's. f32: 1e-5 of each tensor's largest magnitude (the
    statistics summed in float64 against ``F.batch_norm``'s order). bf16:
    the output within one bf16 ulp of its magnitude (flax's order, as
    ``_forward_policy``), the f32 statistics and parameter gradients to
    1e-5, the bf16 input gradient within 2 ulps."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, dy, weight, bias = bn_inputs(dt)
    bn = FlaxBatchNorm2d(8, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(weight), bn.bias.copy_(bias)
    bn.train()
    x = x.clone().requires_grad_(True)
    with precision_policy(torch.bfloat16 if dt == torch.bfloat16 else None, False):
        y = bn(x)
    (y.float() * dy.float()).sum().backward()
    want = {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}
    ulp = float(torch.finfo(dt).eps)
    for r, res in enumerate(ranks.results()):
        got = res["bn"][dtype]
        rows = slice(2 * r, 2 * r + 2)
        for k, w in want.items():
            g = got[k].float()
            w = w.float()
            if k in ("y", "dx"):
                w = w[rows]
            if k in ("dweight", "dbias"):
                g = g * WORLD
            scale = float(w.abs().max())
            tol = (2 * ulp if k == "dx" and dtype == "bf16" else ulp if k == "y" and dtype == "bf16"
                   else 1e-5) * scale
            assert float((g - w).abs().max()) <= tol, f"rank {r} {dtype} {k}: {float((g - w).abs().max())}"


def test_fused_csp_layer_two_ranks_match_one(ranks):
    """(h) Each rank's output and input gradient are its rows of the layer's
    on the whole batch (measured: bit-equal; held to one bf16 ulp of each
    tensor's magnitude), the running statistics the whole batch's to 4 f32
    ulps, the averaged gradients times the world size the whole batch's: the
    BN weights and biases (f32 sums) to 1e-5 of each tensor's largest entry,
    the conv kernels to 2 bf16 ulps of it, as each rank's kernel gradient is
    rounded to bf16 before the mean and the one process's once (measured:
    0.78 ulp at most)."""
    layer, x, dy = fused_inputs()
    layer.train()
    x = x.clone().requires_grad_(True)
    with precision_policy(torch.bfloat16, True):
        y = layer(x)
    (y.float() * dy).sum().backward()
    bf16 = float(torch.finfo(torch.bfloat16).eps)
    f32 = float(torch.finfo(torch.float32).eps)
    for r, res in enumerate(ranks.results()):
        got = res["fused"]["layer"]
        rows = slice(2 * r, 2 * r + 2)
        for k, w in (("y", y.detach()[rows]), ("dx", x.grad[rows])):
            err = float((got[k].float() - w.float()).abs().max())
            assert err <= bf16 * float(w.float().abs().max()), (r, k, err)
        for n, p in layer.named_parameters():
            tol = (2 * bf16 if n.endswith("conv.weight") else 1e-5) * float(p.grad.abs().max())
            err = float((got["grads"][n] * WORLD - p.grad).abs().max())
            assert err <= tol, (r, n, err, tol)
        stats = {k: v for k, v in layer.state_dict().items() if "running" in k}
        assert stats.keys() == got["stats"].keys() and len(stats) == 14
        for k, w in stats.items():
            assert float((got["stats"][k] - w).abs().max()) <= 4 * f32 * float(w.abs().max()), (r, k)


def test_fused_yolox_step_two_ranks_match_one(ranks):
    """(h) One tiny YOLOX-S ``--amp TRAINER.AMP.FUSED_BN True`` step over two
    ranks against one process on the global batch, to (b)'s tolerances
    (measured: losses 1e-7 relative, the state 7.3e-6 of its change)."""
    got = ranks.results()[0]["fused"]
    want = run_fused_yolox()
    for k in want["init"]:
        assert torch.equal(got["init"][k], want["init"][k]), k
    for g, w in zip(got["losses"], want["losses"]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)
    _change_tol(got["state"], want["state"], want["init"], "fused yolox")


def test_dropout_mask_is_the_ranks_rows_of_the_global_draw(ranks):
    """(b) DETR's dropout: rank r's mask is rows 2r, 2r+1 of the mask that one
    process draws for the global batch of 4."""
    want = keep_mask((4, 5, 3), 0.5, step_generator(42, 3, "cpu"), "cpu")
    for r, res in enumerate(ranks.results()):
        assert torch.equal(res["dropout"]["dropout"], want[2 * r:2 * r + 2])


def test_two_rank_checkpoint_roundtrip_is_bit_equal(ranks):
    """(e) Restored exactly (rank 1 started from another seed than rank 0,
    and takes rank 0's state), and two more steps bit-equal to the
    uninterrupted run: parameters, BN buffers, EMA and momentum."""
    for r, res in enumerate(ranks.results()):
        c = res["ckpt"]
        assert (c["epoch"], c["step"]) == (2, 4)
        for k, v in c["mid"].items():
            assert torch.equal(c["restored"][k], v), f"rank {r}: {k} not restored"
        for k, v in c["uninterrupted"].items():
            assert torch.equal(c["resumed"][k], v), f"rank {r}: {k}"
        for k, v in c["uninterrupted_ema"].items():
            assert torch.equal(c["resumed_ema"][k], v), f"rank {r}: EMA {k}"
        for i, s in c["uninterrupted_opt"].items():
            assert torch.equal(c["resumed_opt"][i]["momentum_buffer"], s["momentum_buffer"]), f"rank {r}: momentum {i}"


@pytest.mark.parametrize("solver,cfg_name", [("DefaultSolver", "RetinaNetConfig"), ("DetSolver", "FasterRCNNConfig"),
                                             ("YOLOXSolver", "YOLOXSConfig")])
def test_solver_at_world_size_two_matches_jax(solver, cfg_name):
    """(f) The LR, weight decay, total iterations and schedule of a solver
    built at world size 2 against the JAX package's ``build(cfg,
    world_size=2)``, for REDUCE_MODE MEAN and SUM."""
    from basedet_tpu import configs as C
    from basedet_tpu.solver import build as jbuild

    from basedet_tpu_torch import configs as P
    from basedet_tpu_torch.solver import build as pbuild

    for mode in ("MEAN", "SUM"):
        jcfg, pcfg = getattr(C, cfg_name)(), getattr(P, cfg_name)()
        for c in (jcfg, pcfg):
            c.SOLVER.REDUCE_MODE = mode
            c.SOLVER.NUM_IMAGE_PER_EPOCH = 640
            c.SOLVER.MAX_EPOCH = 12
        ours = getattr(pbuild, solver).build(pcfg, world_size=2)
        ref = getattr(jbuild, solver).build(jcfg, world_size=2)
        assert ours.max_iters == ref.max_iters
        assert ours.base_lr == pytest.approx(ref.base_lr, rel=1e-7)
        assert ours.weight_decay == pytest.approx(getattr(ref, "weight_decay", ours.weight_decay), rel=1e-7)
        steps = sorted({0, 1, 7, ours.max_iters // 3, ours.max_iters // 2, ours.max_iters - 1, ours.max_iters})
        np.testing.assert_allclose([ours.lr_schedule(s) for s in steps], [float(ref.lr_schedule(s)) for s in steps],
                                   rtol=1e-6, atol=1e-12)


def test_det_train_refuses_world_size_without_multi_host(monkeypatch, tmp_path):
    """(g) WORLD_SIZE > 1 without ``--multi-host`` would train unrelated
    copies: refused."""
    from basedet_tpu_torch.tools import det_train

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="without --multi-host"):
        det_train.main(["-f", YOLOX_CONFIG, "--device", "cpu", *det_train_opts(str(tmp_path))])


def test_det_train_multi_host_needs_torchrun_environment(monkeypatch, tmp_path):
    """(g) ``--multi-host`` without torchrun's environment raises, starting
    no process group and falling back to nothing; so do ``nccl`` on the CPU,
    ``nccl`` with more ranks than cards, and ``--dist-backend`` alone."""
    from basedet_tpu_torch.tools import det_train

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    opts = det_train_opts(str(tmp_path))
    with pytest.raises(RuntimeError, match="torchrun"):
        det_train.main(["-f", YOLOX_CONFIG, "--device", "cpu", "--multi-host", *opts])
    with pytest.raises(ValueError, match="needs --multi-host"):
        det_train.main(["-f", YOLOX_CONFIG, "--device", "cpu", "--dist-backend", "gloo", *opts])
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "2"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="nccl runs on CUDA"):
        parallel.init_from_env(torch.device("cpu"), "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL takes one card a rank"):
        parallel.init_from_env(torch.device("cuda"), "nccl")
    assert not parallel.is_active()
