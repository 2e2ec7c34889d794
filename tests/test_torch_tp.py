"""Tensor parallelism of the port (``TRAINER.TP_SIZE``: ``parallel/mesh.py``,
``parallel/tp.py`` and DETR's FFN in ``layers/blocks/transformer.py``) on the
CPU over gloo, against the JAX package's single-device step and the port's
one-process step.

Six rank processes are started once for the module (``ranks``) with
torchrun's environment: two as one (data 1 × model 2) grid and four as one
(data 2 × model 2) grid, each under its own process group. Every rank runs
the scenarios below and writes its results to a file the tests read, while
the test process computes the references.

- The tiny DETR of ``tests/parallel/test_tp_equivalence.py`` (ResNet-10,
  1 + 1 layers of width 256 and FFN 2048, 8 queries, a global batch of 2 of
  64×64), its biases spread (they start at 0), one train step with the
  solver built at world size 1, as there, dropout 0: against the JAX package's single-device step from the same
  weights (carried by ``utils/weights.py``), to that test's tolerance (loss
  rtol 1e-4; parameters rtol 1e-3, atol 1e-5), and against the port's
  one-process step.
- The same step with dropout 0.1: against the port's one-process step (the
  masks are the port's own draws, which the JAX package cannot share).
- On the two ranks, ``det_train --multi-host TRAINER.TP_SIZE 2`` on tiny
  DETR, 2 steps, against ``det_train`` in one process.
- The ranks of a grid end bit-equal; each FFN's all-reduce ran on every
  rank.

Tolerances against the port's one process: the two differ only in the
order of the FFN's sums (two partial products of F/2 columns summed over
ranks against one product of F), so the losses agree to 1e-5 relative and,
after one AdamW step, each parameter to rtol 1e-4, atol 1e-6 (ten times the
JAX test's); after ``det_train``'s two steps, to the JAX test's tolerance.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from basedet_tpu_torch import build_model, parallel
from basedet_tpu_torch.configs import DETRConfig
from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
from basedet_tpu_torch.layers.blocks import transformer
from basedet_tpu_torch.parallel import tp
from basedet_tpu_torch.parallel.mesh import grid_layout
from basedet_tpu_torch.solver import DetrSolver
from basedet_tpu_torch.utils.dummy import DummyLoader
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = {"tp2": (2, 2), "dp2xtp2": (4, 2)}  # name: (world size, TP_SIZE)
DETR_CONFIG = "basedet_tpu_torch/playground/detr_r50_150e/config.py"
LOSS_RTOL, JAX_RTOL, JAX_ATOL = 1e-4, 1e-3, 1e-5  # tests/parallel/test_tp_equivalence.py's
ONE_LOSS_RTOL, ONE_RTOL, ONE_ATOL = 1e-5, 1e-4, 1e-6


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def detr_cfg(dropout=0.0):
    """``tests/parallel/test_tp_equivalence.py``'s configuration (its
    ``MODEL.BATCHSIZE`` 1 sets the LR; the step takes the global batch of 2,
    split over the data ranks)."""
    cfg = shrink(DETRConfig())
    cfg.MODEL.BACKBONE.NAME = "resnet10"
    cfg.MODEL.BATCHSIZE = 1
    cfg.MODEL.TRANSFORMER.NUM_ENCODERS = 1
    cfg.MODEL.TRANSFORMER.NUM_DECODERS = 1
    cfg.MODEL.TRANSFORMER.DROPOUT = dropout
    cfg.MODEL.NUM_QUERIES = 8
    cfg.DATA.MAX_INSTANCES = 4
    cfg.SOLVER.WARM_ITERS = 0
    cfg.SOLVER.NUM_IMAGE_PER_EPOCH = 64
    return cfg


def detr_batch():
    return DummyLoader(batch_size=2, image_size=(64, 64), max_instances=4).make_batch()


def run_step(dropout):
    """One train step on the rank's rows of the global batch → (initial
    state, global losses, state after, FFN all-reduces per layer call)."""
    cfg = detr_cfg(dropout)
    model = build_model(cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # biases start at 0: spread them, so that each one's place in the sums shows
        for name, p in model.module.named_parameters():
            if name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=g), alpha=0.1)
    init = _sd(model.module)
    parallel.broadcast_module(model.module)
    model.train()
    solver = DetrSolver.build(cfg, world_size=1)
    state = TrainState(model, solver)
    reduce, calls = transformer.reduce_from_model, []
    transformer.reduce_from_model = lambda x: calls.append(tp.tp_size()) or reduce(x)
    try:
        metrics = make_train_step(model, solver, cfg)(state, parallel.shard_batch(detr_batch()))
    finally:
        transformer.reduce_from_model = reduce
    return {"init": init, "losses": {k: float(v) for k, v in parallel.reduce_metrics(metrics).items()},
            "state": _sd(model.module), "ffn_calls": calls}


def det_train_opts(out):
    return ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.TRANSFORMER.NUM_ENCODERS", "1",
            "MODEL.TRANSFORMER.NUM_DECODERS", "1", "MODEL.TRANSFORMER.DIM", "64", "MODEL.TRANSFORMER.DIM_FFN", "128",
            "MODEL.NUM_QUERIES", "8", "MODEL.BATCHSIZE", "2", "DATA.MAX_INSTANCES", "4",
            "DATA.DUMMY_IMAGE_SIZE", "(64,96)", "DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy",
            "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1",
            "GLOBAL.OUTPUT_DIR", out, "GLOBAL.CKPT_SAVE_DIR", os.path.join(out, "ckpt")]


def run_det_train(out, multi_host):
    """``det_train`` on tiny DETR, 2 steps of 2 images: one process, or
    ``--multi-host TRAINER.TP_SIZE 2`` on the two ranks."""
    from basedet_tpu_torch.tools import det_train

    flags = ["--multi-host", "--dist-backend", "gloo"] if multi_host else []
    opts = det_train_opts(out) + (["TRAINER.TP_SIZE", "2"] if multi_host else [])
    trainer = det_train.main(["-f", DETR_CONFIG, "--device", "cpu", *flags, *opts])
    return {"state": _sd(trainer.model.module), "step": trainer.state.step, "world": trainer.world_size,
            "global_batch": trainer.global_batch_size,
            "losses": {k: m.latest for k, m in trainer.meters.items() if "loss" in k}}


def rank_main(out_dir, name):
    """One rank of grid ``name``: the scenarios under the process group from
    torchrun's environment; on the two-rank grid, then ``det_train
    --multi-host`` over a second group (on ``TP_SECOND_PORT``); results into
    ``out_dir/<name>_rank<r>.pt``."""
    torch.set_num_threads(1)
    world, size = GRIDS[name]
    parallel.init_from_env(torch.device("cpu"), "gloo")
    grid = parallel.init_grid(size)
    results = {"grid": (parallel.world_size(), parallel.rank(), grid.model_rank, parallel.global_rank()),
               "jax": run_step(0.0), "dropout": run_step(0.1)}
    parallel.shutdown()
    if world == 2:
        os.environ["MASTER_PORT"] = os.environ["TP_SECOND_PORT"]
        results["det_train"] = run_det_train(os.path.join(out_dir, "det_train"), multi_host=True)
    assert not parallel.is_active()
    torch.save(results, os.path.join(out_dir, f"{name}_rank{os.environ['RANK']}.pt"))


# ------------------------------------------------------------ the harness

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    def __init__(self, out_dir):
        self.out_dir = str(out_dir)
        self.procs, self.logs = [], []
        for name, (world, _) in GRIDS.items():
            ports = [_free_port(), _free_port()]
            for r in range(world):
                env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
                       "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(ports[0]),
                       "TP_SECOND_PORT": str(ports[1]), "OMP_NUM_THREADS": "1"}
                log = open(os.path.join(self.out_dir, f"{name}_rank{r}.log"), "w")
                self.logs.append(log)
                self.procs.append((name, r, subprocess.Popen(
                    [sys.executable, "-c", f"from tests.test_torch_tp import rank_main; "
                                           f"rank_main({self.out_dir!r}, {name!r})"],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)))
        self._results = None

    def results(self):
        if self._results is None:
            for name, r, p in self.procs:
                rc = p.wait(timeout=600)
                if rc != 0:
                    with open(os.path.join(self.out_dir, f"{name}_rank{r}.log")) as f:
                        raise AssertionError(f"{name} rank {r} exited {rc}:\n{f.read()[-6000:]}")
            self._results = {name: [torch.load(os.path.join(self.out_dir, f"{name}_rank{r}.pt"), weights_only=False)
                                    for r in range(world)] for name, (world, _) in GRIDS.items()}
        return self._results

    def close(self):
        for _, _, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    handle = Ranks(tmp_path_factory.mktemp("tp"))
    yield handle
    handle.close()


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process steps (no process group, the whole batch)."""
    return {"jax": run_step(0.0), "dropout": run_step(0.1)}


@pytest.fixture(scope="module")
def jax_step(ranks):
    """The JAX package's single-device step from the ranks' initial weights."""
    import jax

    from basedet_tpu import configs as C
    from basedet_tpu.engine.train_state import TrainState as JTrainState
    from basedet_tpu.engine.train_state import make_train_step as jmake_train_step
    from basedet_tpu.utils import registers
    from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax

    init = ranks.results()["tp2"][0]["jax"]["init"]
    jcfg = shrink(C.DETRConfig())
    jcfg.MODEL.BACKBONE.NAME = "resnet10"
    jcfg.MODEL.BATCHSIZE = 1
    jcfg.MODEL.TRANSFORMER.NUM_ENCODERS = 1
    jcfg.MODEL.TRANSFORMER.NUM_DECODERS = 1
    jcfg.MODEL.TRANSFORMER.DROPOUT = 0.0
    jcfg.MODEL.NUM_QUERIES = 8
    jcfg.DATA.MAX_INSTANCES = 4
    jcfg.SOLVER.WARM_ITERS = 0
    jcfg.SOLVER.NUM_IMAGE_PER_EPOCH = 64
    jmodel = jcfg.build_model()
    solver = registers.solvers.get(jcfg.SOLVER.BUILDER_NAME).build(jcfg, world_size=1)
    variables = jax_from_state_dict(init, num_heads=jcfg.MODEL.TRANSFORMER.NUM_HEADS)
    state = jax.device_put(JTrainState.create(variables, solver, ema=False), jax.devices()[0])
    state, metrics = jax.jit(jmake_train_step(jmodel, solver, jcfg))(state, detr_batch())
    return {"loss": float(metrics["total_loss"]),
            "state": state_dict_from_jax(jax.device_get(state.variables()), init)}


def _close(got, want, rtol, atol, what):
    for k, w in want.items():
        if w.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=f"{what}: {k}")
        else:
            assert torch.equal(got[k], w), f"{what}: {k}"


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("world,size", [(2, 2), (4, 2), (4, 4), (8, 2), (8, 4), (6, 3)])
def test_grid_layout_is_the_meshs(world, size):
    """Model groups are consecutive ranks, data groups every ``size``-th, as
    ``make_mesh((("data", W // tp), ("model", tp)))`` reshapes devices."""
    data, model = grid_layout(world, size)
    layout = np.arange(world).reshape(world // size, size)
    assert model == [list(row) for row in layout]
    assert data == [list(col) for col in layout.T]


@pytest.mark.parametrize("world,size", [(4, 3), (2, 4), (6, 4), (3, 0)])
def test_grid_refuses_a_tp_size_that_does_not_divide(world, size):
    with pytest.raises(ValueError, match="does not divide"):
        grid_layout(world, size)


def test_det_train_refuses_tp_without_multi_host(tmp_path):
    from basedet_tpu_torch.tools import det_train

    with pytest.raises(ValueError, match="TP_SIZE 2 needs --multi-host"):
        det_train.main(["-f", DETR_CONFIG, "--device", "cpu", *det_train_opts(str(tmp_path)), "TRAINER.TP_SIZE", "2"])


def test_collectives_are_the_identity_without_a_model_group():
    """Out of ``tp_context``, or with no model group, the FFN is the plain
    one: the same bits, no collective."""
    x = torch.randn(2, 5, 8, requires_grad=True)
    assert tp.tp_size() == 1 and tp.copy_to_model(x) is x and tp.reduce_from_model(x) is x
    layer = transformer.EncoderLayer(8, num_heads=2, dim_ffn=16, dropout=0.0)
    with tp.tp_context(None):
        assert torch.equal(layer.ffn(x, None), layer.linear2(torch.relu(layer.linear1(x))))


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_ranks(ranks, name):
    """Each rank's data size, data rank and model rank; every FFN call of the
    step ran split over the model group."""
    world, size = GRIDS[name]
    for r, res in enumerate(ranks.results()[name]):
        assert res["grid"] == (world // size, r // size, r % size, r)
        for scenario in ("jax", "dropout"):
            assert res[scenario]["ffn_calls"] and set(res[scenario]["ffn_calls"]) == {size}


@pytest.mark.parametrize("name", list(GRIDS))
def test_tp_step_matches_jax_single_device(ranks, jax_step, name):
    """The TP step against the JAX package's single-device step, to
    ``tests/parallel/test_tp_equivalence.py``'s tolerance."""
    res = ranks.results()[name][0]["jax"]
    np.testing.assert_allclose(res["losses"]["total_loss"], jax_step["loss"], rtol=LOSS_RTOL)
    _close(res["state"], jax_step["state"], JAX_RTOL, JAX_ATOL, name)


@pytest.mark.parametrize("scenario", ["jax", "dropout"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_tp_step_matches_one_process(ranks, one_process, name, scenario):
    """The TP step against the port's one-process step on the whole batch,
    without dropout and with it (the FFN's mask drawn whole and sliced)."""
    got, want = ranks.results()[name][0][scenario], one_process[scenario]
    for k, v in want["init"].items():
        assert torch.equal(got["init"][k], v)
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=ONE_LOSS_RTOL, err_msg=k)
    _close(got["state"], want["state"], ONE_RTOL, ONE_ATOL, f"{name} {scenario}")


@pytest.mark.parametrize("name", list(GRIDS))
def test_ranks_end_bit_equal(ranks, name):
    results = ranks.results()[name]
    for scenario in ("jax", "dropout", "det_train"):
        if scenario in results[0]:
            for res in results[1:]:
                for k, v in results[0][scenario]["state"].items():
                    assert torch.equal(v, res[scenario]["state"][k]), f"{name} {scenario}: ranks differ at {k}"


def test_det_train_tp_matches_one_process(ranks, tmp_path):
    """``det_train --multi-host TRAINER.TP_SIZE 2`` on two ranks (data 1 ×
    model 2) against ``det_train`` in one process: world size 1, the same
    batches and schedule, the state after 2 steps to the JAX test's
    tolerance."""
    got = ranks.results()["tp2"][0]["det_train"]
    want = run_det_train(str(tmp_path / "one"), multi_host=False)
    assert (got["world"], got["global_batch"], got["step"]) == (1, 2, 2) == (want["world"], want["global_batch"],
                                                                              want["step"])
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=LOSS_RTOL, err_msg=k)
    _close(got["state"], want["state"], JAX_RTOL, JAX_ATOL, "det_train")
