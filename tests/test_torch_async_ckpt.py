"""Async checkpoints of the port (``GLOBAL.CKPT_BACKEND "orbax"``,
``engine/hooks.py::AsyncCheckpointHook``) against the JAX package's
``OrbaxCheckpointHook``: both over the same 5 epochs keep the same steps and
resume at the same epoch. Then ``det_train`` on the CPU with tiny YOLOX-S
(EMA on): 2 epochs, a truncated ``3.pt.tmp`` left in the directory as a
preempted write would leave it, then ``--resume`` to 3 epochs: the module,
EMA and optimizer restored equal what epoch 2 saved, the step and the epoch
go on, the ``.tmp`` is ignored."""
import copy
import os
import types

import numpy as np
import pytest
import torch

from basedet_tpu_torch.engine.hooks import AsyncCheckpointHook, CheckpointHook, ResumeHook
from basedet_tpu_torch.engine.progress import Progress
from basedet_tpu_torch.tools import det_train
from tests.torch_threads import torch_threads  # noqa: F401

CONFIG = "basedet_tpu_torch/playground/yolox_s/config.py"


@pytest.fixture
def one_thread():
    """One intra-op thread, as ``tests/test_torch_no_jax.py`` gives its
    subprocesses: a tiny model's small ops otherwise wait on the threads of
    the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(resume):
    return types.SimpleNamespace(TRAINER={"RESUME": resume})


def _port_trainer(resume, seed=0):
    torch.manual_seed(seed)
    module = torch.nn.Linear(4, 3)
    opt = torch.optim.SGD(module.parameters(), lr=0.1, momentum=0.9)
    state = types.SimpleNamespace(optimizer=opt, ema_params={n: p.detach().clone() for n, p in
                                                              module.named_parameters()}, step=0)
    model = types.SimpleNamespace(module=module, device=torch.device("cpu"))
    return types.SimpleNamespace(cfg=_cfg(resume), model=model, state=state, progress=Progress(max_epoch=9))


def _port_step(t):
    t.state.optimizer.zero_grad()
    t.model.module(torch.ones(2, 4)).square().sum().backward()
    t.state.optimizer.step()
    t.state.step += 1


def test_same_steps_kept_and_same_resume_epoch_as_orbax(tmp_path):
    import jax.numpy as jnp

    from basedet_tpu.engine.hooks import OrbaxCheckpointHook

    jt = types.SimpleNamespace(cfg=_cfg(False), progress=Progress(max_epoch=9),
                               state={"w": jnp.zeros((4, 3)), "step": jnp.asarray(0)})
    jhook = OrbaxCheckpointHook(str(tmp_path / "orbax"))
    jhook.trainer = jt
    pt = _port_trainer(False)
    phook = AsyncCheckpointHook(str(tmp_path / "port"))
    phook.trainer = pt
    saved = {}
    for hook in (jhook, phook):
        hook.before_train()
    for epoch in range(1, 6):
        jt.progress.epoch = pt.progress.epoch = epoch
        jt.state = {"w": jt.state["w"] + epoch, "step": jt.state["step"] + 1}
        _port_step(pt)
        jhook.after_epoch()
        phook.after_epoch()
        saved[epoch] = {k: v.clone() for k, v in pt.model.module.state_dict().items()}
        with torch.no_grad():  # the parameters move on before the write is done
            for p in pt.model.module.parameters():
                p.add_(100.0)
    for hook in (jhook, phook):
        hook.after_train()
    assert list(jhook.mngr.all_steps()) == phook.steps() == [3, 4, 5]
    assert sorted(os.listdir(tmp_path / "port")) == ["3.pt", "4.pt", "5.pt"]

    jt2 = types.SimpleNamespace(cfg=_cfg(True), progress=Progress(max_epoch=9),
                                state={"w": jnp.zeros((4, 3)), "step": jnp.asarray(0)})
    jhook2 = OrbaxCheckpointHook(str(tmp_path / "orbax"))
    jhook2.trainer = jt2
    jhook2.before_train()
    pt2 = _port_trainer(True, seed=1)
    phook2 = AsyncCheckpointHook(str(tmp_path / "port"))
    phook2.trainer = pt2
    phook2.before_train()
    assert jt2.progress.epoch == pt2.progress.epoch == 6 and pt2.progress.inner_iter == 1
    assert int(jt2.state["step"]) == pt2.state.step == 5
    np.testing.assert_array_equal(np.asarray(jt2.state["w"]), np.full((4, 3), 15.0))
    for k, v in saved[5].items():
        assert torch.equal(pt2.model.module.state_dict()[k], v), k


def _opts(out, epochs):
    return ["MODEL.WIDTH_FACTOR", "0.25", "MODEL.BATCHSIZE", "2", "DATA.MAX_INSTANCES", "8",
            "DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "AUG.TRAIN_SETTING.INPUT_SIZE", "(64,64)",
            "AUG.TRAIN_SETTING.MULTISCALE_RANGE", "(2,2)", "SOLVER.MAX_EPOCH", str(epochs),
            "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1", "GLOBAL.CKPT_BACKEND", "orbax",
            "GLOBAL.OUTPUT_DIR", str(out), "GLOBAL.CKPT_SAVE_DIR", str(out / "ckpt")]


def test_det_train_async_checkpoints_then_resume(tmp_path, monkeypatch, one_thread):
    trainer = det_train.main(["-f", CONFIG, "--device", "cpu", "--ema", *_opts(tmp_path, 2)])
    hooks = [type(h) for h in trainer.hooks]
    assert AsyncCheckpointHook in hooks and CheckpointHook not in hooks and ResumeHook not in hooks
    assert trainer.state.step == 4 and sorted(os.listdir(tmp_path / "ckpt")) == ["1.pt", "2.pt"]
    ckpt = torch.load(tmp_path / "ckpt" / "2.pt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["progress"]["epoch"] == 2
    assert all(torch.equal(v, trainer.model.module.state_dict()[k]) for k, v in ckpt["model"].items())
    (tmp_path / "ckpt" / "3.pt.tmp").write_bytes((tmp_path / "ckpt" / "2.pt").read_bytes()[:1000])

    restored, original = {}, AsyncCheckpointHook.before_train

    def spy(self):  # the trainer's state just after the restore
        original(self)
        t = self.trainer
        restored.update(model=copy.deepcopy(t.model.module.state_dict()),
                        optimizer=copy.deepcopy(t.state.optimizer.state_dict()),
                        ema=copy.deepcopy(t.state.ema_params), step=t.state.step, epoch=t.progress.epoch)

    monkeypatch.setattr(AsyncCheckpointHook, "before_train", spy)
    resumed = det_train.main(["-f", CONFIG, "--device", "cpu", "--ema", "--resume", *_opts(tmp_path, 3)])
    assert restored["step"] == 4 and restored["epoch"] == 3
    assert all(torch.equal(restored["model"][k], v) for k, v in ckpt["model"].items())
    assert ckpt["ema"] and all(torch.equal(restored["ema"][k], v) for k, v in ckpt["ema"].items())
    assert restored["optimizer"]["param_groups"] == ckpt["optimizer"]["param_groups"]
    for i, state in ckpt["optimizer"]["state"].items():
        assert torch.equal(restored["optimizer"]["state"][i]["momentum_buffer"], state["momentum_buffer"])
    assert resumed.state.step == 6 and resumed.progress.epoch == 3
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1.pt", "2.pt", "3.pt"]  # the .tmp replaced by the write
    assert torch.load(tmp_path / "ckpt" / "3.pt", weights_only=True)["progress"]["epoch"] == 3
