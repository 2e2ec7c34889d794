"""``--debug`` (``tools/misc.py::enable_debug``), the port's counterpart of
``jax_debug_nans`` and ``jax_disable_jit``: a tiny YOLOX-S ``det_train`` runs
through with every module output checked, and with one NaN weight it raises
at the first module whose output is not finite, naming it; afterwards the
process is as before (no hook, anomaly mode off)."""
import os

import pytest
import torch

from basedet_tpu_torch import build_model
from basedet_tpu_torch.tools import det_train
from basedet_tpu_torch.tools.misc import import_config
from tests.torch_threads import torch_threads  # noqa: F401

CONFIG = "basedet_tpu_torch/playground/yolox_s/config.py"
OPTS = ["MODEL.WIDTH_FACTOR", "0.25", "MODEL.BATCHSIZE", "2", "DATA.MAX_INSTANCES", "8", "DATA.TRAIN.name", "dummy",
        "DATA.TEST.name", "dummy", "AUG.TRAIN_SETTING.INPUT_SIZE", "(64,64)", "AUG.TRAIN_SETTING.MULTISCALE_RANGE",
        "(2,2)", "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1"]
NAN_AT = "backbone.dark3_csp.conv1.conv.weight"


@pytest.fixture
def one_thread():
    """One intra-op thread, as ``tests/test_torch_no_jax.py`` gives its
    subprocesses: a tiny model's small ops otherwise wait on the threads of
    the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opts(tmp_path):
    return [*OPTS, "GLOBAL.OUTPUT_DIR", str(tmp_path), "GLOBAL.CKPT_SAVE_DIR", str(tmp_path / "ckpt")]


def test_debug_trains_then_leaves_the_process_as_it_was(tmp_path, one_thread):
    blocking = os.environ.get("CUDA_LAUNCH_BLOCKING")
    trainer = det_train.main(["-f", CONFIG, "--device", "cpu", "--debug", *_opts(tmp_path)])
    assert trainer.state.step == 2
    assert not torch.is_anomaly_enabled() and not torch.nn.modules.module._global_forward_hooks
    assert os.environ.get("CUDA_LAUNCH_BLOCKING") == blocking


def test_debug_names_the_module_of_a_nan_weight(tmp_path, one_thread):
    cfg = import_config(CONFIG)
    cfg.merge(_opts(tmp_path))
    state = build_model(cfg, "cpu").module.state_dict()
    assert NAN_AT in state
    state[NAN_AT].view(-1)[0] = float("nan")
    torch.save(state, tmp_path / "nan.pt")
    with pytest.raises(FloatingPointError, match=r"non-finite output of backbone\.dark3_csp\.conv1\.conv "
                                                 r"\(Conv2d\)"):
        det_train.main(["-f", CONFIG, "--device", "cpu", "--debug", *_opts(tmp_path), "MODEL.WEIGHTS",
                        str(tmp_path / "nan.pt")])
    assert not torch.is_anomaly_enabled() and not torch.nn.modules.module._global_forward_hooks
