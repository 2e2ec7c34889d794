"""TensorBoard logging of the port (``utils/tb_writer.py`` and the hooks of
``engine/hooks.py``) against the JAX package's hooks, which write through
``tensorboardX``: both driven by a fake trainer with the same meters,
progress, batch and detections, both directories read back with
TensorBoard's own ``EventAccumulator``. The (tag, step, value) series must
be equal, and the images' decoded pixels.

The JAX package draws labels with cv2's Hershey font and the port with
Pillow's (``evaluators/visualize.py``), so the images' text would differ by
construction; the image test draws through one renderer in both hooks, so
that what is compared is each hook's own work: the rows it keeps, their
rescaling onto the canvas, the channel order and the encoding.

TensorBoard reads event files through TensorFlow where it can import it,
which takes seconds here; the module hides it, so that TensorBoard takes its
own reader, as it does on a machine without TensorFlow."""
import glob
import io
import sys
import types

import numpy as np
import pytest
import torch

from basedet_tpu_torch.engine.hooks import TBDetectionImageHook, TensorboardHook
from basedet_tpu_torch.engine.progress import Progress
from basedet_tpu_torch.utils import tb_writer
from basedet_tpu_torch.utils.meters import MeterBuffer
from tests.torch_threads import torch_threads  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def no_tensorflow():
    hidden = "tensorflow" not in sys.modules
    if hidden:
        sys.modules["tensorflow"] = None
    yield
    if hidden:
        sys.modules.pop("tensorflow", None)


def accumulate(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    return acc


def test_crc32c_and_mask():
    assert tb_writer.crc32c(b"123456789") == 0xE3069283  # Castagnoli's check value
    assert tb_writer.crc32c(b"") == 0
    c = tb_writer.crc32c(b"abc")
    assert tb_writer.masked_crc(b"abc") == ((((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _trainer(meters_cls, max_iter=5):
    t = types.SimpleNamespace(progress=Progress(max_epoch=2, max_iter=max_iter), meters=meters_cls(window_size=4))
    return t


def test_scalars_equal_jax_hook(tmp_path):
    from basedet_tpu.engine.hooks import TensorboardHook as JaxHook
    from basedet_tpu.utils.meters import MeterBuffer as JaxMeters

    rng = np.random.default_rng(0)
    runs = {"jax": (JaxHook(str(tmp_path / "jax"), write_interval=3), _trainer(JaxMeters)),
            "port": (TensorboardHook(str(tmp_path / "port"), write_interval=3), _trainer(MeterBuffer))}
    for hook, t in runs.values():
        hook.trainer = t
        hook.before_train()
    for it in range(1, 11):
        values = {"total_loss": float(rng.uniform(0, 5)), "loss_cls": float(rng.uniform(0, 1)),
                  "lr": 1e-3 * it, "data_time": float(rng.uniform(0, 0.01))}
        for hook, t in runs.values():
            t.progress.epoch, t.progress.inner_iter = (it - 1) // 5 + 1, (it - 1) % 5 + 1
            t.meters.update(values)
            hook.after_iter()
    for hook, _ in runs.values():
        hook.after_train()
    jax, port = (accumulate(str(tmp_path / k)) for k in ("jax", "port"))
    assert sorted(port.Tags()["scalars"]) == sorted(jax.Tags()["scalars"]) == ["data_time", "loss_cls", "lr",
                                                                                 "total_loss"]
    for tag in jax.Tags()["scalars"]:
        want = [(e.step, e.value) for e in jax.Scalars(tag)]
        assert [(e.step, e.value) for e in port.Scalars(tag)] == want and [s for s, _ in want] == [3, 6, 9], tag
    # the port's own reader: every CRC checked, the version event first
    (path,) = glob.glob(str(tmp_path / "port" / "events.out.tfevents.*"))
    events = tb_writer.read_events(path)
    assert events[0]["file_version"] == "brain.Event:2" and len(events) == 1 + 3 * 4
    raw = bytearray(open(path, "rb").read())
    raw[-5] ^= 1
    bad = tmp_path / "bad.tfevents"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="bad data CRC"):
        tb_writer.read_events(str(bad))


class _Model:
    """What both image hooks touch of a model: ``inference`` (the JAX hook
    passes variables first), ``module.training``, ``eval``, ``train``."""

    def __init__(self, dets):
        self.dets, self.calls = dets, []
        self.module = torch.nn.Module()

    def inference(self, *args):
        batch = args[-1]
        self.calls.append({k: np.asarray(v) for k, v in batch.items()})
        n = len(batch["data"])
        return {k: v[:n] for k, v in self.dets.items()}

    def eval(self):
        self.module.train(False)

    def train(self):
        self.module.train(True)


def test_detection_images_equal_jax_hook(tmp_path, monkeypatch):
    import basedet_tpu.evaluators.visualize as jax_vis
    from basedet_tpu.engine.hooks import TBDetectionImageHook as JaxHook

    import basedet_tpu_torch.evaluators.visualize as port_vis

    monkeypatch.setattr(jax_vis, "visualize_detection", port_vis.visualize_detection)  # see the docstring
    rng = np.random.default_rng(1)
    B, D = 3, 6
    data = rng.integers(0, 256, (B, 96, 128, 3)).astype(np.uint8)
    # canvases (cur) of 96x120 from originals of 192x240: the boxes halve
    im_info = np.tile(np.asarray([[96, 120, 192, 240, 3]], np.float32), (B, 1))
    xy = rng.uniform(0, 150, (B, D, 2))
    dets = {"boxes": np.concatenate([xy, xy + rng.uniform(10, 80, (B, D, 2))], -1).astype(np.float32),
            "box_scores": rng.uniform(0, 1, (B, D)).astype(np.float32),
            "box_labels": rng.integers(0, 3, (B, D)).astype(np.int32),
            "valid": rng.uniform(size=(B, D)) < 0.8}
    hooks = {"jax": JaxHook(str(tmp_path / "jax")), "port": TBDetectionImageHook(str(tmp_path / "port"))}
    batches = {"jax": {"data": data, "im_info": im_info},
               "port": {"data": torch.from_numpy(data), "im_info": torch.from_numpy(im_info)}}
    models = {}
    for name, hook in hooks.items():
        models[name] = _Model({k: v if name == "jax" else torch.from_numpy(np.asarray(v))
                               for k, v in dets.items()})
        models[name].module.train(True)
        t = types.SimpleNamespace(progress=Progress(epoch=2, inner_iter=4, max_epoch=2, max_iter=4),
                                  last_batch=batches[name], model=models[name],
                                  state=types.SimpleNamespace(variables=lambda: {}))
        hook.trainer = t
        hook.before_train()
        hook.after_epoch()
        hook.after_train()
    assert models["port"].module.training  # back in train mode after the eval-mode inference
    assert np.array_equal(models["port"].calls[0]["data"], models["jax"].calls[0]["data"])
    jax, port = (accumulate(str(tmp_path / k)) for k in ("jax", "port"))
    assert sorted(port.Tags()["images"]) == sorted(jax.Tags()["images"]) == ["detections/img0", "detections/img1"]
    from PIL import Image

    drawn = 0
    for tag in jax.Tags()["images"]:
        (want,), (got,) = jax.Images(tag), port.Images(tag)
        assert (got.step, got.width, got.height) == (want.step, want.width, want.height) == (8, 128, 96)
        a, b = (np.asarray(Image.open(io.BytesIO(e.encoded_image_string))) for e in (want, got))
        assert a.shape == b.shape == (96, 128, 3) and np.array_equal(a, b), tag
        drawn += int((a != data[int(tag[-1])][..., ::-1]).any())
    assert drawn  # boxes were drawn
