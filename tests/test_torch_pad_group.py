"""One padded canvas across the data group (``engine/trainer.py::pad_to_group``).

Two gloo ranks train tiny RetinaNet two steps on a COCO-format set of PNGs of
varying sizes (no augmentation, global batches of 4, 2 a rank); rank 0's two
images are smaller than rank 1's on the first step. Each rank's canvas must
be the JAX package's ``DetectionPadCollator`` size for the global batch, and
the losses the ones a single process gives on the global batch, to 1e-5
relative (``tests/test_torch_parallel.py``'s tolerance for losses: the two
runs differ only in the order of their sums). A rank that padded its rows to
their own canvas (the port before the repair) would see other anchors, and
other negatives in its focal loss. The size buckets must commute with the
maximum for this to hold (``check_group_buckets``): checked for the
multiples of 32, the default test buckets and two ladders.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from basedet_tpu_torch import parallel
from basedet_tpu_torch.configs import RetinaNetConfig
from basedet_tpu_torch.data import register_dataset
from basedet_tpu_torch.utils.registry import build_trainer
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
# (h, w) of the 8 train images; the sampler's first global batch holds 4 of them
SIZES = [(40, 72), (48, 64), (120, 200), (88, 104), (56, 96), (64, 70), (36, 90), (150, 170)]


def write_set(root):
    from basedet_tpu_torch.data.image_ops import imwrite_png

    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    images, annotations = [], []
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        name = f"{i:04d}.png"
        imwrite_png(os.path.join(root, "img", name), img, level=0)
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
        for j in range(2):
            bw, bh = int(rng.randint(8, w // 2)), int(rng.randint(8, h // 2))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            annotations.append(dict(id=10 * i + j + 1, image_id=i + 1, category_id=j + 1, iscrowd=0,
                                    bbox=[float(x), float(y), float(bw), float(bh)], area=float(bw * bh)))
    anno = os.path.join(root, "anno.json")
    with open(anno, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=c, name=f"c{c}") for c in (1, 2)]), f)
    return os.path.join(root, "img"), anno


def cfg_for(root, world):
    cfg = shrink(RetinaNetConfig())
    cfg.DATA.TRAIN.name, cfg.DATA.TEST.name = "pad_group_train", "dummy"
    cfg.DATA.NUM_CLASSES, cfg.DATA.MAX_INSTANCES, cfg.DATA.NUM_WORKERS = 2, 4, 0
    cfg.AUG.TRAIN_VALUE = ()
    cfg.MODEL.BATCHSIZE = 4 // world
    cfg.SOLVER.MAX_EPOCH, cfg.SOLVER.NUM_IMAGE_PER_EPOCH, cfg.SOLVER.WARM_ITERS = 1, 8, 0
    cfg.GLOBAL.LOG_INTERVAL = 1
    cfg.GLOBAL.OUTPUT_DIR = os.path.join(root, f"out{world}_{parallel.global_rank()}")
    cfg.GLOBAL.CKPT_SAVE_DIR = os.path.join(cfg.GLOBAL.OUTPUT_DIR, "ckpt")
    return cfg


def train(root, world):
    """Two steps → (the canvas (H, W) of each step, the global losses of each
    step, the canvas the port's collator gives this process's rows, and, at
    world size 1, the canvas the JAX collator gives each global batch)."""
    register_dataset("pad_group_train", *write_set(root) if world == 1 else
                     (os.path.join(root, "img"), os.path.join(root, "anno.json")))
    trainer = build_trainer(cfg_for(root, world), "cpu")
    trainer.init_state()
    canvases, losses, own, jax_canvases, step = [], [], [], [], trainer.train_step

    def spy(state, batch):
        canvases.append(tuple(batch["data"].shape[1:3]))
        metrics = step(state, batch)
        losses.append({k: float(v) for k, v in parallel.reduce_metrics(metrics).items() if "loss" in k})
        return metrics

    trainer.train_step = spy
    collate = trainer.dataloader.collator

    def both(records):
        batch = collate(records)
        own.append(tuple(batch["data"].shape[1:3]))
        if world == 1:
            from basedet_tpu.data.collators.pad_collator import DetectionPadCollator as JaxCollator

            jax_canvases.append(tuple(JaxCollator(max_instances=4)(records)["data"].shape[1:3]))
        return batch

    trainer.dataloader.collator = both
    trainer.train()
    return {"canvases": canvases, "losses": losses, "own": own, "jax_canvases": jax_canvases}


def rank_main(root):
    torch.set_num_threads(1)
    parallel.init_from_env(torch.device("cpu"), "gloo")
    try:
        out = train(root, WORLD)
    finally:
        parallel.shutdown()
    torch.save(out, os.path.join(root, f"rank{os.environ['RANK']}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pad_group"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: tiny ops otherwise wait on the other test workers' threads
    try:
        single = train(root, 1)  # writes the set the ranks read
    finally:
        torch.set_num_threads(threads)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(WORLD):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(WORLD),
               "LOCAL_WORLD_SIZE": str(WORLD), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1"}
        log = open(os.path.join(root, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, "-c", f"from tests.test_torch_pad_group import rank_main; "
                                        f"rank_main({root!r})"], cwd=REPO, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    for r, (p, log) in enumerate(procs):
        rc = p.wait(timeout=300)
        log.close()
        if rc != 0:
            with open(os.path.join(root, f"rank{r}.log")) as f:
                raise AssertionError(f"rank {r} exited {rc}:\n{f.read()[-6000:]}")
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return single, ranks


def test_each_rank_pads_to_the_global_batch_canvas(runs):
    single, ranks = runs
    assert len(single["jax_canvases"]) == 2 and single["canvases"] == single["jax_canvases"]
    # the case the repair is for: some rank's own rows pad to a smaller canvas
    assert any(got["own"] != single["jax_canvases"] for got in ranks)
    for r, got in enumerate(ranks):
        assert got["canvases"] == single["jax_canvases"], f"rank {r}"


def test_two_ranks_losses_equal_one_process(runs):
    single, ranks = runs
    for step, want in enumerate(single["losses"]):
        for r, got in enumerate(ranks):
            assert got["losses"][step].keys() == want.keys()
            for k, v in want.items():
                np.testing.assert_allclose(got["losses"][step][k], v, rtol=1e-5, err_msg=f"rank {r} step {step} {k}")


@pytest.mark.parametrize("buckets, commutes", [
    (None, True),
    ("default test buckets", True),
    ([(320, 320), (512, 512), (640, 640), (800, 1344)], True),
    ([(320, 640), (640, 320), (640, 640)], False),
], ids=["multiples of 32", "default test buckets", "ordered ladder", "crossed ladder"])
def test_buckets_commute_with_the_maximum(buckets, commutes):
    from basedet_tpu_torch.data.coco_loader import _default_test_buckets
    from basedet_tpu_torch.data.collators.pad_collator import check_group_buckets

    if buckets == "default test buckets":
        cfg = RetinaNetConfig()
        buckets = _default_test_buckets(cfg.TEST.IMG_MIN_SIZE, cfg.TEST.IMG_MAX_SIZE)
    if commutes:
        check_group_buckets(buckets)
    else:
        with pytest.raises(ValueError, match="do not commute"):
            check_group_buckets(buckets)
