"""The port's data pipeline (``basedet_tpu_torch/data``) against the JAX
package's (``basedet_tpu/data``) on the same files, records and seeds: a
``DataRNG(s)`` draws what the JAX package draws after ``random.seed(s)`` and
``np.random.seed(s)``, call for call.

Tolerances: boxes and ``im_info`` within 1e-4 px, labels, ids, sampler
indices, collated batches and annotations exact; images exact where no
pixel is resampled, within one grey level per resampling (resize, warp)
where one is, and within two where two are chained (mosaic: a resize, then
the affine warp; HSV jitter: a BGR→HSV→BGR round trip). Then the mirrors of
``tests/data/test_coco_pipeline.py``, ``test_objects365.py`` and the pack
tests of ``test_native_pack.py`` through the port's loaders (DataLoader
workers in place of the JAX package's process pool)."""
import json
import multiprocessing
import os
import random

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from basedet_tpu_torch.data.collators import CanvasRing, DetectionPadCollator, pack_images  # noqa: E402
from basedet_tpu_torch.data.datasets import COCODataset, MosaicDataset  # noqa: E402
from basedet_tpu_torch.data.image_ops import imwrite_png  # noqa: E402
from basedet_tpu_torch.data.transforms import DataRNG, TransformCompose, build_transforms  # noqa: E402
from tests.torch_threads import torch_threads  # noqa: F401

BOX_ATOL = 1e-4


def _write_coco(img_dir, anno_path, sizes, cat_ids=(1, 3, 18), per_image=2, seed=0):
    """A COCO-format set on disk, PNG written by the port (cv2 reads the same
    pixels): random noise images of ``sizes``, ``per_image`` boxes each."""
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations, aid = [], [], 1
    for i, (h, w) in enumerate(sizes, start=1):
        imwrite_png(os.path.join(img_dir, f"{i:06d}.png"), rng.randint(0, 255, (h, w, 3), np.uint8))
        images.append(dict(id=i, file_name=f"{i:06d}.png", height=h, width=w))
        for _ in range(per_image):
            bw, bh = int(rng.randint(10, w // 2)), int(rng.randint(10, h // 2))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            annotations.append(dict(id=aid, image_id=i, category_id=int(rng.choice(cat_ids)),
                                    bbox=[float(x), float(y), float(bw), float(bh)], area=float(bw * bh), iscrowd=0))
            aid += 1
    os.makedirs(os.path.dirname(anno_path), exist_ok=True)
    with open(anno_path, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=c, name=f"c{c}") for c in cat_ids]), f)
    return str(img_dir), str(anno_path)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    return _write_coco(root / "images", root / "instances.json", [(120, 160), (160, 120), (100, 100), (80, 140)])


def _same_record(port, ref, image_atol=0, share=None):
    np.testing.assert_allclose(port["boxes"], ref["boxes"], rtol=0, atol=BOX_ATOL)
    for key in ("labels", "iscrowd", "image_id", "orig_size", "scale"):
        if key in ref:
            assert np.array_equal(np.asarray(port[key]), np.asarray(ref[key])), key
    a, b = np.asarray(port["image"]), np.asarray(ref["image"])
    assert a.shape == b.shape
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    assert diff.max() <= image_atol
    if share is not None:
        assert (diff > 0).mean() <= share


def _both(jax_t, port_t, rec, seed):
    random.seed(seed)
    np.random.seed(seed)
    ref = jax_t({k: (v.copy() if hasattr(v, "copy") else v) for k, v in rec.items()})
    out = port_t({k: (v.copy() if hasattr(v, "copy") else v) for k, v in rec.items()}, DataRNG(seed))
    return out, ref


SPECS = {  # name: (spec, image tolerance in grey levels)
    "resize choice": ((("ShortestEdgeResize", dict(min_size=(64, 72, 80), max_size=128)),), 1),
    "resize range": ((("ShortestEdgeResize", dict(min_size=(60, 90), max_size=100, sample_style="range")),), 1),
    "flip": ((("RandomHorizontalFlip", dict(prob=0.5)),), 0),
    "colour jitter": ((("RandomBrightness", dict(low=0.6, high=1.4)), ("RandomContrast", dict(low=0.6, high=1.4)),
                       ("RandomSaturation", dict(low=0.6, high=1.4))), 0),
    "pad": ((("PadToTargetSize", dict(target_size=(200, 200), pad_value=3.0)),), 0),
    "min-iou crop": ((("MinIoURandomCrop", dict()),), 0),
    "expand": ((("Expand", dict(mean=(1, 2, 3), prob=0.7)),), 0),
    "size crop": ((("RandomSizeCrop", dict(min_size=40, max_size=90)),), 0),
    "center affine": ((("CenterAffine", dict(border=32, output_size=(96, 128))),), 1),
    # the warp's one level, times the brightness factor (at most 1.4)
    "centernet train": ((("CenterAffine", dict(border=32, output_size=(96, 96))), ("RandomHorizontalFlip", {}),
                         ("RandomBrightness", dict(low=0.6, high=1.4))), 1.4),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_transforms_match_jax(coco_dir, name):
    from basedet_tpu.data.transforms.transforms import build_transforms as jax_build

    spec, atol = SPECS[name]
    ds = COCODataset(*coco_dir)
    jax_t, port_t = jax_build(spec), build_transforms(spec)
    for seed in range(8):
        rec = ds[seed % len(ds)]
        rec["iscrowd"] = np.zeros(len(rec["labels"]), np.int32)
        out, ref = _both(jax_t, port_t, rec, seed)
        _same_record(out, ref, image_atol=atol)


def test_random_select_matches_jax(coco_dir):
    from basedet_tpu.data.transforms.transforms import RandomHorizontalFlip as JaxFlip
    from basedet_tpu.data.transforms.transforms import RandomSelect as JaxSelect
    from basedet_tpu.data.transforms.transforms import RandomSizeCrop as JaxCrop
    from basedet_tpu_torch.data.transforms.transforms import RandomHorizontalFlip, RandomSelect, RandomSizeCrop

    ds = COCODataset(*coco_dir)
    jax_t = JaxSelect([JaxFlip(1.0)], [JaxCrop(30, 60)], prob=0.5)
    port_t = RandomSelect([RandomHorizontalFlip(1.0)], [RandomSizeCrop(30, 60)], prob=0.5)
    for seed in range(6):
        _same_record(*_both(jax_t, port_t, ds[seed % len(ds)], seed))


def _mosaic_pair(coco_dir, hsv_prob, input_dim=(96, 128)):
    from basedet_tpu.data.datasets.coco import COCODataset as JaxCOCO
    from basedet_tpu.data.datasets.mosaic_dataset import MosaicDataset as JaxMosaic
    from basedet_tpu.data.transforms.yolox_transform import TrainTransform as JaxTrain
    from basedet_tpu_torch.data.transforms.yolox_transform import TrainTransform

    kw = dict(img_size=input_dim, degrees=10.0, translate=0.1, mosaic_scale=(0.5, 1.5), shear=2.0)
    return (MosaicDataset(COCODataset(*coco_dir), preproc=TrainTransform(hsv_prob=hsv_prob), **kw),
            JaxMosaic(JaxCOCO(*coco_dir), preproc=JaxTrain(hsv_prob=hsv_prob), **kw))


@pytest.mark.parametrize("case", ["port resampling, HSV off", "cv2 resampling, HSV on"])
def test_mosaic_and_mixup_match_jax(coco_dir, monkeypatch, case):
    """Mosaic of four, random affine, MixUp and flip, and the letterbox path
    with mosaic off, against the JAX package with the same seeds: boxes
    within 1e-4, labels and ids exact, the same number of draws. Images:
    with the port's resampling and HSV off, within two levels (a resize,
    then the warp; up to 17% of pixels off by one or two, measured). The
    HSV jitter keeps the JAX package's uint8 wrap of negative gains, which
    turns a one-level input difference into a large one on grey pixels; so
    it is held with cv2's resize and warp patched into the port (the
    resampling is held above and in test_torch_data_image_ops.py): then
    only HSV→BGR differs, within one level. The JAX package hands float32
    images with the port's uint8 values."""
    from basedet_tpu_torch.data.datasets import mosaic_dataset
    from basedet_tpu_torch.data.transforms import yolox_transform

    hsv = case.endswith("on")
    if hsv:
        monkeypatch.setattr(mosaic_dataset, "resize_bilinear",
                            lambda img, dsize: cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR))
        monkeypatch.setattr(yolox_transform, "warp_affine",
                            lambda img, M, dsize, border_value: cv2.warpAffine(img, M, dsize=dsize,
                                                                              borderValue=(border_value,) * 3))
    port, ref = _mosaic_pair(coco_dir, float(hsv))
    seen = {"mosaic": 0, "letterbox": 0}
    for seed in range(10):
        on = seed < 7
        port.enable_mosaic = ref.enable_mosaic = on
        random.seed(seed)
        np.random.seed(seed)
        r = ref[seed % len(ref)]
        port.rng.seed(seed)
        p = port[seed % len(port)]
        assert p["image"].dtype == np.uint8 and r["image"].dtype == np.float32
        _same_record(p, r, image_atol=1 if hsv else 2, share=0.01 if hsv else 0.25)
        assert random.random() == port.rng.py.random()  # the same number of draws
        assert np.random.rand() == port.rng.np.rand()
        seen["mosaic" if on else "letterbox"] += len(p["boxes"]) > 0
    assert all(seen.values())


def test_samplers_match_jax():
    from basedet_tpu.data.samplers.samplers import AspectRatioGroupSampler as JaxGroup
    from basedet_tpu.data.samplers.samplers import InferenceSampler as JaxInference
    from basedet_tpu_torch.data.samplers import AspectRatioGroupSampler, InferenceSampler, ShuffledBatchSampler

    ratios = np.random.RandomState(0).uniform(0.5, 2.0, 37)
    port, ref = AspectRatioGroupSampler(ratios, 4, seed=42), JaxGroup(ratios, 4, seed=42)
    for _ in range(3):
        assert list(port) == list(ref)
    assert len(port) == len(ref)
    yolox = ShuffledBatchSampler(37, 8, seed=42)
    for epoch in range(3):  # the JAX package's epoch_iter on the global random
        random.seed(42 + epoch)
        idxs = list(range(37))
        random.shuffle(idxs)
        assert list(yolox) == [idxs[i:i + 8] for i in range(0, 37 - 8 + 1, 8)]
    for rank in range(3):
        assert list(InferenceSampler(10, rank, 3)) == list(JaxInference(10, rank, 3))


def _records(rng, n=4, dtype=np.uint8):
    recs = []
    for i in range(n):
        h, w = int(rng.integers(40, 120)), int(rng.integers(40, 120))
        xy = rng.uniform(0, 20, (i + 1, 2))
        recs.append(dict(image=rng.integers(0, 255, (h, w, 3)).astype(dtype),
                         boxes=np.concatenate([xy, xy + rng.uniform(5, 20, (i + 1, 2))], 1).astype(np.float32),
                         labels=np.arange(1, i + 2, dtype=np.int32), image_id=100 + i, orig_size=(h + 1, w + 2)))
    return recs


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("buckets", [None, [(96, 96), (128, 128)]])
@pytest.mark.parametrize("ring", [False, True])
def test_collator_matches_jax(dtype, buckets, ring):
    from basedet_tpu.data.collators.pad_collator import DetectionPadCollator as JaxCollator

    recs = _records(np.random.default_rng(0), 5, dtype)
    port = DetectionPadCollator(max_instances=3, size_buckets=buckets, ring=CanvasRing() if ring else None)
    ref = JaxCollator(max_instances=3, size_buckets=buckets)(recs)
    for _ in range(6):  # round the ring past its depth
        out = port(recs)
    assert set(out) == set(ref)
    for k in ref:
        got = np.asarray(out[k])
        assert got.dtype == ref[k].dtype and np.array_equal(got, ref[k]), k


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pack_matches_jax_numpy_pack(dtype):
    from basedet_tpu.native.pack import _pack_numpy

    imgs = [r["image"] for r in _records(np.random.default_rng(1), 6, dtype)]
    pad = 114 if dtype == np.uint8 else 0.5
    ref, _ = _pack_numpy(imgs, 128, 128, pad, np.dtype(dtype), False)
    for ring in (None, CanvasRing(depth=2)):
        for _ in range(3):
            out = pack_images(imgs, 128, 128, pad, ring=ring)
        assert out.numpy().dtype == np.dtype(dtype) and np.array_equal(out.numpy(), ref)


def test_float_pad_value_demotes_uint8_to_f32():
    imgs = [r["image"] for r in _records(np.random.default_rng(2), 2, np.uint8)]
    assert pack_images(imgs, 128, 128, pad=0.5).dtype == torch.float32


def test_collator_preserves_uint8_and_model_casts():
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.configs import RetinaNetConfig

    batch = DetectionPadCollator(max_instances=8)(_records(np.random.default_rng(2), 2, np.uint8))
    assert batch["data"].dtype == torch.uint8
    cfg = RetinaNetConfig()
    cfg.MODEL.BACKBONE.NAME = "resnet18"
    model = build_model(cfg, "cpu")
    assert model.pre_process(batch, train=True)["image"].dtype == torch.float32
    total, _ = model.get_losses(batch)
    assert torch.isfinite(total)


def test_synthetic_coco_matches_the_jax_generator(tmp_path, monkeypatch):
    """The same annotations JSON but for file names (.png, not .jpg), and the
    pixels the JAX generator hands to cv2.imwrite, read back from the port's
    PNGs exactly."""
    from basedet_tpu.tools.sanity_e2e import make_synthetic_coco as jax_make
    from basedet_tpu_torch.data.image_ops import imread_bgr
    from basedet_tpu_torch.tools.sanity_e2e import make_synthetic_coco

    written = {}
    monkeypatch.setattr(cv2, "imwrite", lambda path, img: written.setdefault(os.path.basename(path), img.copy()))
    ref = jax_make(str(tmp_path / "jax"), n_train=5, n_val=3, size=96)
    out = make_synthetic_coco(str(tmp_path / "port"), n_train=5, n_val=3, size=96)
    for (_, ref_anno), (img_dir, anno) in zip(ref, out):
        a, b = json.load(open(anno)), json.load(open(ref_anno))
        for img in a["images"] + b["images"]:
            img["file_name"] = img.pop("file_name").rsplit(".", 1)[0]
        assert a == b
        for img in a["images"]:
            assert np.array_equal(imread_bgr(os.path.join(img_dir, img["file_name"] + ".png")),
                                  written[img["file_name"] + ".jpg"])
    assert len(written) == 8


# -- mirrors of tests/data/test_coco_pipeline.py --------------------------------------------------

def test_dataset_load_and_remap(coco_dir):
    ds = COCODataset(*coco_dir)
    assert len(ds) == 4
    assert ds.cat_id_to_label == {1: 1, 3: 2, 18: 3}  # category ids (1, 3, 18) → labels (1, 2, 3)
    rec = ds[0]
    assert rec["image"].ndim == 3 and rec["image"].shape[2] == 3 and rec["image"].dtype == np.uint8
    assert rec["boxes"].shape[1] == 4 and rec["labels"].min() >= 1


def test_transforms_keep_boxes_consistent(coco_dir):
    from basedet_tpu_torch.data.transforms.transforms import RandomHorizontalFlip, ShortestEdgeResize

    rec = TransformCompose([ShortestEdgeResize(64, 128), RandomHorizontalFlip(prob=1.0)])(
        COCODataset(*coco_dir)[0], DataRNG(0))
    h, w = rec["image"].shape[:2]
    assert min(h, w) == 64 or max(h, w) == 128
    b = rec["boxes"]
    assert (b[:, 0] <= b[:, 2]).all() and (b[:, 1] <= b[:, 3]).all()
    assert (b[:, 2] <= w + 1e-3).all() and (b[:, 3] <= h + 1e-3).all()


def _train_loader(coco_dir, workers, sampler=None, dataset=None, seed=42):
    from basedet_tpu_torch.data.coco_loader import TrainLoader, TransformedDataset
    from basedet_tpu_torch.data.samplers import AspectRatioGroupSampler
    from basedet_tpu_torch.data.transforms.transforms import ShortestEdgeResize

    if dataset is None:
        ds = COCODataset(*coco_dir)
        dataset = TransformedDataset(ds, TransformCompose([ShortestEdgeResize(64, 128)]))
        sampler = sampler or AspectRatioGroupSampler(ds.aspect_ratios(), batch_size=2)
    return TrainLoader(dataset, sampler, DetectionPadCollator(max_instances=10), num_workers=workers, seed=seed)


def test_full_train_loader(coco_dir):
    loader = _train_loader(coco_dir, 0)
    batches = [next(loader) for _ in range(2)]
    assert loader.epoch == 1  # one pass, two batches
    b = batches[0]
    assert b["data"].shape[0] == 2 and b["data"].shape[3] == 3
    assert b["data"].shape[1] % 32 == 0 and b["data"].shape[2] % 32 == 0
    assert b["gt_boxes"].shape == (2, 10, 5) and b["im_info"].shape == (2, 5)
    n = int(b["im_info"][0, 4])
    assert (b["gt_boxes"][0, :n, 4] >= 1).all()
    next(loader)
    assert loader.epoch == 2  # the stream goes on into the next pass


def test_test_loader_covers_dataset(coco_dir):
    from basedet_tpu_torch.data.coco_loader import TestLoader

    ds = COCODataset(*coco_dir, remove_images_without_annotations=False)
    loader = TestLoader(ds, None, DetectionPadCollator(max_instances=10), batch_size=1)
    assert sorted(int(b["image_id"][0]) for b in loader) == [1, 2, 3, 4]


class _Failing:
    """A dataset whose second sample raises."""

    def __init__(self):
        self.rng = DataRNG(0)

    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 1:
            raise ValueError("producer failed")
        return dict(image=np.zeros((8, 8, 3), np.uint8))


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetch_error_then_dead(workers):
    """A worker's exception reaches the consumer once; after it the loader
    has stopped its workers and yields nothing."""
    loader = _train_loader(None, workers, sampler=[[0], [1], [2]], dataset=_Failing())
    assert next(loader)["data"].shape == (1, 32, 32, 3)
    with pytest.raises(ValueError, match="producer failed"):
        next(loader)
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()  # idempotent
    assert not multiprocessing.active_children()


def test_prefetch_finite_exhaust_then_dead(coco_dir):
    """The finite loader (the test loader) ends, and a pass over it again
    yields the same batches."""
    from basedet_tpu_torch.data.coco_loader import TestLoader
    from basedet_tpu_torch.data.transforms.transforms import ShortestEdgeResize

    ds = COCODataset(*coco_dir)
    loader = TestLoader(ds, TransformCompose([ShortestEdgeResize((64, 72, 80), 128)]),
                        DetectionPadCollator(max_instances=10), batch_size=3)
    it = iter(loader)
    first = [next(it), next(it)]
    with pytest.raises(StopIteration):
        next(it)
    again = list(loader)
    assert len(again) == len(loader) == 2
    for a, b in zip(first, again):
        assert torch.equal(a["data"], b["data"])


def test_multiworker_loader_matches_inline(coco_dir):
    inline, pooled = _train_loader(coco_dir, 0), _train_loader(coco_dir, 2)
    b_in = [next(inline) for _ in range(4)]
    b_mp = [next(pooled) for _ in range(4)]
    pooled.close()
    assert pooled.forks == 1 and not multiprocessing.active_children()
    for a, b in zip(b_in, b_mp):
        assert a["data"].shape == b["data"].shape
        assert torch.equal(a["data"], b["data"]) and torch.equal(a["im_info"], b["im_info"])


class _RngProbe:
    """Each sample reports the worker's draws (stand-in for the transforms)."""

    def __init__(self):
        self.rng = DataRNG(0)
        self.flag = True

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return dict(image=np.zeros((4, 4, 3), np.uint8), draws=(self.rng.py.random(), float(self.rng.np.rand())),
                    flag=self.flag, pid=os.getpid())


def _probe_loader(workers):
    from basedet_tpu_torch.data.coco_loader import TrainLoader

    def collate(records):
        return {**{k: [r[k] for r in records] for k in ("draws", "flag", "pid")}}

    ds = _RngProbe()
    return ds, TrainLoader(ds, [[0, 1], [2, 3]], collate, num_workers=workers, seed=42)


def test_pool_workers_reseeded():
    """Two workers draw different streams, neither the parent's, each from
    (seed, pass, worker id)."""
    from basedet_tpu_torch.data.coco_loader import stream_seed

    _, loader = _probe_loader(2)
    try:
        batches = [next(loader), next(loader)]
    finally:
        loader.close()
    assert len({b["pid"][0] for b in batches}) == 2  # one batch per worker
    draws = {b["draws"][0] for b in batches}
    assert len(draws) == 2
    expected = set()
    for worker in range(2):
        rng = DataRNG(stream_seed(42, 0, worker))
        expected.add((rng.py.random(), float(rng.np.rand())))
    assert draws == expected and (DataRNG(0).py.random(), float(DataRNG(0).np.rand())) not in draws


def test_prefetch_close_runs_on_close():
    """close() stops the workers."""
    _, loader = _probe_loader(2)
    next(loader)
    assert multiprocessing.active_children()
    loader.close()
    assert not multiprocessing.active_children()


def test_pool_restart_propagates_dataset_flags():
    """Workers hold the dataset as it was when they were forked: a flag
    flipped in the parent reaches them after close(), when the next batch
    forks new ones (YOLOX's no-aug switch)."""
    ds, loader = _probe_loader(1)
    try:
        assert next(loader)["flag"] == [True, True]
        ds.flag = False
        assert next(loader)["flag"] == [True, True]  # the live workers' copy
        loader.close()
        assert next(loader)["flag"] == [False, False]
        assert loader.forks == 2
    finally:
        loader.close()


# -- mirrors of tests/data/test_objects365.py ------------------------------------------------------

@pytest.fixture(scope="module")
def o365_root(tmp_path_factory):
    """Objects365's layout under a data root: sparse ids in the 365 space."""
    root = tmp_path_factory.mktemp("data")
    _write_coco(root / "objects365" / "train", root / "objects365" / "annotations" / "objects365_train.json",
                [(96, 128)] * 20, cat_ids=(7, 42, 118, 250, 365), per_image=3)
    return str(root)


def test_resolve_and_load(o365_root, monkeypatch):
    from basedet_tpu_torch.data.datasets import resolve_dataset

    monkeypatch.setenv("BASEDET_DATA_DIR", o365_root)
    imgs, anno = resolve_dataset("objects365_train")
    assert os.path.isdir(imgs) and os.path.isfile(anno)
    ds = COCODataset(imgs, anno)
    assert ds.cat_id_to_label == {7: 1, 42: 2, 118: 3, 250: 4, 365: 5}
    assert len(ds) == 20
    rec = ds[0]
    assert rec["boxes"].shape[1] == 4 and 1 <= rec["labels"].min() and rec["labels"].max() <= 5


def _o365_cfg(batch):
    from basedet_tpu_torch.configs import RetinaNetConfig

    cfg = RetinaNetConfig()
    cfg.DATA.TRAIN.name = "objects365_train"
    cfg.DATA.NUM_CLASSES = 365
    cfg.MODEL.BATCHSIZE = batch
    cfg.DATA.MAX_INSTANCES = 8
    cfg.DATA.NUM_WORKERS = 0
    return cfg


def test_train_dataloader_from_config(o365_root, monkeypatch):
    from basedet_tpu_torch.data import DataloaderBuilder

    monkeypatch.setenv("BASEDET_DATA_DIR", o365_root)
    batch = next(iter(DataloaderBuilder.build(_o365_cfg(2))))
    assert batch["data"].shape[0] == 2  # MODEL.BATCHSIZE x world size 1
    assert batch["gt_boxes"].shape[1:] == (8, 5) and batch["im_info"].shape == (2, 5)
    assert batch["gt_boxes"][..., 4].max() <= 5  # contiguous remap, not raw 365-space ids


@pytest.mark.parametrize("workers", [0, 2])
def test_undersized_dataset_raises(o365_root, monkeypatch, workers):
    """A dataset smaller than the global batch fails loudly instead of
    spinning, and its workers stop."""
    from basedet_tpu_torch.data import DataloaderBuilder

    monkeypatch.setenv("BASEDET_DATA_DIR", o365_root)
    cfg = _o365_cfg(64)
    cfg.DATA.NUM_WORKERS = workers
    loader = DataloaderBuilder.build(cfg)
    with pytest.raises(RuntimeError, match="no batches"):
        next(iter(loader))
    assert not multiprocessing.active_children()
