"""COCO train and test loaders (counterpart of
``basedet_tpu/data/coco_loader.py``), in PyTorch's idiom: dataset →
transforms → batch sampler → pad collator through ``torch.utils.data.
DataLoader`` and its ``NUM_WORKERS`` worker processes.

The JAX package's ``PrefetchIterator`` guarantees three things, and
``TrainLoader`` keeps them: a worker's exception reaches the consumer (the
DataLoader re-raises it; the loader then stops its workers and yields no
more); a pass over the sampler that yields no batch raises instead of
spinning; ``close()`` stops the workers.

Under a process group each rank's loader walks the global batch sampler and
decodes its own rows of each batch (``RankBatchSampler``). A rank pads its
rows to their own size (or bucket); the trainer then pads every rank's batch
to the data group's largest canvas (``engine/trainer.py::pad_to_group``),
which is the canvas one process pads the global batch to, as the JAX package
does, because the buckets commute with the maximum
(``collators/pad_collator.py::check_group_buckets``, checked here for
``DATA.SIZE_BUCKETS`` when the world size is above 1).

Workers are forked, persist across passes, and each seeds its copy of the
dataset's ``DataRNG`` from (seed, pass, stream) in ``worker_init_fn``, the
stream being the worker id counted over every rank's workers,
with one intra-op thread. They touch no CUDA: their batches come back through
shared memory and are pinned in the main process (``pin_batch`` into the
loader's ``CanvasRing``). ``close()`` stops them; a later batch forks new
ones, which see the dataset as it is then (YOLOX's no-aug switch).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.data import DataLoader

from basedet_tpu_torch.data.collators.pack import CanvasRing, pin_batch
from basedet_tpu_torch.data.collators.pad_collator import DetectionPadCollator, check_group_buckets
from basedet_tpu_torch.data.datasets.coco import COCODataset
from basedet_tpu_torch.data.datasets.info import resolve_dataset
from basedet_tpu_torch.data.datasets.mosaic_dataset import MosaicDataset
from basedet_tpu_torch.data.samplers.samplers import (
    AspectRatioGroupSampler,
    InferenceSampler,
    RankBatchSampler,
    ShuffledBatchSampler,
)
from basedet_tpu_torch.data.transforms.transforms import DataRNG, build_transforms
from basedet_tpu_torch.data.transforms.yolox_transform import TrainTransform
from basedet_tpu_torch.parallel import rank, world_size


def stream_seed(seed: int, epoch: int, worker: int) -> int:
    """The seed of one worker's draws in one pass: distinct for every
    (seed, epoch, worker)."""
    return int(np.random.SeedSequence([seed, epoch, worker]).generate_state(1)[0])


def seed_worker(seed: int, epoch: int, first_stream: int, worker_id: int) -> None:
    """``worker_init_fn``: one intra-op thread, and the worker's copy of the
    dataset's ``DataRNG`` seeded from (seed, epoch, first_stream + worker
    id)."""
    torch.set_num_threads(1)
    torch.utils.data.get_worker_info().dataset.rng.seed(stream_seed(seed, epoch, first_stream + worker_id))


class TransformedDataset:
    """``dataset[i]`` through ``transform``, drawing from ``self.rng``."""

    def __init__(self, dataset, transform=None, rng: Optional[DataRNG] = None):
        self.dataset = dataset
        self.transform = transform
        self.rng = rng or DataRNG(0)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        rec = self.dataset[i]
        return self.transform(rec, self.rng) if self.transform is not None else rec


class TrainLoader:
    """An endless stream of collated batches, pass after pass over
    ``batch_sampler``. ``dataset`` carries a ``DataRNG`` as ``.rng``; with
    no workers the main process reseeds it at each pass. With a pinned
    ``ring`` every batch leaves page-locked. ``first_stream`` (the rank
    times its workers) keeps two ranks' streams apart."""

    def __init__(self, dataset, batch_sampler, collator, num_workers: int = 0, seed: int = 42,
                 ring: Optional[CanvasRing] = None, first_stream: int = 0):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collator = collator
        self.num_workers = num_workers
        self.seed = seed
        self.ring = ring
        self.first_stream = first_stream
        self.epoch = 0  # passes started
        self.forks = 0  # times the workers were forked
        self._loader: Optional[DataLoader] = None
        self._it = None  # this pass's iterator
        self._workers = None  # the iterator whose persistent workers serve every pass
        self._produced = False
        self._dead = False

    def __iter__(self):
        return self

    def _start_pass(self):
        if self.num_workers == 0:
            self.dataset.rng.seed(stream_seed(self.seed, self.epoch, self.first_stream))
        if self._loader is None:
            self.forks += self.num_workers > 0
            self._loader = DataLoader(
                self.dataset, batch_sampler=self.batch_sampler, collate_fn=self.collator,
                num_workers=self.num_workers, persistent_workers=self.num_workers > 0,
                worker_init_fn=(functools.partial(seed_worker, self.seed, self.epoch, self.first_stream)
                                if self.num_workers else None),
            )
        self.epoch += 1
        self._produced = False
        self._workers = iter(self._loader)
        return self._workers

    def __next__(self):
        if self._dead:
            raise StopIteration
        while True:
            if self._it is None:
                self._it = self._start_pass()
            try:
                batch = next(self._it)
            except StopIteration:
                self._it = None
                if not self._produced:
                    self.close()
                    self._dead = True
                    raise RuntimeError("dataloader epoch produced no batches — is the dataset smaller than "
                                       "the global batch size (MODEL.BATCHSIZE x world size)?") from None
                continue
            except BaseException:
                self.close()
                self._dead = True
                raise
            self._produced = True
            return pin_batch(batch, self.ring) if self.ring is not None and self.ring.pin else batch

    def close(self) -> None:
        """Stop the workers now; a later batch starts a new pass with workers
        forked anew, which see the dataset as it is then."""
        workers, self._workers, self._it, self._loader = self._workers, None, None, None
        shutdown = getattr(workers, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()


def _seed(cfg) -> int:
    return cfg.get("SEED", 42)


def _train_loader(cfg, dataset, batch_sampler, collator, ring) -> TrainLoader:
    """The rank's loader over ``batch_sampler``'s global batches."""
    workers = cfg.DATA.get("NUM_WORKERS", 0)
    if world_size() > 1:
        check_group_buckets(collator.size_buckets)
    return TrainLoader(dataset, RankBatchSampler(batch_sampler, rank(), world_size()), collator,
                       num_workers=workers, seed=_seed(cfg), ring=ring, first_stream=rank() * max(1, workers))


def build_coco_train_loader(cfg, global_batch: int, ring: Optional[CanvasRing] = None,
                            with_mask: bool = False) -> TrainLoader:
    """COCO-format ``DATA.TRAIN.name`` → ``AUG.TRAIN_VALUE`` transforms →
    aspect-ratio grouped batches → pad collator (``DATA.SIZE_BUCKETS``; with
    ``with_mask``, DETR's valid-pixel mask too)."""
    images_dir, anno = resolve_dataset(cfg.DATA.TRAIN.name)
    dataset = COCODataset(images_dir, anno, remove_images_without_annotations=cfg.DATA.TRAIN.get(
        "remove_images_without_annotations", True))
    sampler = AspectRatioGroupSampler(dataset.aspect_ratios(), batch_size=global_batch, seed=_seed(cfg))
    collator = DetectionPadCollator(max_instances=cfg.DATA.get("MAX_INSTANCES", 100),
                                    size_buckets=cfg.DATA.get("SIZE_BUCKETS", None), ring=ring,
                                    with_mask=with_mask)
    return _train_loader(cfg, TransformedDataset(dataset, build_transforms(cfg.AUG.TRAIN_VALUE)), sampler,
                         collator, ring)


def build_yolox_train_loader(cfg, global_batch: int, ring: Optional[CanvasRing] = None) -> TrainLoader:
    """Mosaic and MixUp at the fixed ``AUG.TRAIN_SETTING.INPUT_SIZE``, shuffled
    epoch batches. The loader's ``mosaic_dataset`` is what YOLOX's no-aug
    switch turns off."""
    images_dir, anno = resolve_dataset(cfg.DATA.TRAIN.name)
    setting = cfg.AUG.TRAIN_SETTING
    mosaic = MosaicDataset(
        COCODataset(images_dir, anno, remove_images_without_annotations=True),
        img_size=tuple(setting.INPUT_SIZE), mosaic=True,
        preproc=TrainTransform(flip_prob=setting.get("FLIP_PROB", 0.5), hsv_prob=setting.get("HSV_PROB", 1.0)),
        degrees=setting.DEGREES, translate=setting.TRANSLATE, mosaic_scale=tuple(setting.MOSAIC_SCALE),
        mixup_scale=tuple(setting.MIXUP_SCALE), shear=setting.SHEAR, enable_mixup=setting.ENABLE_MIXUP,
        mosaic_prob=setting.MOSAIC_PROB, mixup_prob=setting.MIXUP_PROB,
    )
    loader = _train_loader(cfg, mosaic, ShuffledBatchSampler(len(mosaic), global_batch, seed=_seed(cfg)),
                           DetectionPadCollator(max_instances=cfg.DATA.get("MAX_INSTANCES", 100), ring=ring), ring)
    loader.mosaic_dataset = mosaic
    return loader


class TestLoader:
    """A finite eval loader in the main process, exposing ``.dataset`` for
    the evaluator. Its transform draws from a ``DataRNG`` reseeded at each
    pass, so every pass gives the same batches."""

    def __init__(self, dataset, transform, collator, batch_size: int = 1, rank: int = 0, world_size: int = 1,
                 seed: int = 0):
        self.dataset = dataset
        self.transform = transform
        self.collator = collator
        self.batch_size = batch_size
        self.sampler = InferenceSampler(len(dataset), rank, world_size)
        self.seed = seed
        self.rng = DataRNG(seed)

    def __iter__(self):
        self.rng.seed(self.seed)
        batch = []
        for i in self.sampler:
            rec = self.dataset[i]
            if self.transform is not None:
                rec = self.transform(rec, self.rng)
            batch.append(rec)
            if len(batch) == self.batch_size:
                yield self.collator(batch)
                batch = []
        if batch:
            yield self.collator(batch)

    def __len__(self):
        return (len(self.sampler) + self.batch_size - 1) // self.batch_size


def _default_test_buckets(min_size: int, max_size: int):
    """Pad buckets covering every ``ShortestEdgeResize`` output: one side at
    min_size (to x32) and the other up to max_size, either way round, then
    the square of max_size; the tightest first, as the collator picks the
    first that fits. The JAX package pads to the same buckets, so the two
    pad an image alike."""
    lo = (min_size + 31) // 32 * 32
    hi = (max_size + 31) // 32 * 32
    return [(lo, lo), (lo, hi), (hi, lo), (hi, hi)]


def build_coco_test_loader(cfg, dataset_name: Optional[str] = None, batch_size: int = 1,
                           ring: Optional[CanvasRing] = None) -> TestLoader:
    images_dir, anno = resolve_dataset(dataset_name or cfg.DATA.TEST.name)
    dataset = COCODataset(images_dir, anno, remove_images_without_annotations=False)
    transform = build_transforms((("ShortestEdgeResize", dict(
        min_size=cfg.TEST.IMG_MIN_SIZE, max_size=cfg.TEST.IMG_MAX_SIZE, sample_style="choice")),))
    buckets = cfg.DATA.get("TEST_SIZE_BUCKETS", None) or _default_test_buckets(cfg.TEST.IMG_MIN_SIZE,
                                                                                cfg.TEST.IMG_MAX_SIZE)
    collator = DetectionPadCollator(max_instances=cfg.DATA.get("MAX_INSTANCES", 100), size_buckets=buckets,
                                    ring=ring)
    return TestLoader(dataset, transform, collator, batch_size=batch_size, seed=_seed(cfg))
