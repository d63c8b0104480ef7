"""Batched data loading (port of dskd_tpu/data/loader.py ``DataLoader``) on
``torch.utils.data.DataLoader``.

The index stream is JAX's, so the batches are the same:
  * train: a ``RandomState(seed + epoch)`` permutation, eval: the dataset
    order;
  * with ``aspect_buckets``, samples group by aspect (portrait h >= w ->
    bucket 0, landscape -> 1), each group is padded to a whole number of
    batches in training, and the batches are shuffled by
    ``RandomState(seed + epoch + 7)``;
  * each sample draws its augmentation from ``RandomState(base_seed + idx)``
    with ``base_seed = (seed + 1) * 1000003 + epoch * 97``: with Mosaic,
    first three ``randint(n)`` for its other images and then Mosaic's own
    draws; with MixUp, then the ``randint(n)`` of its image and MixUp's
    draws; then the pipeline's (flip, scale);
  * with ``gt_buckets``, each batch's GT pad is trimmed to the smallest
    bucket that covers its last valid GT slot;
  * a short last batch (eval) is padded with its last sample.

A batch sampler in the main process yields each batch's ``(index, seed,
mix)`` keys; the workers decode, mix (``mix_transforms``, where the
pipeline asks for Mosaic or MixUp and ``mix`` is on) and preprocess
(``pipeline.preprocess_sample``)
and collate into a ``data.batch.Batch`` of CPU tensors, which reach the
main process through shared memory, plus ``meta`` (``img_ids``,
``scale_factors``, ``ori_hw``). Workers start under the "spawn" context (a
forked child of a process that has initialised CUDA can hang), use one
thread each and persist across epochs; ``num_workers=0`` loads in the
calling process, with the same batches. ``pin_memory`` pins them for a copy
to the card.

``set_mix(False)`` turns Mosaic and MixUp off from the next epoch on (YOLOX's
no-aug phase), in running workers too, since the flag rides in the keys.

Not ported: the augmentations ``pipeline.check_ported`` names (they raise
NotImplementedError), and multi-host sharding.
"""
from __future__ import annotations

import dataclasses
import functools
import multiprocessing as mp
from typing import Iterator, List, Tuple

import numpy as np
import torch
import torch.utils.data as tud

from .batch import Batch
from .coco import TaskCocoDataset
from .mix_transforms import mixup, mosaic
from .pipeline import PipelineConfig, check_ported, load_image, \
    preprocess_sample

_STACKED = ("image", "img_hw", "gt_bboxes", "gt_labels", "gt_valid")


class _Samples(tud.Dataset):
    """Map-style view for the workers: ``(index, seed)`` -> one
    preprocessed sample with its ``img_id``."""

    def __init__(self, dataset, pipeline: PipelineConfig, train: bool,
                 aspect_buckets, flags):
        self.dataset = dataset
        self.pipeline = pipeline
        self.train = train
        self.aspect_buckets = aspect_buckets
        self.flags = flags

    def __len__(self):
        return len(self.dataset)

    def _raw(self, idx):
        path, _, boxes, labels, _ = self.dataset.get_raw(int(idx))
        return load_image(path), boxes, labels

    def __getitem__(self, key):
        idx, seed, mix = key
        path, _, boxes, labels, img_id = self.dataset.get_raw(int(idx))
        img = load_image(path)
        rng = np.random.RandomState(seed) if self.train else None
        pipe = self.pipeline
        if self.flags is not None:
            bucket = self.aspect_buckets[self.flags[int(idx)]]
            pipe = dataclasses.replace(pipe, bucket=bucket, img_scale=bucket)
        if rng is not None and mix and (pipe.mosaic or pipe.mixup):
            n = len(self.dataset)
            if pipe.mosaic:
                others = [self._raw(rng.randint(n)) for _ in range(3)]
                img, boxes, labels = mosaic(
                    [(img, boxes, labels)] + others, pipe.img_scale, rng,
                    center_ratio_range=pipe.mosaic_center_ratio)
            if pipe.mixup:
                r_img, r_boxes, r_labels = self._raw(rng.randint(n))
                img, boxes, labels = mixup(
                    img, boxes, labels, r_img, r_boxes, r_labels, rng,
                    dynamic_scale=pipe.img_scale,
                    ratio_range=pipe.mixup_ratio_range)
        out = preprocess_sample(img, boxes, labels, pipe, rng, self.train)
        out["img_id"] = img_id
        return out


def collate(samples: List[dict], batch_size: int,
            gt_buckets: Tuple[int, ...]):
    """Samples -> (Batch of CPU tensors, meta): pads a short batch with its
    last sample and trims the GT pad to ``gt_buckets``."""
    samples = list(samples)
    while len(samples) < batch_size:
        samples.append(samples[-1])
    stack = {k: np.stack([s[k] for s in samples]) for k in _STACKED}
    if gt_buckets:
        # the smallest bucket covering every valid GT slot of the batch
        cols = stack["gt_valid"].any(axis=0)
        need = int(cols.nonzero()[0].max()) + 1 if cols.any() else 1
        nb_gt = next((g for g in gt_buckets if g >= need),
                     stack["gt_valid"].shape[1])
        nb_gt = min(nb_gt, stack["gt_valid"].shape[1])
        for k in ("gt_bboxes", "gt_labels", "gt_valid"):
            stack[k] = stack[k][:, :nb_gt]
    batch = Batch(*(torch.from_numpy(np.ascontiguousarray(stack[k]))
                    for k in _STACKED))
    meta = dict(img_ids=[s["img_id"] for s in samples],
                scale_factors=np.stack([s["scale_factor"] for s in samples]),
                ori_hw=np.stack([s["ori_hw"] for s in samples]))
    return batch, meta


def _worker_init(_worker_id):
    torch.set_num_threads(1)


class _BatchKeys:
    """Batch sampler: each batch's ``(index, seed)`` pairs for the loader's
    current epoch, computed when an epoch's iteration starts."""

    def __init__(self, loader: "DataLoader"):
        self.loader = loader

    def __iter__(self):
        return iter(self.loader.batch_keys())

    def __len__(self):
        return len(self.loader.batch_keys())


class DataLoader:
    """``aspect_buckets``: optional (bucket_hw_portrait, bucket_hw_landscape)
    pair; each batch is homogeneous in its canvas."""

    def __init__(self, dataset: TaskCocoDataset, batch_size: int,
                 pipeline: PipelineConfig = None, train: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True, aspect_buckets=None,
                 gt_buckets=(), pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pipeline = pipeline or PipelineConfig()
        check_ported(self.pipeline)
        self.train = train
        self.seed = seed
        self.drop_last = drop_last
        self.aspect_buckets = aspect_buckets
        self.gt_buckets = tuple(sorted(gt_buckets))
        self.epoch = 0
        self.mix = True
        self._flags = None
        if aspect_buckets is not None:
            # flag 0 = portrait (h >= w), 1 = landscape
            hw = [dataset.get_raw(i)[1] for i in range(len(dataset))]
            self._flags = np.array([0 if h >= w else 1 for h, w in hw],
                                   np.int8)
        workers = dict(num_workers=num_workers)
        if num_workers > 0:
            workers.update(multiprocessing_context=mp.get_context("spawn"),
                           persistent_workers=True,
                           worker_init_fn=_worker_init)
        self._loader = tud.DataLoader(
            _Samples(dataset, self.pipeline, train, aspect_buckets,
                     self._flags),
            batch_sampler=_BatchKeys(self),
            collate_fn=functools.partial(collate, batch_size=batch_size,
                                         gt_buckets=self.gt_buckets),
            pin_memory=pin_memory, **workers)

    def __len__(self):
        """Batches per epoch before aspect grouping (JAX's count, which
        sets the schedule's epoch length)."""
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_mix(self, on: bool) -> None:
        """Mosaic and MixUp (where the pipeline asks for them) on or off
        for the epochs that start after the call."""
        self.mix = bool(on)

    def batch_keys(self) -> List[List[Tuple[int, int, bool]]]:
        """This epoch's batches as lists of (index, augmentation seed,
        mix)."""
        n = len(self.dataset)
        indices = (np.random.RandomState(self.seed + self.epoch).permutation(n)
                   if self.train else np.arange(n))
        if self._flags is not None:
            # GroupSampler semantics: group by aspect flag, pad each group
            # to a batch multiple, then shuffle whole batches
            flags = self._flags[indices]
            batches = []
            for g in (0, 1):
                gi = indices[flags == g]
                if len(gi) == 0:
                    continue
                if self.train:
                    pad = (-len(gi)) % self.batch_size
                    if pad:
                        gi = np.concatenate([gi, gi[:pad]])
                n_full = len(gi) // self.batch_size
                batches += [gi[i * self.batch_size:(i + 1) * self.batch_size]
                            for i in range(n_full)]
            if self.train:
                np.random.RandomState(self.seed + self.epoch + 7).shuffle(
                    batches)
            indices = (np.concatenate(batches) if batches
                       else indices[:0])
        bs = self.batch_size
        nb = len(indices) // bs if self.drop_last else -(-len(indices) // bs)
        base_seed = (self.seed + 1) * 1000003 + self.epoch * 97
        return [[(int(i), base_seed + int(i), self.mix)
                 for i in indices[b * bs:(b + 1) * bs]] for b in range(nb)]

    def __iter__(self) -> Iterator[Tuple[Batch, dict]]:
        yield from self._loader
        self.epoch += 1

    def infinite(self) -> Iterator[Tuple[Batch, dict]]:
        """Endless batch stream for iter-based schedules: each pass through
        ``__iter__`` reshuffles (the epoch advances per pass)."""
        while True:
            yield from iter(self)

    def close(self) -> None:
        """Stop the worker processes (they also stop with the process).
        torch keeps a persistent-worker iterator in the private
        ``_iterator``; a torch that renames it fails here, loudly, rather
        than leave the workers running."""
        it = self._loader._iterator
        if it is not None:
            it._shutdown_workers()
            self._loader._iterator = None
