"""Datasets and loaders (counterpart of ``endosr/data/__init__.py``).

:func:`create_dataset` maps the YAML ``mode`` to a dataset class;
:func:`create_dataloader` gives a ``torch.utils.data.DataLoader`` whose
batches come in the JAX ``ShardedLoader``'s order: the index space
``len(dataset) × dataset_enlarge_ratio`` permuted by
``numpy.random.default_rng(seed + epoch)``, padded so that every shard
holds as many indices, each rank's shard a rank-strided slice of it, the
last partial batch dropped, for training; batch 1 in file order for
validation and testing. Under ``opt["dist"]`` (``train.py`` under
``torchrun``) a rank's batch is ``batch_size // world`` and
``dataset_enlarge_ratio`` defaults to 200, as in JAX. Batches are dicts of
stacked CPU tensors (the path strings as lists);
:func:`prefetch_to_device` copies upcoming batches to the device while
the current step runs.

Worker processes are forked each epoch from a parent whose ``cache_data``
cache was filled once before the first fork, so they inherit it
copy-on-write; each reseeds the dataset's augmentation RNG with
``(seed + epoch) · 1000003 + worker id``, as the JAX workers do. A torch
loader hands batch i to worker i mod n, so a run's augmentation does not
depend on timing. Workers never touch CUDA.
"""

from __future__ import annotations

import collections
import logging
import random

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler, get_worker_info

__all__ = ["create_dataset", "create_dataloader", "EpochBatchSampler",
           "EpochLoader", "prefetch_to_device"]


# ``mode`` → dataset class of ``endosr_torch.data.datasets``
MODES = {"LQGTker_Depth": "LQGTKerDepthDataset",
         "EndoScene_Depth": "EndoSceneDepthDataset",
         "EndoScene_Depthnew": "EndoSceneDepthnewDataset",
         "LQGTker": "LQGTKerDataset", "LQ": "LQDataset",
         "LQker": "LQKerDataset", "SRker": "SRKerDataset",
         "LRHR_seg_bg": "LRHRSegBGDataset"}


def create_dataset(dataset_opt):
    from endosr_torch.data import datasets

    mode = dataset_opt["mode"]
    if mode not in MODES:
        raise NotImplementedError(f"Dataset [{mode}] is not recognized.")
    dataset = getattr(datasets, MODES[mode])(dataset_opt)
    logging.getLogger("base").info(
        "Dataset [%s - %s] is created.", dataset.__class__.__name__,
        dataset_opt.get("name"))
    return dataset


class EpochBatchSampler(Sampler):
    """Batches of dataset indices in ``ShardedLoader._indices()`` order for
    shard ``shard_index`` of ``num_shards``; :meth:`set_epoch` picks the
    epoch's permutation."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, ratio: int = 1, drop_last: bool = True,
                 num_shards: int = 1, shard_index: int = 0):
        self.n = n
        self.batch_size = max(1, batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.ratio = max(1, ratio)
        self.drop_last = drop_last
        self.num_shards = max(1, num_shards)
        self.shard_index = shard_index
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _per_shard(self) -> int:
        return -(-self.n * self.ratio // self.num_shards)

    def indices(self) -> np.ndarray:
        """This shard's dataset indices: the (permuted) index space padded
        with its own head to a multiple of the shard count, then every
        ``num_shards``-th from ``shard_index``."""
        total = self.n * self.ratio
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(total)
        else:
            idx = np.arange(total)
        padded = self._per_shard() * self.num_shards
        idx = np.concatenate([idx, idx[:padded - total]])
        return idx[self.shard_index::self.num_shards] % self.n

    def __len__(self):
        if self.drop_last:
            return self._per_shard() // self.batch_size
        return -(-self._per_shard() // self.batch_size)

    def __iter__(self):
        idx = self.indices().tolist()
        for i in range(len(self)):
            yield idx[i * self.batch_size:(i + 1) * self.batch_size]


def collate(items: list[dict]) -> dict:
    """Samples → one batch: arrays and numpy scalars stacked into CPU
    tensors, the rest (path strings) as lists."""
    out = {}
    for k, v0 in items[0].items():
        if isinstance(v0, (np.ndarray, np.generic)):
            out[k] = torch.from_numpy(np.stack([it[k] for it in items]))
        else:
            out[k] = [it[k] for it in items]
    return out


class _SeedWorker:
    """``worker_init_fn``: reseed the worker's copy of the dataset's
    augmentation RNG for the sampler's current epoch."""

    def __init__(self, sampler: EpochBatchSampler):
        self.sampler = sampler

    def __call__(self, wid: int) -> None:
        s = self.sampler
        get_worker_info().dataset.rng = random.Random(
            (s.seed + s.epoch) * 1000003 + wid)


class EpochLoader(DataLoader):
    """A ``DataLoader`` over an :class:`EpochBatchSampler`, with
    :meth:`set_epoch`; with workers, it fills the dataset's cache in this
    process before the first epoch's workers fork."""

    def set_epoch(self, epoch: int) -> None:
        self.batch_sampler.set_epoch(epoch)

    def __iter__(self):
        ds = self.dataset
        if (self.num_workers and getattr(ds, "_cache", None) is not None
                and not getattr(ds, "_cache_warmed", False)):
            prep = getattr(ds, "_prepared_train", None)
            for i in range(len(ds)):
                prep(i) if prep is not None else ds[i]
            ds._cache_warmed = True
        return super().__iter__()


def _shard() -> tuple[int, int]:
    """(shard count, this rank's shard) under a process group, else (1, 0)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def create_dataloader(dataset, dataset_opt, opt=None, pin_memory=False):
    """The loader of one dataset block: training batches of ``batch_size``
    (shuffled by ``use_shuffle`` with ``train.manual_seed``, the index
    space enlarged by ``dataset_enlarge_ratio``, ``n_workers`` processes;
    under ``opt["dist"]`` this rank's shard, ``batch_size // world`` a
    batch, the ratio 200 when unset); otherwise batch 1 in order, in this
    process. ``pin_memory``: pin the batches (the model runs on CUDA)."""
    if dataset_opt["phase"] == "train":
        dist_on = bool(opt and opt.get("dist"))
        shards, index = _shard() if dist_on else (1, 0)
        seed = 0
        if opt and opt.get("train") and opt["train"].get("manual_seed") is not None:
            seed = int(opt["train"]["manual_seed"])
        sampler = EpochBatchSampler(
            len(dataset), dataset_opt["batch_size"] // shards,
            shuffle=dataset_opt.get("use_shuffle", True), seed=seed,
            ratio=dataset_opt.get("dataset_enlarge_ratio",
                                  200 if dist_on else 1) or 1,
            drop_last=True, num_shards=shards, shard_index=index)
        workers = int(dataset_opt.get("n_workers") or 0)
        return EpochLoader(
            dataset, batch_sampler=sampler, num_workers=workers,
            collate_fn=collate, pin_memory=pin_memory,
            worker_init_fn=_SeedWorker(sampler) if workers else None,
            multiprocessing_context="fork" if workers else None)
    sampler = EpochBatchSampler(len(dataset), 1, shuffle=False, drop_last=False)
    return EpochLoader(dataset, batch_sampler=sampler, num_workers=0,
                       collate_fn=collate, pin_memory=pin_memory)


PREFETCH = 2        # batches on the device at once: the current and the next


def prefetch_to_device(iterator, device):
    """The batches of ``iterator`` on ``device``, one ahead: the tensors of
    the upcoming batch are copied (``non_blocking``, from the
    loader's pinned memory on CUDA) while the current step runs. Strings
    and lists ride along. A CPU ``device`` yields the batches as they
    are."""
    device = torch.device(device)

    def put(batch):
        if device.type == "cpu":
            return batch
        return {k: v.to(device, non_blocking=True) if torch.is_tensor(v)
                else v for k, v in batch.items()}

    buf = collections.deque()
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) == PREFETCH:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
